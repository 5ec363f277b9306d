"""IA-OBU splitter and per-type payload parsers (host side).

Wire format follows AOM IAMF v1.0; parity checked against the reference
parser (IAMF_OBU.c): header split :79-138, sequence header :260-297,
codec config :303-351, audio element :391-607, mix presentation :641-932,
parameter block :990-1215, audio frame :1227-1254.
"""

from __future__ import annotations

from typing import Iterator, Optional

from ..constants import (
    AmbisonicsMode,
    AnimationType,
    ElementType,
    LayoutType,
    OBUType,
    ParameterType,
)
from .bitstream import BitReader
from . import objects as o

OBU_MIN_SIZE = 2

LOUDNESS_TRUE_PEAK = 1
LOUDNESS_ANCHORED = 2


class ParseError(ValueError):
    pass


def split_obu(data: bytes | memoryview, offset: int = 0) -> Optional[o.OBU]:
    """Split one OBU starting at `offset`. Returns None if a complete OBU is
    not available (caller should supply more bytes)."""
    view = memoryview(data)[offset:]
    if len(view) < OBU_MIN_SIZE:
        return None

    br = BitReader(bytes(view[:32]))  # header is tiny; trim bits come later
    obu_type = br.bits(5)
    redundant = bool(br.bits(1))
    trimming = bool(br.bits(1))
    extension = bool(br.bits(1))
    payload_size = br.leb128()
    header_len = br.tell()
    total = header_len + payload_size
    if total > len(view):
        return None

    # Re-read trim/extension fields from the true payload region.
    body = BitReader(bytes(view[header_len:total]))
    trim_start = trim_end = 0
    ext_header = b""
    if trimming:
        trim_end = body.leb128()
        trim_start = body.leb128()
    if extension:
        ext_size = body.leb128()
        ext_header = body.read_bytes(ext_size)
    payload = view[header_len + body.tell() : total]

    return o.OBU(
        type=obu_type,
        redundant=redundant,
        trimming=trimming,
        extension=extension,
        trim_start=trim_start,
        trim_end=trim_end,
        ext_header=ext_header,
        payload=payload,
        size=total,
    )


def iter_obus(data: bytes | memoryview) -> Iterator[o.OBU]:
    """Iterate over complete OBUs in a buffer; stops at a partial tail."""
    offset = 0
    n = len(data)
    while offset < n:
        obu = split_obu(data, offset)
        if obu is None:
            return
        yield obu
        offset += obu.size


def split_records(data: bytes | memoryview):
    """Split ALL complete OBUs in one native pass (native/src/obu_split.cc).

    Returns an int64 numpy array [n, 8]: (type, flags, obu_off, payload_off,
    payload_len, trim_start, trim_end, substream_id-or--1) per OBU — the
    same walk as iter_obus (reference wire format IAMF_OBU.c:79-138) at
    ~1000x the throughput; the batched decoder re-parses only descriptor /
    parameter OBUs into objects. Falls back to the Python iterator when
    the native library is unavailable.
    """
    import numpy as np

    buf = data if isinstance(data, (bytes, bytearray)) else bytes(data)
    lib = _native_split_lib()
    if lib is None:
        # fallback: rebuild records from the Python splitter
        recs = []
        offset = 0
        while True:
            obu = split_obu(buf, offset)
            if obu is None:
                break
            sid = -1
            if obu.is_audio_frame:
                f = parse_audio_frame(obu)
                sid = f.substream_id
                # payload offset of the frame data within `buf`
                base = offset + obu.size - len(obu.payload)
                poff = base + (len(obu.payload) - len(f.data))
                plen = len(f.data)
            else:
                poff = offset + obu.size - len(obu.payload)
                plen = len(obu.payload)
            recs.append((obu.type,
                         int(obu.redundant) | (int(obu.trimming) << 1)
                         | (int(obu.extension) << 2),
                         offset, poff, plen, obu.trim_start, obu.trim_end,
                         sid))
            offset += obu.size
        return np.asarray(recs, np.int64).reshape(-1, 8)

    import ctypes

    n = len(buf)
    max_out = max(n // OBU_MIN_SIZE + 1, 16)
    out = np.empty((max_out, 8), np.int64)
    got = lib.iamf_obu_split_all(
        buf, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_out)
    return out[:got].copy()


_SPLIT_LIB = [False, None]


def _native_split_lib():
    if _SPLIT_LIB[0]:
        return _SPLIT_LIB[1]
    _SPLIT_LIB[0] = True
    try:
        import ctypes
        import os

        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            "native", "lib", "libiamf_native.so")
        if not os.path.exists(path):
            import subprocess

            subprocess.run(["make", "-C", os.path.dirname(
                os.path.dirname(path))], check=True, capture_output=True)
        lib = ctypes.CDLL(path)
        lib.iamf_obu_split_all.restype = ctypes.c_int64
        lib.iamf_obu_split_all.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        _SPLIT_LIB[1] = lib
    except Exception:
        _SPLIT_LIB[1] = None
    return _SPLIT_LIB[1]


def find_sequence_header(data: bytes | memoryview) -> int:
    """Byte offset of the first sequence-header OBU (magic scan analogous to
    iamf_decoder_internal_init's search, IAMF_decoder.c:2752-2782), or -1."""
    buf = bytes(data)
    for i in range(len(buf) - 1):
        if (buf[i] >> 3) == OBUType.SEQUENCE_HEADER:
            obu = split_obu(buf, i)
            if obu is not None and bytes(obu.payload[:4]) == b"iamf":
                return i
    return -1


# ---------------------------------------------------------------------------
# Per-type payload parsers
# ---------------------------------------------------------------------------


def parse_sequence_header(obu: o.OBU) -> o.SequenceHeader:
    br = BitReader(bytes(obu.payload))
    code = br.read_bytes(4)
    primary = br.u8()
    additional = br.u8()
    if code != b"iamf":
        raise ParseError(f"bad IA sequence header magic {code!r}")
    return o.SequenceHeader(
        iamf_code=code,
        primary_profile=primary,
        additional_profile=additional,
        redundant=obu.redundant,
    )


def parse_codec_config(obu: o.OBU) -> o.CodecConfig:
    br = BitReader(bytes(obu.payload))
    conf_id = br.leb128()
    codec_4cc = br.read_bytes(4)
    nb_samples = br.leb128()
    roll = br.s16()
    decoder_conf = br.read_bytes(len(br.data) - br.tell())
    return o.CodecConfig(
        codec_conf_id=conf_id,
        codec_4cc=codec_4cc,
        nb_samples_per_frame=nb_samples,
        roll_distance=roll,
        decoder_conf=decoder_conf,
        redundant=obu.redundant,
    )


def _parse_parameter_base(br: BitReader, ptype: int) -> o.ParameterBase:
    """Common param_definition (IAMF_OBU.c:358-389)."""
    pid = br.leb128()
    rate = br.leb128()
    mode = br.bits(1)
    duration = 0
    const_interval = 0
    nb_segments = 0
    intervals: tuple[int, ...] = ()
    if not mode:
        duration = br.leb128()
        const_interval = br.leb128()
        if not const_interval:
            nb_segments = br.leb128()
            intervals = tuple(br.leb128() for _ in range(nb_segments))
        else:
            nb_segments = (duration + const_interval - 1) // const_interval
    return o.ParameterBase(
        type=ptype,
        id=pid,
        rate=rate,
        mode=mode,
        duration=duration,
        constant_segment_interval=const_interval,
        nb_segments=nb_segments,
        segment_intervals=intervals,
    )


def parse_audio_element(obu: o.OBU) -> o.AudioElement:
    br = BitReader(bytes(obu.payload))
    element_id = br.leb128()
    element_type = br.bits(3)
    br.skip_bits(5)
    codec_config_id = br.leb128()

    nb_substreams = br.leb128()
    substream_ids = tuple(br.leb128() for _ in range(nb_substreams))

    nb_parameters = br.leb128()
    params = []
    for _ in range(nb_parameters):
        ptype = br.leb128()
        if ptype == ParameterType.DEMIXING:
            pb = _parse_parameter_base(br, ptype)
            # Spec: 7 reserved bits follow param_definition_mode; the
            # reference skips them implicitly via its next aligned read
            # (valid demix definitions have mode=0, making the two equal).
            br.align()
            pb.default_mode = br.bits(3)
            br.skip_bits(5)
            pb.default_w = br.bits(4)
            br.skip_bits(4)
            params.append(pb)
        elif ptype == ParameterType.RECON_GAIN:
            params.append(_parse_parameter_base(br, ptype))
        else:
            # Unknown parameter definition types carry an explicit size.
            size = br.leb128()
            br.skip_bytes(size)

    channels_config = None
    ambisonics_config = None
    if element_type == ElementType.CHANNEL_BASED:
        nb_layers = br.bits(3)
        br.skip_bits(5)
        layers = []
        for _ in range(nb_layers):
            layout = br.bits(4)
            og_flag = bool(br.bits(1))
            rg_flag = bool(br.bits(1))
            br.skip_bits(2)
            nb_sub = br.u8()
            nb_coupled = br.u8()
            og = None
            if og_flag:
                flags = br.bits(6)
                br.skip_bits(2)
                gain = br.s16()
                og = o.OutputGain(flags=flags, gain_q78=gain)
            layers.append(
                o.ChannelLayerConfig(
                    loudspeaker_layout=layout,
                    output_gain_flag=og_flag,
                    recon_gain_flag=rg_flag,
                    nb_substreams=nb_sub,
                    nb_coupled_substreams=nb_coupled,
                    output_gain=og,
                )
            )
        channels_config = o.ScalableChannelConfig(
            nb_layers=nb_layers, layers=tuple(layers)
        )
    elif element_type == ElementType.SCENE_BASED:
        mode = br.leb128()
        if mode == AmbisonicsMode.MONO:
            out_ch = br.u8()
            sub_cnt = br.u8()
            mapping = br.read_bytes(out_ch)
            ambisonics_config = o.AmbisonicsConfig(
                mode=mode,
                output_channel_count=out_ch,
                substream_count=sub_cnt,
                coupled_substream_count=0,
                mapping=mapping,
            )
        elif mode == AmbisonicsMode.PROJECTION:
            out_ch = br.u8()
            sub_cnt = br.u8()
            coupled = br.u8()
            mapping = br.read_bytes(2 * out_ch * (sub_cnt + coupled))
            ambisonics_config = o.AmbisonicsConfig(
                mode=mode,
                output_channel_count=out_ch,
                substream_count=sub_cnt,
                coupled_substream_count=coupled,
                mapping=mapping,
            )
        else:
            raise ParseError(f"invalid ambisonics mode {mode}")
    else:
        size = br.leb128()
        br.skip_bytes(size)

    return o.AudioElement(
        element_id=element_id,
        element_type=element_type,
        codec_config_id=codec_config_id,
        substream_ids=substream_ids,
        parameters=tuple(params),
        channels_config=channels_config,
        ambisonics_config=ambisonics_config,
        redundant=obu.redundant,
    )


def _parse_loudness(br: BitReader) -> o.LoudnessInfo:
    info_type = br.u8()
    integrated = br.s16()
    peak = br.s16()
    true_peak = 0
    anchors: list[o.AnchorLoudness] = []
    if info_type & LOUDNESS_TRUE_PEAK:
        true_peak = br.s16()
    if info_type & LOUDNESS_ANCHORED:
        n = br.u8()
        for _ in range(n):
            elem = br.u8()
            loud = br.s16()
            anchors.append(o.AnchorLoudness(anchor_element=elem, anchored_loudness=loud))
    if info_type & ~(LOUDNESS_TRUE_PEAK | LOUDNESS_ANCHORED):
        size = br.leb128()
        br.skip_bytes(size)
    return o.LoudnessInfo(
        info_type=info_type,
        integrated_loudness=integrated,
        digital_peak=peak,
        true_peak=true_peak,
        anchors=tuple(anchors),
    )


def parse_mix_presentation(obu: o.OBU) -> o.MixPresentation:
    br = BitReader(bytes(obu.payload))
    mix_id = br.leb128()
    num_labels = br.leb128()
    languages = tuple(br.read_string() for _ in range(num_labels))
    labels = tuple(br.read_string() for _ in range(num_labels))
    num_sub_mixes = br.leb128()
    if num_sub_mixes != 1:
        # The reference only supports exactly one sub mix (IAMF_OBU.c:700-720).
        raise ParseError(f"unsupported num_sub_mixes {num_sub_mixes}")

    sub_mixes = []
    for _ in range(num_sub_mixes):
        nb_elements = br.leb128()
        if not (1 <= nb_elements <= 2):
            raise ParseError(f"unsupported num_audio_elements {nb_elements}")
        elems = []
        for _ in range(nb_elements):
            eid = br.leb128()
            elabels = tuple(br.read_string() for _ in range(num_labels))
            hrm = br.bits(2)
            ext_size = br.leb128()
            ext = br.read_bytes(ext_size)
            base = _parse_parameter_base(br, ParameterType.MIX_GAIN)
            default_gain = br.s16()
            elems.append(
                o.ElementMixRenderConfig(
                    element_id=eid,
                    labels=elabels,
                    headphones_rendering_mode=hrm,
                    rendering_config_extension=ext,
                    element_mix_gain=o.MixGain(base=base, default_mix_gain_q78=default_gain),
                )
            )

        out_base = _parse_parameter_base(br, ParameterType.MIX_GAIN)
        out_gain = br.s16()
        output_mix_gain = o.MixGain(base=out_base, default_mix_gain_q78=out_gain)

        num_layouts = br.leb128()
        layouts = []
        louds = []
        for _ in range(num_layouts):
            ltype = br.bits(2)
            if ltype == LayoutType.SS_CONVENTION:
                ss = br.bits(4)
                layouts.append(o.Layout(type=ltype, sound_system=ss))
            else:
                layouts.append(o.Layout(type=ltype))
            br.align()
            louds.append(_parse_loudness(br))

        sub_mixes.append(
            o.SubMix(
                elements=tuple(elems),
                output_mix_gain=output_mix_gain,
                layouts=tuple(layouts),
                loudness=tuple(louds),
            )
        )

    return o.MixPresentation(
        mix_presentation_id=mix_id,
        num_labels=num_labels,
        languages=languages,
        labels=labels,
        sub_mixes=tuple(sub_mixes),
        redundant=obu.redundant,
    )


def peek_parameter_block_id(obu: o.OBU) -> int:
    br = BitReader(bytes(obu.payload[:16]))
    return br.leb128()


def _segment_interval(total_left: int, const_interval: int, interval: int) -> int:
    if interval:
        return interval
    return min(const_interval, total_left)


def parse_parameter_block(
    obu: o.OBU,
    definition: o.ParameterBase,
    nb_layers: int = 0,
    recon_gain_present_flags: int = 0,
) -> o.ParameterBlock:
    """Parse a parameter block; needs its definition (from the audio element /
    mix presentation) for mode-0 timing and recon-gain layer layout."""
    br = BitReader(bytes(obu.payload))
    pid = br.leb128()

    if not definition.mode:
        duration = definition.duration
        nb_segments = definition.nb_segments
        const_interval = definition.constant_segment_interval
    else:
        duration = br.leb128()
        const_interval = br.leb128()
        if not const_interval:
            nb_segments = br.leb128()
        else:
            nb_segments = (duration + const_interval - 1) // const_interval

    ptype = definition.type
    segments: list[object] = []
    intervals_left = duration
    for i in range(nb_segments):
        interval = 0
        if not const_interval:
            if not definition.mode:
                interval = definition.segment_intervals[i]
            else:
                interval = br.leb128()
        seg_interval = _segment_interval(intervals_left, const_interval, interval)
        intervals_left -= seg_interval

        if ptype == ParameterType.MIX_GAIN:
            anim = br.leb128()
            start = br.s16()
            end = control = 0
            crt = 0
            if anim != AnimationType.STEP:
                end = br.s16()
                if anim == AnimationType.BEZIER:
                    control = br.s16()
                    crt = br.u8()
            segments.append(
                o.MixGainSegment(
                    segment_interval=seg_interval,
                    animation_type=anim,
                    start_q78=start,
                    end_q78=end,
                    control_q78=control,
                    control_relative_time_q08=crt,
                )
            )
        elif ptype == ParameterType.DEMIXING:
            mode = br.bits(3)
            segments.append(
                o.DemixingSegment(segment_interval=seg_interval, demixing_mode=mode)
            )
        elif ptype == ParameterType.RECON_GAIN:
            entries: list[Optional[o.ReconGainEntry]] = []
            for k in range(nb_layers):
                if not (recon_gain_present_flags >> k) & 1:
                    entries.append(None)
                    continue
                flags = br.leb128()
                nch = bin(flags).count("1")
                gains = tuple(br.u8() for _ in range(nch))
                entries.append(o.ReconGainEntry(flags=flags, gains_q08=gains))
            segments.append(
                o.ReconGainSegment(
                    segment_interval=seg_interval, entries=tuple(entries)
                )
            )
        else:
            size = br.leb128()
            br.skip_bytes(size)

    return o.ParameterBlock(
        id=pid,
        duration=duration,
        nb_segments=nb_segments,
        constant_segment_interval=const_interval,
        type=ptype,
        segments=tuple(segments),
    )


def parse_audio_frame(obu: o.OBU) -> o.AudioFrame:
    if obu.type == OBUType.AUDIO_FRAME:
        br = BitReader(bytes(obu.payload[:16]))
        sid = br.leb128()
        data = obu.payload[br.tell() :]
    else:
        sid = obu.type - OBUType.AUDIO_FRAME_ID0
        data = obu.payload
    return o.AudioFrame(
        substream_id=sid,
        trim_start=obu.trim_start,
        trim_end=obu.trim_end,
        data=data,
    )
