"""Stream builders for the smoke run and the port's tests: complete IAMF
streams made with this package's muxer (tools/builder.py).

The PCM builders and the MP4/fMP4 wrappers (split_into_units, build_mp4,
build_fmp4, on this package's tools/mp4builder.py) are copies of the
functions of the same names in tests/vectors.py, on this package's builder
and constants: the same arguments give byte-identical streams
(tests/test_torch_standalone.py and tests/test_torch_mp4.py hold them to
it).

The AAC-LC and FLAC builders write their codec frames by hand, since no
encoder for either ships with the repo: AAC-LC raw data blocks (ISO/IEC
14496-3 4.4.2) with codebook-11 spectra in all four window sequences and
both window shapes, and FLAC frames of VERBATIM subframes (RFC 9639 §9).
"""

from __future__ import annotations

import functools
import os
import re
import struct

import numpy as np

from ..constants import (
    LAYOUT_CHANNELS_CODEC, ChannelLayout, ElementType, ParameterType,
)
from ..obu import parser
from . import builder, mp4builder


def sine_pcm(n: int, channels: int, rate: int = 48000, amp: float = 0.5,
             freqs=None, bits: int = 16, seed: int = 0) -> np.ndarray:
    """Deterministic multitone int PCM [n, channels]."""
    if freqs is None:
        freqs = [220.0 * (k + 1) for k in range(channels)]
    t = np.arange(n) / rate
    rng = np.random.RandomState(seed)
    out = np.zeros((n, channels))
    for c in range(channels):
        phase = rng.uniform(0, 2 * np.pi)
        out[:, c] = amp * np.sin(2 * np.pi * freqs[c] * t + phase)
        out[:, c] += 0.1 * amp * np.sin(2 * np.pi * 3.1 * freqs[c] * t)
    scale = 2.0 ** (bits - 1) - 1
    return np.round(out * scale).astype(np.int64)


def isp_tone_pcm(n_frames: int, nch: int) -> np.ndarray:
    """Int PCM [n_frames * 960, nch] (build_pcm_layout_stream's frames)
    whose true peaks pass the limiter's -1 dBTP threshold while its sample
    peaks stay below it: a multitone bed at 0.2 FS with an fs/4 tone at 45
    degrees (samples at 0.707 of its crest, the isp_tone of
    tests/test_limiter_truepeak.py) at 0.8 and 0.6 on the first two
    channels."""
    t = np.arange(n_frames * 960)
    tone = 0.985 * np.sin(2 * np.pi * t / 4 + np.pi / 4)
    pcm = sine_pcm(len(t), nch, amp=0.2, seed=3)
    pcm[:, 0] += np.round(0.8 * 32767 * tone).astype(np.int64)
    pcm[:, 1] += np.round(0.6 * 32767 * tone).astype(np.int64)
    return np.clip(pcm, -32768, 32767)


def _layer_substreams(layout: int) -> tuple[int, int]:
    """(nb_substreams, nb_coupled) for a single-layer channel config."""
    n = len(LAYOUT_CHANNELS_CODEC[ChannelLayout(layout)])
    if n == 1:
        return 1, 0
    if n == 2:
        return 1, 1
    coupled = (n - 2) // 2
    return coupled + 2, coupled


def build_pcm_layout_stream(
    layout: int,
    n_frames: int = 8,
    frame_size: int = 960,
    sample_size: int = 16,
    rate: int = 48000,
    amp: float = 0.5,
    demix_mode: int = 0,
    seed: int = 1,
    pcm_override: np.ndarray | None = None,
    demix_modes=None,  # per-frame demixing_mode values (param blocks)
    mix_gain_segments=None,  # per-frame element mix-gain segment dicts
    out_gain_segments=None,  # per-frame output mix-gain segment dicts
    hrm: int = 0,  # headphones_rendering_mode (1 => HRTF conv binaural)
    layout_specs=None,  # override the sub-mix LayoutSpec list
) -> tuple[bytes, np.ndarray]:
    """Single-layer channel-based ipcm stream for any IA layout.

    Gain segment dicts follow builder.parameter_block_obu's mix-gain form:
    {"animation": AnimationType, "start": q78, "end": q78, ...}.
    Returns (stream, source PCM [n, nch] in codec channel order).
    """
    nch = len(LAYOUT_CHANNELS_CODEC[ChannelLayout(layout)])
    nsub, ncoupled = _layer_substreams(layout)
    total = n_frames * frame_size
    if pcm_override is not None:
        pcm = np.asarray(pcm_override)[:total]
    else:
        pcm = sine_pcm(total, nch, rate, amp=amp, bits=sample_size, seed=seed)

    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(
        1, b"ipcm", frame_size, 0, builder.pcm_decoder_conf(sample_size, rate)
    )
    demix = None
    if nch > 2:
        demix = builder.ParamDefinition(
            id=998, rate=rate, mode=0, duration=frame_size,
            constant_segment_interval=frame_size,
        )
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1,
        substream_ids=list(range(nsub)),
        layers=[builder.LayerSpec(layout, nsub, ncoupled)],
        demix_param=demix,
        default_demix_mode=demix_mode,
        default_demix_w=0,
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1, mix_gain_param=builder.ParamDefinition(id=100),
                headphones_rendering_mode=hrm,
            )
        ],
        layouts=(layout_specs if layout_specs is not None
                 else [builder.LayoutSpec(sound_system=0),
                       builder.LayoutSpec(sound_system=1)]),
    )
    for f in range(n_frames):
        if demix_modes is not None and demix is not None:
            out += builder.parameter_block_obu(
                998, ParameterType.DEMIXING, duration=frame_size,
                constant_segment_interval=frame_size, mode=0,
                segments=[{"mode": demix_modes[f % len(demix_modes)]}],
            )
        if mix_gain_segments is not None:
            out += builder.parameter_block_obu(
                100, ParameterType.MIX_GAIN, duration=frame_size,
                constant_segment_interval=frame_size, mode=1,
                segments=[mix_gain_segments[f % len(mix_gain_segments)]],
            )
        if out_gain_segments is not None:
            out += builder.parameter_block_obu(
                999, ParameterType.MIX_GAIN, duration=frame_size,
                constant_segment_interval=frame_size, mode=1,
                segments=[out_gain_segments[f % len(out_gain_segments)]],
            )
        frame = pcm[f * frame_size : (f + 1) * frame_size]
        ch = 0
        for s in range(ncoupled):
            out += builder.audio_frame_obu(
                s, builder.pack_pcm_frame(frame[:, ch : ch + 2], sample_size)
            )
            ch += 2
        for s in range(ncoupled, nsub):
            out += builder.audio_frame_obu(
                s, builder.pack_pcm_frame(frame[:, ch : ch + 1], sample_size)
            )
            ch += 1
    return bytes(out), pcm


def build_pcm_51_stream(n_frames: int = 8, amp: float = 0.5, **kw):
    return build_pcm_layout_stream(
        ChannelLayout.L510, n_frames=n_frames, amp=amp, **kw
    )


def build_scalable_pcm_stream(
    n_frames: int = 8,
    frame_size: int = 960,
    sample_size: int = 16,
    rate: int = 48000,
    amp: float = 0.4,
    demix_modes=None,  # per-frame demixing_mode sequence (param blocks)
    recon_gains=None,  # per-frame (g_ls, g_rs) Q0.8 recon gains, or None
    default_demix_mode: int = 1,
    default_demix_w: int = 0,
    target_layouts=(1, 0),
    seed: int = 7,
    hrm: int = 0,  # headphones_rendering_mode (1 => HRTF conv binaural)
    layer2_output_gain=None,  # (flags 6-bit, gain q7.8) on the 5.1 layer
) -> tuple[bytes, np.ndarray]:
    """Two-layer scalable channel stream: stereo layer + 5.1 layer.

    Layer 1: 1 coupled substream (L2,R2). Layer 2 adds 3 substreams
    (coupled L5/R5 + mono C + mono LFE); SL5/SR5 are demixed by the decoder
    via the S3->5 chain, exercising demix modes, the w-index walk, and
    recon-gain RMS smoothing.
    """
    nch = 6  # L2 R2 L5 R5 C LFE (codec order)
    total = n_frames * frame_size
    pcm = sine_pcm(total, nch, rate, amp=amp, bits=sample_size, seed=seed)

    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(
        1, b"ipcm", frame_size, 0, builder.pcm_decoder_conf(sample_size, rate)
    )
    demix = builder.ParamDefinition(
        id=998, rate=rate, mode=0, duration=frame_size,
        constant_segment_interval=frame_size,
    )
    recon = builder.ParamDefinition(
        id=997, rate=rate, mode=0, duration=frame_size,
        constant_segment_interval=frame_size,
    )
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1,
        substream_ids=[0, 1, 2, 3],
        layers=[
            builder.LayerSpec(ChannelLayout.STEREO, 1, 1),
            builder.LayerSpec(
                ChannelLayout.L510, 3, 1, recon_gain_flag=True,
                **(dict(output_gain_flags=layer2_output_gain[0],
                        output_gain_q78=layer2_output_gain[1])
                   if layer2_output_gain else {}),
            ),
        ],
        demix_param=demix,
        recon_param=recon if recon_gains is not None else None,
        default_demix_mode=default_demix_mode,
        default_demix_w=default_demix_w,
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1, mix_gain_param=builder.ParamDefinition(id=100),
                headphones_rendering_mode=hrm,
            )
        ],
        layouts=[builder.LayoutSpec(sound_system=ss) for ss in target_layouts],
    )
    for f in range(n_frames):
        if demix_modes is not None:
            out += builder.parameter_block_obu(
                998, ParameterType.DEMIXING, duration=frame_size,
                constant_segment_interval=frame_size, mode=0,
                segments=[{"mode": demix_modes[f % len(demix_modes)]}],
            )
        if recon_gains is not None:
            g = recon_gains[f % len(recon_gains)]
            # flags: RE_LS|RE_RS (bits 3,4); layer 1 (bit 1) present
            out += builder.parameter_block_obu(
                997, ParameterType.RECON_GAIN, duration=frame_size,
                constant_segment_interval=frame_size, mode=0,
                segments=[{"entries": [None, (0b11000, list(g))]}],
            )
        frame = pcm[f * frame_size : (f + 1) * frame_size]
        out += builder.audio_frame_obu(
            0, builder.pack_pcm_frame(frame[:, 0:2], sample_size)
        )
        out += builder.audio_frame_obu(
            1, builder.pack_pcm_frame(frame[:, 2:4], sample_size)
        )
        out += builder.audio_frame_obu(
            2, builder.pack_pcm_frame(frame[:, 4:5], sample_size)
        )
        out += builder.audio_frame_obu(
            3, builder.pack_pcm_frame(frame[:, 5:6], sample_size)
        )
    return bytes(out), pcm


def build_ambisonics_pcm_stream(
    order: int = 1,
    n_frames: int = 8,
    frame_size: int = 960,
    sample_size: int = 16,
    rate: int = 48000,
    amp: float = 0.4,
    projection: bool = False,
    seed: int = 11,
    target_layouts=(1, 0),
    hrm: int = 0,  # headphones_rendering_mode (1 => HRTF conv binaural)
) -> tuple[bytes, np.ndarray]:
    """Scene-based (ambisonics) ipcm stream: FOA/SOA/TOA ACN channels as
    mono substreams (mode=MONO) or coupled+mono with a Q15 demix matrix
    (mode=PROJECTION)."""
    nch = (order + 1) ** 2
    total = n_frames * frame_size

    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(
        1, b"ipcm", frame_size, 0, builder.pcm_decoder_conf(sample_size, rate)
    )
    if not projection:
        amb = {
            "mode": 0,
            "output_channel_count": nch,
            "substream_count": nch,
            "mapping": list(range(nch)),
        }
        nsub, ncoupled = nch, 0
        stream_ch = nch
    else:
        # projection: Q15 matrix [stream channels, ambisonics channels];
        # coupled substreams carry 2 channels each
        ncoupled = nch // 2
        nsub = nch - ncoupled
        stream_ch = nsub + ncoupled
        mat = np.zeros((stream_ch, nch), dtype=np.int64)
        for i in range(min(stream_ch, nch)):
            mat[i, i] = 16384  # 0.5 in Q15
        amb = {
            "mode": 1,
            "output_channel_count": nch,
            "substream_count": nsub,
            "coupled_substream_count": ncoupled,
            "mapping": mat.astype(">i2").tobytes(),
        }
    pcm = sine_pcm(total, stream_ch, rate, amp=amp, bits=sample_size, seed=seed)
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.SCENE_BASED,
        codec_config_id=1,
        substream_ids=list(range(nsub)),
        ambisonics=amb,
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1, mix_gain_param=builder.ParamDefinition(id=100),
                headphones_rendering_mode=hrm,
            )
        ],
        layouts=[builder.LayoutSpec(sound_system=ss) for ss in target_layouts],
    )
    for f in range(n_frames):
        frame = pcm[f * frame_size : (f + 1) * frame_size]
        ch = 0
        for s in range(ncoupled):
            out += builder.audio_frame_obu(
                s, builder.pack_pcm_frame(frame[:, ch : ch + 2], sample_size)
            )
            ch += 2
        for s in range(ncoupled, nsub):
            out += builder.audio_frame_obu(
                s, builder.pack_pcm_frame(frame[:, ch : ch + 1], sample_size)
            )
            ch += 1
    return bytes(out), pcm


def build_two_element_stream(
    n_frames: int = 8,
    frame_size: int = 960,
    sample_size: int = 16,
    rate: int = 48000,
    gain1_q78: int = 0,
    gain2_q78: int = 0,
    target_layouts=(0, 1),
    hrm: int = 0,  # headphones_rendering_mode for BOTH elements
) -> tuple[bytes, np.ndarray, np.ndarray]:
    """Base-profile mix: stereo channel element + FOA ambisonics element in
    one sub mix (the reference mixer path, IAMF_decoder.c:2702-2733)."""
    total = n_frames * frame_size
    pcm1 = sine_pcm(total, 2, rate, amp=0.3, bits=sample_size, seed=2)
    pcm2 = sine_pcm(total, 4, rate, amp=0.25, bits=sample_size, seed=9)

    out = bytearray()
    out += builder.sequence_header_obu(primary_profile=1, additional_profile=1)
    out += builder.codec_config_obu(
        1, b"ipcm", frame_size, 0, builder.pcm_decoder_conf(sample_size, rate)
    )
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1,
        substream_ids=[0],
        layers=[builder.LayerSpec(ChannelLayout.STEREO, 1, 1)],
    )
    out += builder.audio_element_obu(
        element_id=2,
        element_type=ElementType.SCENE_BASED,
        codec_config_id=1,
        substream_ids=[1, 2, 3, 4],
        ambisonics={
            "mode": 0,
            "output_channel_count": 4,
            "substream_count": 4,
            "mapping": [0, 1, 2, 3],
        },
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1,
                mix_gain_param=builder.ParamDefinition(id=100),
                default_mix_gain_q78=gain1_q78,
                headphones_rendering_mode=hrm,
            ),
            builder.MixElementSpec(
                element_id=2,
                mix_gain_param=builder.ParamDefinition(id=101),
                default_mix_gain_q78=gain2_q78,
                headphones_rendering_mode=hrm,
            ),
        ],
        layouts=[builder.LayoutSpec(sound_system=ss) for ss in target_layouts],
    )
    for f in range(n_frames):
        fr1 = pcm1[f * frame_size : (f + 1) * frame_size]
        fr2 = pcm2[f * frame_size : (f + 1) * frame_size]
        out += builder.audio_frame_obu(
            0, builder.pack_pcm_frame(fr1, sample_size)
        )
        for s in range(4):
            out += builder.audio_frame_obu(
                1 + s, builder.pack_pcm_frame(fr2[:, s : s + 1], sample_size)
            )
    return bytes(out), pcm1, pcm2


# --- AAC-LC raw data blocks ----------------------------------------------

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3
AAC_SR_INDEX = 3  # 48 kHz
_AAC_TABLES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "src", "aac", "aac_tables.cc")


@functools.lru_cache(maxsize=None)
def aac_tables() -> dict:
    """The Huffman and band tables the native AAC decoder reads, from
    native/src/aac/aac_tables.cc: codebook 11 and the scalefactor code
    (codewords and lengths), the band counts and offsets at 48 kHz."""
    src = open(_AAC_TABLES).read()
    out = {}
    for name in ("kBook11Codes", "kBook11Lens", "kScfCodes", "kScfLens",
                 "kSfbOffLong", "kSfbOffShort", "kSfbNumLong",
                 "kSfbNumShort"):
        body = re.search(rf"{name}\[[^]]+\] = \{{([^}}]*)\}}", src).group(1)
        out[name] = [int(v) for v in body.split(",") if v.strip()]
    i = AAC_SR_INDEX
    out["num_long"] = out["kSfbNumLong"][i]
    out["num_short"] = out["kSfbNumShort"][i]
    out["off_long"] = out["kSfbOffLong"][52 * i:52 * i + out["num_long"] + 1]
    out["off_short"] = out["kSfbOffShort"][16 * i:
                                           16 * i + out["num_short"] + 1]
    return out


def aac_ics(w, rng, tab, seq: int = ONLY_LONG, shape: int | None = None,
            max_sfb: int = 20, global_gain: int = 140) -> None:
    """One individual_channel_stream at 48 kHz (ISO/IEC 14496-3 4.4.2.7)
    into BitWriter w: one codebook-11 section per window group over max_sfb
    bands (capped at the sequence's band count), scalefactors stepping by
    -3..3 within 12 of global_gain, random pairs below the escape with
    their sign bits. EIGHT_SHORT draws its 7 scale_factor_grouping bits."""
    short = seq == EIGHT_SHORT
    if shape is None:
        shape = rng.randint(2)
    w.bits(global_gain, 8)
    w.bits(0, 1), w.bits(seq, 2), w.bits(shape, 1)
    if short:
        max_sfb = min(max_sfb, tab["num_short"])
        grouping = rng.randint(128)
        w.bits(max_sfb, 4), w.bits(grouping, 7)
        groups = [1]
        for k in range(1, 8):  # bit 7 - k: window k joins the group before
            if grouping >> (7 - k) & 1:
                groups[-1] += 1
            else:
                groups.append(1)
        off, sect_bits = tab["off_short"], 3
    else:
        max_sfb = min(max_sfb, tab["num_long"])
        w.bits(max_sfb, 6), w.bits(0, 1)          # no predictor
        groups, off, sect_bits = [1], tab["off_long"], 5
    esc = (1 << sect_bits) - 1
    for _ in groups:                              # section_data
        w.bits(11, 4)
        n = max_sfb
        while n >= esc:
            w.bits(esc, sect_bits)
            n -= esc
        w.bits(n, sect_bits)
    sf = global_gain
    for _ in groups:                              # scale_factor_data
        for _ in range(max_sfb):
            d = int(rng.randint(-3, 4))
            if abs(sf + d - global_gain) > 12:
                d = -d
            sf += d
            w.bits(tab["kScfCodes"][d + 60], tab["kScfLens"][d + 60])
    w.bits(0, 3)                                  # no pulse, TNS, SSR
    for glen in groups:                           # spectral_data
        for _ in range((off[max_sfb] * glen) // 2):
            pair = rng.randint(0, 16, 2) * (rng.rand(2) < 0.6)
            i = pair[0] * 17 + pair[1]
            w.bits(tab["kBook11Codes"][i], tab["kBook11Lens"][i])
            for v in pair:
                if v:
                    w.bits(rng.randint(2), 1)


def aac_block(rng, tab, nch: int, seq: int = ONLY_LONG,
              shape: int | None = None, **ics) -> bytes:
    """A raw_data_block of one SCE (nch 1) or one CPE without a common
    window (nch 2), then END; every channel in window sequence `seq`."""
    w = builder.BitWriter()
    w.bits(nch - 1, 3), w.bits(0, 4)              # SCE / CPE, tag 0
    if nch == 2:
        w.bits(0, 1)
    for _ in range(nch):
        aac_ics(w, rng, tab, seq, shape, **ics)
    w.bits(7, 3)
    return w.bytes()


def aac_window_schedule(n_frames: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """(window_sequence, window_shape) per frame as an encoder emits them:
    runs of 6-23 ONLY_LONG frames, each broken by LONG_START, 1-3
    EIGHT_SHORT and LONG_STOP (a few transients a second at 46.9 frames a
    second). The shape may switch at a run's first frame (half the time)
    and at each frame of a transient (a quarter of the time), so every
    (sequence, shape, previous shape) occurs on a long stream."""
    seqs, shapes = [], []
    shape = int(rng.randint(2))
    while len(seqs) < n_frames:
        if rng.rand() < 0.5:
            shape ^= 1
        run = [ONLY_LONG] * int(rng.randint(6, 24))
        run += [LONG_START] + [EIGHT_SHORT] * int(rng.randint(1, 4))
        run += [LONG_STOP]
        for k, s in enumerate(run):
            if s != ONLY_LONG and rng.rand() < 0.25:
                shape ^= 1
            seqs.append(s)
            shapes.append(shape)
    return (np.array(seqs[:n_frames], np.int32),
            np.array(shapes[:n_frames], np.int32))


def aac_decoder_config(asc: bytes, avg_bitrate: int = 128000) -> bytes:
    """IAMF AAC decoder_config: the fixed-layout DecoderConfigDescriptor
    (IAMF_aac_decoder.c:83-96): 0x04, OTI 0x40, streamType, bufferSizeDB
    u24, maxBitrate u32, avgBitrate u32, 0x05, the raw ASC. A copy of
    tests/vectors.py's."""
    return (
        bytes([0x04,
               0x40,          # objectTypeIndication: MPEG-4 audio
               0x15,          # streamType=audio(5)<<2 | reserved 1
               0, 0, 0])      # bufferSizeDB u24
        + (avg_bitrate * 2).to_bytes(4, "big")
        + avg_bitrate.to_bytes(4, "big")
        + bytes([0x05]) + asc
    )


# AudioSpecificConfig: AAC-LC (object type 2), 48 kHz (index 3), 2 channels
AAC_ASC = bytes([0x11, 0x90])
AAC_LONG_GAIN = 140   # global_gain of long blocks: peaks near -12 dBFS
AAC_SHORT_GAIN = 134  # short blocks: 2^(6/4) lower, as their IMDCT is
AAC_POOL = 3          # blocks per (substream, sequence, shape)


def build_aac_layout_stream(layout: int, n_frames: int = 10, seed: int = 33,
                            gain_offset: int = 0,
                            hrm: int = 0) -> tuple[bytes, list]:
    """Single-layer channel-based AAC-LC stream for any IA layout, 1024
    samples a frame at 48 kHz. Each substream has its own window schedule
    (aac_window_schedule) and draws its frames from a pool of AAC_POOL
    blocks per (sequence, shape), so long streams build in seconds. Every
    block carries the whole 48 kHz band (49 long or 14 short bands).
    gain_offset raises every global_gain (4 = 6 dB louder); hrm is the
    element's headphones_rendering_mode (1: HRTF convolution when decoded
    binaurally). Returns (stream, per-substream access-unit lists)."""
    tab = aac_tables()
    rng = np.random.RandomState(seed)
    nsub, ncoupled = _layer_substreams(layout)
    all_packets = []
    for s in range(nsub):
        nch = 2 if s < ncoupled else 1
        seqs, shapes = aac_window_schedule(n_frames, rng)
        blocks = {}
        for key in set(zip(seqs.tolist(), shapes.tolist())):
            gg = (AAC_SHORT_GAIN if key[0] == EIGHT_SHORT
                  else AAC_LONG_GAIN) + gain_offset
            blocks[key] = [aac_block(rng, tab, nch, *key,
                                     max_sfb=tab["num_long"], global_gain=gg)
                           for _ in range(AAC_POOL)]
        pick = rng.randint(AAC_POOL, size=n_frames)
        all_packets.append([blocks[(int(q), int(h))][int(k)]
                            for q, h, k in zip(seqs, shapes, pick)])

    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(1, b"mp4a", 1024, -1,
                                    aac_decoder_config(AAC_ASC))
    out += _channel_element_and_mix(layout, nsub, ncoupled, 48000, 1024,
                                    hrm)
    for f in range(n_frames):
        for s in range(nsub):
            out += builder.audio_frame_obu(s, all_packets[s][f])
    return bytes(out), all_packets


def _channel_element_and_mix(layout, nsub, ncoupled, rate, frame_size,
                             hrm=0):
    """The audio element (one channel-based layer, a demixing parameter
    for more than two channels) and a mix presentation for sound systems
    A and B, as the codec builders of tests/vectors.py write them."""
    demix = None
    if len(LAYOUT_CHANNELS_CODEC[ChannelLayout(layout)]) > 2:
        demix = builder.ParamDefinition(
            id=998, rate=rate, mode=0, duration=frame_size,
            constant_segment_interval=frame_size,
        )
    out = builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1,
        substream_ids=list(range(nsub)),
        layers=[builder.LayerSpec(layout, nsub, ncoupled)],
        demix_param=demix,
        default_demix_mode=0,
        default_demix_w=0,
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1, mix_gain_param=builder.ParamDefinition(id=100),
                headphones_rendering_mode=hrm,
            )
        ],
        layouts=[builder.LayoutSpec(sound_system=0),
                 builder.LayoutSpec(sound_system=1)],
    )
    return out


# --- FLAC frames of VERBATIM subframes -----------------------------------

def _crc8(data) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else \
                (crc << 1) & 0xFF
    return crc


def _crc16(data) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else \
                (crc << 1) & 0xFFFF
    return crc


def _utf8_number(n: int) -> bytes:
    """A FLAC frame number in the UTF-8 style code (RFC 9639 §9.1.5)."""
    if n < 0x80:
        return bytes([n])
    nb = 2
    while n >= 1 << (5 * nb + 1):
        nb += 1
    head = (0xFF << (8 - nb)) & 0xFF | n >> (6 * (nb - 1))
    return bytes([head] + [0x80 | (n >> (6 * i)) & 0x3F
                           for i in range(nb - 2, -1, -1)])


def flac_frame(pcm, number: int) -> bytes:
    """One FLAC frame of 16-bit PCM [n, ch] at 48 kHz, independent
    channels, each a VERBATIM subframe (RFC 9639 §9)."""
    n, ch = pcm.shape
    head = bytes([0xFF, 0xF8, 0x7A, ((ch - 1) << 4) | 0x08])
    head += _utf8_number(number) + struct.pack(">H", n - 1)
    head += bytes([_crc8(head)])
    body = b"".join(b"\x02" + np.asarray(pcm[:, c]).astype(">i2").tobytes()
                    for c in range(ch))
    frame = head + body
    return frame + struct.pack(">H", _crc16(frame))


def flac_conf(block: int, ch: int) -> bytes:
    """METADATA_BLOCK_HEADER (last, STREAMINFO) + STREAMINFO: 48 kHz,
    16 bits, `block` samples a frame."""
    info = struct.pack(">HH", block, block) + b"\0" * 6
    v = (48000 << 44) | ((ch - 1) << 41) | (15 << 36)  # 20+3+5+36 bits
    info += v.to_bytes(8, "big") + b"\0" * 16
    return bytes([0x80]) + len(info).to_bytes(3, "big") + info


FLAC_FRAME = 1024


def build_flac_layout_stream(layout: int,
                             n_frames: int = 8) -> tuple[bytes, np.ndarray]:
    """Single-layer channel-based FLAC stream at 48 kHz, 16 bits, 1024
    samples a frame: the multitone of sine_pcm at half scale in VERBATIM
    frames. Returns (stream, source PCM [n, nch] in codec channel
    order)."""
    frame_size = FLAC_FRAME
    nch = len(LAYOUT_CHANNELS_CODEC[ChannelLayout(layout)])
    nsub, ncoupled = _layer_substreams(layout)
    pcm = sine_pcm(n_frames * frame_size, nch, 48000, amp=0.5, seed=2)
    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(1, b"fLaC", frame_size, 0,
                                    flac_conf(frame_size, 2))
    out += _channel_element_and_mix(layout, nsub, ncoupled, 48000,
                                    frame_size)
    for f in range(n_frames):
        frame = pcm[f * frame_size:(f + 1) * frame_size]
        ch = 0
        for s in range(nsub):
            want = 2 if s < ncoupled else 1
            out += builder.audio_frame_obu(
                s, flac_frame(frame[:, ch:ch + want], f))
            ch += want
    return bytes(out), pcm


def split_into_units(stream: bytes) -> tuple[bytes, list[bytes]]:
    """Split a bitstream into (descriptor OBUs, [temporal unit bytes]).

    A temporal unit = parameter blocks + one audio frame per substream; the
    unit closes when the substream count for the element is reached.
    """
    off = parser.find_sequence_header(stream)
    descriptors = bytearray()
    units: list[bytes] = []
    nb_substreams = 0
    cur = bytearray()
    frames_in_unit = 0
    pos = off
    while pos < len(stream):
        obu = parser.split_obu(stream, pos)
        if obu is None:
            break
        raw = stream[pos : pos + obu.size]
        if obu.is_descriptor:
            descriptors += raw
            if obu.type == 1:  # audio element: count substreams
                el = parser.parse_audio_element(obu)
                nb_substreams = el.nb_substreams
        else:
            cur += raw
            if obu.is_audio_frame:
                frames_in_unit += 1
                if frames_in_unit >= nb_substreams:
                    units.append(bytes(cur))
                    cur = bytearray()
                    frames_in_unit = 0
        pos += obu.size
    if cur:
        units.append(bytes(cur))
    return bytes(descriptors), units


def build_mp4(stream: bytes, frame_size: int = 960, media_time: int = 0,
              roll_distance: int = None) -> bytes:
    descriptors, units = split_into_units(stream)
    return mp4builder.mux_iamf_mp4(
        descriptors, units, frame_size=frame_size, media_time=media_time,
        roll_distance=roll_distance,
    )


def build_fmp4(stream: bytes, frame_size: int = 960, fragments: int = 2,
               base_data_offset: bool = False) -> bytes:
    descriptors, units = split_into_units(stream)
    return mp4builder.mux_iamf_fmp4(
        descriptors, units, frame_size=frame_size, fragments=fragments,
        base_data_offset=base_data_offset,
    )


# --- Opus at other operating points, from an existing Opus stream ----------

# variant -> (TOC config, frames a packet) for each unit parity; "mixed"
# alternates hybrid-960 and CELT-960 unit by unit (RFC 6716 §3.1 configs:
# 9 SILK WB 20 ms, 14/15 hybrid FB 10/20 ms, 28-31 CELT FB 2.5-20 ms)
OPUS_VARIANTS = {
    "celt480x2": ((30, 2), (30, 2)),
    "celt240x4": ((29, 4), (29, 4)),
    "celt120x8": ((28, 8), (28, 8)),
    "hybrid960": ((15, 1), (15, 1)),
    "hybrid480x2": ((14, 2), (14, 2)),
    "silk960": ((9, 1), (9, 1)),
    "mixed": ((15, 1), (31, 1)),
}


def retoc_packet(pkt: bytes, config: int, frames: int) -> bytes:
    """An Opus packet with a new TOC config (the stereo bit kept) around
    pkt's payload (the bytes after its TOC): code 0 for one frame, code 1
    (two equal frames) with the payload twice, code 3 CBR (RFC 6716 §3.2.5)
    with the payload cut into `frames` equal parts (a remainder dropped)."""
    toc = (config << 3) | (pkt[0] & 0x4)
    body = bytes(pkt[1:])
    if frames == 1:
        return bytes([toc]) + body
    if frames == 2:
        return bytes([toc | 1]) + body + body
    size = len(body) // frames
    return bytes([toc | 3, frames]) + body[:size * frames]


def _audio_frame_payload(obu):
    """(substream key, id prefix bytes, packet) of an audio-frame OBU: the
    explicit-id type carries its substream id as a leb128 prefix."""
    data = bytes(obu.payload)
    if obu.type != 5:  # AUDIO_FRAME_ID0.. carry the id in the type
        return obu.type, b"", data
    i = 0
    while data[i] & 0x80:
        i += 1
    return data[:i + 1], data[:i + 1], data[i + 1:]


def retoc_opus_stream(data: bytes, variant: str) -> bytes:
    """The Opus IAMF stream `data` at another operating point
    (OPUS_VARIANTS): every audio-frame OBU rewrapped around its re-TOCed
    packet with its trims, every other OBU copied byte for byte. Test
    content, not a decoder feature: the payloads are the originals', so the
    sound is loud and noisy, but every packet is legal."""
    cfgs = OPUS_VARIANTS[variant]
    out = bytearray()
    units: dict = {}
    pos = parser.find_sequence_header(data)
    while pos < len(data):
        obu = parser.split_obu(data, pos)
        if obu is None:
            break
        raw = data[pos:pos + obu.size]
        pos += obu.size
        if not 5 <= obu.type <= 23:
            out += raw
            continue
        key, prefix, pkt = _audio_frame_payload(obu)
        u = units.get(key, 0)
        units[key] = u + 1
        config, frames = cfgs[u % 2]
        out += builder.obu_wrap(obu.type,
                                prefix + retoc_packet(pkt, config, frames),
                                trim_start=obu.trim_start,
                                trim_end=obu.trim_end)
    return bytes(out)


def build_opus_stereo_stream(data: bytes, n: int) -> bytes:
    """A stereo IAMF stream of n-sample Opus frames (n = 480 or 240; CELT
    FB, one frame a unit, TOC config 30 or 29) around the packets of the
    Opus stream `data`'s substream 0 (a coupled one), with its codec
    config's decoder_conf. The stream's head and tail trims are spread over
    the first and last units, no OBU trimming more than its frame."""
    config = {480: 30, 240: 29}[n]
    pos = parser.find_sequence_header(data)
    conf = None
    pkts = []
    while pos < len(data):
        obu = parser.split_obu(data, pos)
        if obu is None:
            break
        pos += obu.size
        if obu.type == 0:
            conf = parser.parse_codec_config(obu).decoder_conf
        elif obu.type == 6:
            pkts.append((bytes(obu.payload), obu.trim_start, obu.trim_end))
    head = sum(t for _, t, _ in pkts)
    tail = sum(t for _, _, t in pkts)
    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(1, b"Opus", n, -(-3840 // n), conf)
    out += builder.audio_element_obu(
        element_id=1, element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1, substream_ids=[0],
        layers=[builder.LayerSpec(ChannelLayout.STEREO, 1, 1)])
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[builder.MixElementSpec(
            element_id=1, mix_gain_param=builder.ParamDefinition(id=100))],
        layouts=[builder.LayoutSpec(sound_system=0)])
    for u, (pkt, _, _) in enumerate(pkts):
        ts = min(n, max(head - u * n, 0))
        te = min(n, max(tail - (len(pkts) - 1 - u) * n, 0))
        out += builder.audio_frame_obu(0, retoc_packet(pkt, config, 1),
                                       trim_start=ts, trim_end=te)
    return bytes(out)


def loop_units(data: bytes, units: int) -> bytes:
    """`data` (descriptors, then temporal units: split_into_units) with its
    units repeated in order to `units` units; the repeats' audio-frame
    OBUs are rewrapped without trims, so only the stream's own first pass
    trims (30 s of Opus from the 16-unit sample: units = 1500)."""
    desc, src = split_into_units(data)
    out = bytearray(desc)
    for u in range(units):
        unit = src[u % len(src)]
        if u < len(src):
            out += unit
            continue
        pos = 0
        while pos < len(unit):
            obu = parser.split_obu(unit, pos)
            raw = unit[pos:pos + obu.size]
            pos += obu.size
            out += (builder.obu_wrap(obu.type, bytes(obu.payload))
                    if 5 <= obu.type <= 23 and obu.trimming else raw)
    return bytes(out)
