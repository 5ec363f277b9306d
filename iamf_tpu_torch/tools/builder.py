"""IAMF bitstream builder: writes IA-OBU streams (muxer side).

Inverse of obu/parser.py. Primarily used to synthesize test vectors (the
reference repo ships no corpus, SURVEY.md §4); wire format follows AOM IAMF
v1.0 exactly as the reference parser reads it (IAMF_OBU.c).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..constants import AnimationType, LayoutType, OBUType, ParameterType
from ..obu.bitstream import write_leb128


class BitWriter:
    def __init__(self) -> None:
        self.buf = bytearray()
        self._cur = 0
        self._nbits = 0

    def bits(self, value: int, n: int) -> None:
        for i in reversed(range(n)):
            self._cur = (self._cur << 1) | ((value >> i) & 1)
            self._nbits += 1
            if self._nbits == 8:
                self.buf.append(self._cur)
                self._cur = 0
                self._nbits = 0

    def align(self) -> None:
        if self._nbits:
            self._cur <<= 8 - self._nbits
            self.buf.append(self._cur)
            self._cur = 0
            self._nbits = 0

    def u8(self, v: int) -> None:
        self.align()
        self.buf.append(v & 0xFF)

    def s16(self, v: int) -> None:
        self.align()
        self.buf += struct.pack(">h", v)

    def u16(self, v: int) -> None:
        self.align()
        self.buf += struct.pack(">H", v)

    def u32(self, v: int) -> None:
        self.align()
        self.buf += struct.pack(">I", v)

    def leb128(self, v: int) -> None:
        self.align()
        self.buf += write_leb128(v)

    def raw(self, data: bytes) -> None:
        self.align()
        self.buf += data

    def string(self, s: str) -> None:
        self.align()
        self.buf += s.encode("utf-8") + b"\x00"

    def bytes(self) -> bytes:
        self.align()
        return bytes(self.buf)


def obu_wrap(
    obu_type: int,
    payload: bytes,
    redundant: bool = False,
    trim_start: int = 0,
    trim_end: int = 0,
) -> bytes:
    """Wrap a payload with an OBU header (IAMF_OBU.c:79-138 layout)."""
    trimming = trim_start > 0 or trim_end > 0
    pre = bytearray()
    if trimming:
        pre += write_leb128(trim_end)
        pre += write_leb128(trim_start)
    body = bytes(pre) + payload
    header = bytearray()
    header.append(
        ((obu_type & 0x1F) << 3)
        | (0x4 if redundant else 0)
        | (0x2 if trimming else 0)
    )
    header += write_leb128(len(body))
    return bytes(header) + body


@dataclass
class ParamDefinition:
    """Writer-side parameter definition (mode-0: timing in definition)."""

    id: int
    rate: int = 48000
    mode: int = 1  # 1 => parameter blocks carry their own timing
    duration: int = 0
    constant_segment_interval: int = 0
    segment_intervals: Sequence[int] = ()

    def write(self, w: BitWriter) -> None:
        w.leb128(self.id)
        w.leb128(self.rate)
        w.bits(self.mode, 1)
        w.bits(0, 7)
        if not self.mode:
            w.leb128(self.duration)
            w.leb128(self.constant_segment_interval)
            if not self.constant_segment_interval:
                w.leb128(len(self.segment_intervals))
                for si in self.segment_intervals:
                    w.leb128(si)


def sequence_header_obu(primary_profile: int = 0, additional_profile: int = 0,
                        redundant: bool = False) -> bytes:
    w = BitWriter()
    w.raw(b"iamf")
    w.u8(primary_profile)
    w.u8(additional_profile)
    return obu_wrap(OBUType.SEQUENCE_HEADER, w.bytes(), redundant=redundant)


def codec_config_obu(
    codec_conf_id: int,
    codec_4cc: bytes,
    nb_samples_per_frame: int,
    roll_distance: int,
    decoder_conf: bytes,
    redundant: bool = False,
) -> bytes:
    w = BitWriter()
    w.leb128(codec_conf_id)
    w.raw(codec_4cc)
    w.leb128(nb_samples_per_frame)
    w.s16(roll_distance)
    w.raw(decoder_conf)
    return obu_wrap(OBUType.CODEC_CONFIG, w.bytes(), redundant=redundant)


def pcm_decoder_conf(sample_size: int, sample_rate: int, little_endian: bool = True) -> bytes:
    return struct.pack(">BBI", 1 if little_endian else 0, sample_size, sample_rate)


@dataclass
class LayerSpec:
    loudspeaker_layout: int
    nb_substreams: int
    nb_coupled_substreams: int
    recon_gain_flag: bool = False
    output_gain_flags: int = 0  # 6-bit; nonzero => output gain present
    output_gain_q78: int = 0


def audio_element_obu(
    element_id: int,
    element_type: int,
    codec_config_id: int,
    substream_ids: Sequence[int],
    layers: Sequence[LayerSpec] = (),
    demix_param: Optional[ParamDefinition] = None,
    recon_param: Optional[ParamDefinition] = None,
    default_demix_mode: int = 0,
    default_demix_w: int = 0,
    ambisonics: Optional[dict] = None,
    redundant: bool = False,
) -> bytes:
    w = BitWriter()
    w.leb128(element_id)
    w.bits(element_type, 3)
    w.bits(0, 5)
    w.leb128(codec_config_id)
    w.leb128(len(substream_ids))
    for sid in substream_ids:
        w.leb128(sid)
    nb_params = (1 if demix_param else 0) + (1 if recon_param else 0)
    w.leb128(nb_params)
    if demix_param is not None:
        w.leb128(ParameterType.DEMIXING)
        demix_param.write(w)
        w.bits(default_demix_mode, 3)
        w.bits(0, 5)
        w.bits(default_demix_w, 4)
        w.bits(0, 4)
    if recon_param is not None:
        w.leb128(ParameterType.RECON_GAIN)
        recon_param.write(w)

    if element_type == 0:  # channel based
        w.bits(len(layers), 3)
        w.bits(0, 5)
        for layer in layers:
            w.bits(layer.loudspeaker_layout, 4)
            w.bits(1 if layer.output_gain_flags else 0, 1)
            w.bits(1 if layer.recon_gain_flag else 0, 1)
            w.bits(0, 2)
            w.u8(layer.nb_substreams)
            w.u8(layer.nb_coupled_substreams)
            if layer.output_gain_flags:
                w.bits(layer.output_gain_flags, 6)
                w.bits(0, 2)
                w.s16(layer.output_gain_q78)
    elif element_type == 1:  # scene based
        amb = ambisonics or {}
        mode = amb.get("mode", 0)
        w.leb128(mode)
        if mode == 0:
            w.u8(amb["output_channel_count"])
            w.u8(amb["substream_count"])
            w.raw(bytes(amb["mapping"]))
        else:
            w.u8(amb["output_channel_count"])
            w.u8(amb["substream_count"])
            w.u8(amb.get("coupled_substream_count", 0))
            w.raw(bytes(amb["mapping"]))
    return obu_wrap(OBUType.AUDIO_ELEMENT, w.bytes(), redundant=redundant)


@dataclass
class MixElementSpec:
    element_id: int
    mix_gain_param: ParamDefinition = field(
        default_factory=lambda: ParamDefinition(id=100)
    )
    default_mix_gain_q78: int = 0
    headphones_rendering_mode: int = 0
    labels: Sequence[str] = ("element",)


@dataclass
class LayoutSpec:
    sound_system: int = -1  # >=0 => SS convention, -1 => binaural
    integrated_loudness_q78: int = 0
    digital_peak_q78: int = 0
    info_type: int = 0
    true_peak_q78: int = 0
    anchors: tuple = ()  # (anchor_element u8, anchored_loudness q78) pairs
    #   written when info_type & 2 (anchored loudness)


def mix_presentation_obu(
    mix_presentation_id: int,
    elements: Sequence[MixElementSpec],
    layouts: Sequence[LayoutSpec],
    output_mix_gain_param: Optional[ParamDefinition] = None,
    default_output_mix_gain_q78: int = 0,
    languages: Sequence[str] = ("en-us",),
    labels: Sequence[str] = ("mix",),
    redundant: bool = False,
) -> bytes:
    w = BitWriter()
    w.leb128(mix_presentation_id)
    num_labels = len(languages)
    w.leb128(num_labels)
    for s in languages:
        w.string(s)
    for s in labels:
        w.string(s)
    w.leb128(1)  # num_sub_mixes

    w.leb128(len(elements))
    for e in elements:
        w.leb128(e.element_id)
        elabels = list(e.labels) + ["element"] * (num_labels - len(e.labels))
        for k in range(num_labels):
            w.string(elabels[k])
        w.bits(e.headphones_rendering_mode, 2)
        w.bits(0, 6)
        w.leb128(0)  # rendering_config_extension_size
        e.mix_gain_param.write(w)
        w.s16(e.default_mix_gain_q78)

    omg = output_mix_gain_param or ParamDefinition(id=999)
    omg.write(w)
    w.s16(default_output_mix_gain_q78)

    w.leb128(len(layouts))
    for lay in layouts:
        if lay.sound_system >= 0:
            w.bits(LayoutType.SS_CONVENTION, 2)
            w.bits(lay.sound_system, 4)
            w.bits(0, 2)
        else:
            w.bits(LayoutType.BINAURAL, 2)
            w.bits(0, 6)
        w.u8(lay.info_type)
        w.s16(lay.integrated_loudness_q78)
        w.s16(lay.digital_peak_q78)
        if lay.info_type & 1:
            w.s16(lay.true_peak_q78)
        if lay.info_type & 2:
            w.u8(len(lay.anchors))
            for elem, q78 in lay.anchors:
                w.u8(elem)
                w.s16(q78)
    return obu_wrap(OBUType.MIX_PRESENTATION, w.bytes(), redundant=redundant)


def audio_frame_obu(
    substream_index: int,
    data: bytes,
    trim_start: int = 0,
    trim_end: int = 0,
    explicit_id: Optional[int] = None,
) -> bytes:
    """Audio frame; substreams 0..17 use the implicit-id OBU types."""
    if explicit_id is not None:
        w = BitWriter()
        w.leb128(explicit_id)
        w.raw(data)
        return obu_wrap(OBUType.AUDIO_FRAME, w.bytes(), trim_start=trim_start,
                        trim_end=trim_end)
    assert 0 <= substream_index <= 17
    return obu_wrap(
        OBUType.AUDIO_FRAME_ID0 + substream_index,
        data,
        trim_start=trim_start,
        trim_end=trim_end,
    )


def temporal_delimiter_obu() -> bytes:
    return obu_wrap(OBUType.TEMPORAL_DELIMITER, b"")


def parameter_block_obu(
    param_id: int,
    ptype: int,
    segments: Sequence[dict],
    duration: int,
    constant_segment_interval: int = 0,
    mode: int = 1,
) -> bytes:
    """Write a parameter block. Each segment dict:
    mix gain: {interval?, animation, start, end?, control?, control_time?}
    demixing: {interval?, mode}
    recon:    {interval?, entries: [ (flags, [gains]) | None per layer ]}
    """
    w = BitWriter()
    w.leb128(param_id)
    if mode:
        w.leb128(duration)
        w.leb128(constant_segment_interval)
        if not constant_segment_interval:
            w.leb128(len(segments))
    for seg in segments:
        if mode and not constant_segment_interval:
            w.leb128(seg["interval"])
        if ptype == ParameterType.MIX_GAIN:
            anim = seg.get("animation", AnimationType.STEP)
            w.leb128(anim)
            w.s16(seg["start"])
            if anim != AnimationType.STEP:
                w.s16(seg["end"])
                if anim == AnimationType.BEZIER:
                    w.s16(seg.get("control", 0))
                    w.u8(seg.get("control_time", 128))
        elif ptype == ParameterType.DEMIXING:
            w.bits(seg["mode"], 3)
            w.bits(0, 5)
        elif ptype == ParameterType.RECON_GAIN:
            for entry in seg["entries"]:
                if entry is None:
                    continue
                flags, gains = entry
                w.leb128(flags)
                for g in gains:
                    w.u8(g)
    return obu_wrap(OBUType.PARAMETER_BLOCK, w.bytes())


def pack_pcm_frame(samples: np.ndarray, sample_size: int, little_endian: bool = True) -> bytes:
    """Pack [n, ch] int samples into an interleaved PCM substream payload."""
    n, ch = samples.shape if samples.ndim == 2 else (samples.shape[0], 1)
    flat = samples.reshape(n, -1).astype(np.int64)
    inter = flat.reshape(-1)
    if sample_size == 16:
        return inter.astype("<i2" if little_endian else ">i2").tobytes()
    if sample_size == 32:
        return inter.astype("<i4" if little_endian else ">i4").tobytes()
    if sample_size == 24:
        as32 = inter.astype("<i4").view(np.uint8).reshape(-1, 4)
        if little_endian:
            return np.ascontiguousarray(as32[:, :3]).tobytes()
        return np.ascontiguousarray(as32[:, 2::-1]).tobytes()
    raise ValueError(f"bad sample size {sample_size}")
