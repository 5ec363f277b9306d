"""IAMF stream writing and splitting, frozen for the benchmark.

Copies, so that a change to the program cannot move the benchmark's
inputs:
- ``write_leb128``: iamf_tpu_torch/obu/bitstream.py:131;
- ``split_obu`` / ``find_sequence_header`` (header fields only):
  iamf_tpu_torch/obu/parser.py:34 and :172;
- ``BitWriter``, ``obu_wrap``, ``ParamDefinition``, ``sequence_header_obu``,
  ``codec_config_obu``, ``pcm_decoder_conf``, ``LayerSpec``,
  ``audio_element_obu`` (channel-based part), ``MixElementSpec``,
  ``LayoutSpec``, ``mix_presentation_obu``, ``audio_frame_obu``,
  ``pack_pcm_frame`` (16-bit part): iamf_tpu_torch/tools/builder.py:20-395;
- ``sine_pcm``: iamf_tpu_torch/tools/streams.py:33 (also on a torch device);
- ``build_pcm_layout_stream`` (no parameter blocks):
  iamf_tpu_torch/tools/streams.py:75;
- ``split_into_units``: iamf_tpu_torch/tools/streams.py:737;
- ``loop_units``: iamf_tpu_torch/tools/streams.py:906, with a first unit
  other than the stream's own (``first``); ``loop_trims`` gives its trims
  from how it is built.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence

import numpy as np

OBU_AUDIO_ELEMENT = 1
OBU_MIX_PRESENTATION = 2
OBU_CODEC_CONFIG = 0
OBU_AUDIO_FRAME = 5
OBU_AUDIO_FRAME_ID0 = 6
OBU_AUDIO_FRAME_ID17 = 23
OBU_SEQUENCE_HEADER = 31
PARAM_DEMIXING = 1
LAYOUT_SS_CONVENTION = 2
LAYOUT_BINAURAL = 3


def write_leb128(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _leb128(buf, pos: int) -> tuple[int, int]:
    value, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


class Obu(NamedTuple):
    type: int
    trimming: bool
    trim_start: int
    trim_end: int
    payload: bytes
    size: int

    @property
    def is_descriptor(self) -> bool:
        return self.type in (OBU_CODEC_CONFIG, OBU_AUDIO_ELEMENT,
                             OBU_MIX_PRESENTATION, OBU_SEQUENCE_HEADER)

    @property
    def is_audio_frame(self) -> bool:
        return OBU_AUDIO_FRAME <= self.type <= OBU_AUDIO_FRAME_ID17


def split_obu(data, offset: int = 0) -> Optional[Obu]:
    """The OBU at `offset`, or None when it is not complete."""
    if len(data) - offset < 2:
        return None
    h = data[offset]
    obu_type, trimming, extension = h >> 3, bool(h & 2), bool(h & 1)
    size, pos = _leb128(data, offset + 1)
    end = pos + size
    if end > len(data):
        return None
    trim_start = trim_end = 0
    if trimming:
        trim_end, pos = _leb128(data, pos)
        trim_start, pos = _leb128(data, pos)
    if extension:
        ext, pos = _leb128(data, pos)
        pos += ext
    return Obu(obu_type, trimming, trim_start, trim_end,
               bytes(data[pos:end]), end - offset)


def find_sequence_header(data) -> int:
    for i in range(len(data) - 1):
        if (data[i] >> 3) == OBU_SEQUENCE_HEADER:
            obu = split_obu(data, i)
            if obu is not None and obu.payload[:4] == b"iamf":
                return i
    return -1


def trims(data) -> tuple[int, int]:
    """The stream's samples trimmed at its start and at its end: the sums
    over the first substream's audio frames."""
    pos = find_sequence_header(data)
    lead = tail = 0
    while pos < len(data):
        obu = split_obu(data, pos)
        pos += obu.size
        if obu.type in (OBU_AUDIO_FRAME_ID0, OBU_AUDIO_FRAME):
            lead += obu.trim_start
            tail += obu.trim_end
    return lead, tail


def audio_element_substreams(payload: bytes) -> int:
    """num_substreams of an audio element OBU's payload."""
    _, pos = _leb128(payload, 0)  # audio_element_id
    pos += 1  # type (3 bits) + reserved (5)
    _, pos = _leb128(payload, pos)  # codec_config_id
    n, _ = _leb128(payload, pos)
    return n


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


def obu_wrap(obu_type: int, payload: bytes, redundant: bool = False,
             trim_start: int = 0, trim_end: int = 0) -> bytes:
    trimming = trim_start > 0 or trim_end > 0
    pre = bytearray()
    if trimming:
        pre += write_leb128(trim_end)
        pre += write_leb128(trim_start)
    body = bytes(pre) + payload
    header = bytearray()
    header.append(((obu_type & 0x1F) << 3) | (0x4 if redundant else 0)
                  | (0x2 if trimming else 0))
    header += write_leb128(len(body))
    return bytes(header) + body


@dataclass
class ParamDefinition:
    id: int
    rate: int = 48000
    mode: int = 1
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


def sequence_header_obu() -> bytes:
    w = BitWriter()
    w.raw(b"iamf")
    w.u8(0)
    w.u8(0)
    return obu_wrap(OBU_SEQUENCE_HEADER, w.bytes())


def codec_config_obu(codec_conf_id: int, codec_4cc: bytes,
                     nb_samples_per_frame: int, roll_distance: int,
                     decoder_conf: bytes) -> bytes:
    w = BitWriter()
    w.leb128(codec_conf_id)
    w.raw(codec_4cc)
    w.leb128(nb_samples_per_frame)
    w.s16(roll_distance)
    w.raw(decoder_conf)
    return obu_wrap(OBU_CODEC_CONFIG, w.bytes())


def pcm_decoder_conf(sample_size: int, sample_rate: int) -> bytes:
    return struct.pack(">BBI", 1, sample_size, sample_rate)


@dataclass
class LayerSpec:
    loudspeaker_layout: int
    nb_substreams: int
    nb_coupled_substreams: int


def audio_element_obu(element_id: int, codec_config_id: int,
                      substream_ids: Sequence[int], layers: Sequence[LayerSpec],
                      demix_param: Optional[ParamDefinition]) -> bytes:
    """A channel-based audio element (element_type 0), default demixing
    mode 0 and weight 0."""
    w = BitWriter()
    w.leb128(element_id)
    w.bits(0, 3)
    w.bits(0, 5)
    w.leb128(codec_config_id)
    w.leb128(len(substream_ids))
    for sid in substream_ids:
        w.leb128(sid)
    w.leb128(1 if demix_param else 0)
    if demix_param is not None:
        w.leb128(PARAM_DEMIXING)
        demix_param.write(w)
        w.bits(0, 3)
        w.bits(0, 5)
        w.bits(0, 4)
        w.bits(0, 4)
    w.bits(len(layers), 3)
    w.bits(0, 5)
    for layer in layers:
        w.bits(layer.loudspeaker_layout, 4)
        w.bits(0, 1)
        w.bits(0, 1)
        w.bits(0, 2)
        w.u8(layer.nb_substreams)
        w.u8(layer.nb_coupled_substreams)
    return obu_wrap(OBU_AUDIO_ELEMENT, w.bytes())


@dataclass
class MixElementSpec:
    element_id: int
    mix_gain_param: ParamDefinition = field(
        default_factory=lambda: ParamDefinition(id=100))
    default_mix_gain_q78: int = 0
    headphones_rendering_mode: int = 0
    labels: Sequence[str] = ("element",)


@dataclass
class LayoutSpec:
    sound_system: int = -1  # >= 0: sound-system convention; -1: binaural


def mix_presentation_obu(mix_presentation_id: int,
                         elements: Sequence[MixElementSpec],
                         layouts: Sequence[LayoutSpec],
                         default_output_mix_gain_q78: int = 0) -> bytes:
    w = BitWriter()
    w.leb128(mix_presentation_id)
    languages, labels = ("en-us",), ("mix",)
    w.leb128(len(languages))
    for s in languages:
        w.string(s)
    for s in labels:
        w.string(s)
    w.leb128(1)  # num_sub_mixes
    w.leb128(len(elements))
    for e in elements:
        w.leb128(e.element_id)
        for s in e.labels:
            w.string(s)
        w.bits(e.headphones_rendering_mode, 2)
        w.bits(0, 6)
        w.leb128(0)
        e.mix_gain_param.write(w)
        w.s16(e.default_mix_gain_q78)
    ParamDefinition(id=999).write(w)
    w.s16(default_output_mix_gain_q78)
    w.leb128(len(layouts))
    for lay in layouts:
        if lay.sound_system >= 0:
            w.bits(LAYOUT_SS_CONVENTION, 2)
            w.bits(lay.sound_system, 4)
            w.bits(0, 2)
        else:
            w.bits(LAYOUT_BINAURAL, 2)
            w.bits(0, 6)
        w.u8(0)   # info_type
        w.s16(0)  # integrated loudness
        w.s16(0)  # digital peak
    return obu_wrap(OBU_MIX_PRESENTATION, w.bytes())


def audio_frame_obu(substream_index: int, data: bytes, trim_start: int = 0,
                    trim_end: int = 0) -> bytes:
    if not 0 <= substream_index <= 17:
        raise ValueError(f"substream {substream_index}: implicit ids 0..17")
    return obu_wrap(OBU_AUDIO_FRAME_ID0 + substream_index, data,
                    trim_start=trim_start, trim_end=trim_end)


def pack_pcm_frame(samples: np.ndarray) -> bytes:
    """[n, ch] int samples -> interleaved little-endian s16."""
    return samples.reshape(samples.shape[0], -1).astype("<i2").tobytes()


def sine_pcm(n: int, channels: int, rate: int = 48000, amp: float = 0.5,
             freqs=None, bits: int = 16, seed: int = 0,
             device=None) -> np.ndarray:
    """Deterministic multitone int PCM [n, channels]: per channel c a tone
    at freqs[c] (220 (c + 1) Hz) with a random phase and one at 3.1 times
    it at a tenth of the level. With a torch `device` the tones are
    computed there, in float64, in one call for all channels."""
    if freqs is None:
        freqs = [220.0 * (k + 1) for k in range(channels)]
    rng = np.random.RandomState(seed)
    phases = [rng.uniform(0, 2 * np.pi) for _ in range(channels)]
    scale = 2.0 ** (bits - 1) - 1
    if device is not None:
        import torch

        t = torch.arange(n, dtype=torch.float64, device=device)[None] / rate
        f = torch.tensor(freqs, dtype=torch.float64, device=device)[:, None]
        p = torch.tensor(phases, dtype=torch.float64, device=device)[:, None]
        out = (amp * torch.sin(2 * np.pi * f * t + p)
               + 0.1 * amp * torch.sin(2 * np.pi * 3.1 * f * t))
        return torch.round(out.T * scale).to(torch.int64).cpu().numpy()
    t = np.arange(n) / rate
    out = np.zeros((n, channels))
    for c in range(channels):
        out[:, c] = amp * np.sin(2 * np.pi * freqs[c] * t + phases[c])
        out[:, c] += 0.1 * amp * np.sin(2 * np.pi * 3.1 * freqs[c] * t)
    return np.round(out * scale).astype(np.int64)


def build_pcm_layout_stream(layout: int, nsub: int, ncoupled: int,
                            pcm: np.ndarray, frame_size: int = 960,
                            rate: int = 48000, hrm: int = 0) -> bytes:
    """A single-layer channel-based 16-bit LPCM stream of `pcm` [n, nch]
    (codec channel order: the coupled pairs, then the mono substreams),
    mix presentation for sound systems A and B, headphones rendering mode
    `hrm`, no parameter blocks."""
    nch = pcm.shape[1]
    n_frames = pcm.shape[0] // frame_size
    out = bytearray()
    out += sequence_header_obu()
    out += codec_config_obu(1, b"ipcm", frame_size, 0,
                            pcm_decoder_conf(16, rate))
    demix = None
    if nch > 2:
        demix = ParamDefinition(id=998, rate=rate, mode=0,
                                duration=frame_size,
                                constant_segment_interval=frame_size)
    out += audio_element_obu(1, 1, list(range(nsub)),
                             [LayerSpec(layout, nsub, ncoupled)], demix)
    out += mix_presentation_obu(
        10, [MixElementSpec(element_id=1, mix_gain_param=ParamDefinition(
            id=100), headphones_rendering_mode=hrm)],
        [LayoutSpec(sound_system=0), LayoutSpec(sound_system=1)])
    for f in range(n_frames):
        frame = pcm[f * frame_size:(f + 1) * frame_size]
        ch = 0
        for s in range(ncoupled):
            out += audio_frame_obu(s, pack_pcm_frame(frame[:, ch:ch + 2]))
            ch += 2
        for s in range(ncoupled, nsub):
            out += audio_frame_obu(s, pack_pcm_frame(frame[:, ch:ch + 1]))
            ch += 1
    return bytes(out)


def split_into_units(stream: bytes) -> tuple[bytes, list[bytes]]:
    """(descriptor OBUs, [temporal unit bytes]): a unit is the parameter
    blocks and one audio frame per substream."""
    pos = find_sequence_header(stream)
    descriptors = bytearray()
    units: list[bytes] = []
    nb_substreams = 0
    cur = bytearray()
    frames_in_unit = 0
    while pos < len(stream):
        obu = split_obu(stream, pos)
        if obu is None:
            break
        raw = stream[pos:pos + obu.size]
        if obu.is_descriptor:
            descriptors += raw
            if obu.type == OBU_AUDIO_ELEMENT:
                nb_substreams = audio_element_substreams(obu.payload)
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


def _retrim(unit: bytes, trim_start: int) -> bytes:
    """A unit with every audio frame's trims set to (trim_start, 0)."""
    out = bytearray()
    pos = 0
    while pos < len(unit):
        obu = split_obu(unit, pos)
        raw = unit[pos:pos + obu.size]
        pos += obu.size
        out += (obu_wrap(obu.type, obu.payload, trim_start=trim_start)
                if obu.is_audio_frame else raw)
    return bytes(out)


def _first_trim(unit: bytes) -> int:
    """The trim at start of a unit's first audio frame."""
    pos = 0
    while pos < len(unit):
        obu = split_obu(unit, pos)
        if obu.is_audio_frame:
            return obu.trim_start
        pos += obu.size
    return 0


def loop_trims(data: bytes) -> tuple[int, int]:
    """The trims at start and at end of any loop_units(data, ...): the
    source's first trim at start (on the looped stream's first unit), none
    at end. What trims() reads from the looped stream, without its walk
    over every OBU."""
    return _first_trim(split_into_units(data)[1][0]), 0


def loop_units(data: bytes, units: int, first: int = 0) -> bytes:
    """`data`'s descriptors, then `units` temporal units taken in order from
    its unit `first` on, wrapping round. The stream's first unit carries
    the source's first trim at start (Opus pre-skip) and no trim at end;
    every other unit carries none. With first = 0 and the source's trims
    at its first unit only, this is streams.loop_units."""
    desc, src = split_into_units(data)
    skip = _first_trim(src[0])
    plain = [_retrim(u, 0) for u in src]
    out = bytearray(desc)
    out += _retrim(src[first % len(src)], skip)
    for u in range(1, units):
        out += plain[(first + u) % len(src)]
    return bytes(out)
