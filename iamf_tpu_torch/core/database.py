"""Object database: descriptor sets, element items, parameter timelines.

Host-side equivalent of the reference database (IAMF_decoder.c:624-1336):
stores codec configs / elements / mix presentations, tracks per-parameter
segment queues with timestamp elapse, and evaluates mix-gain curves
(step/linear/bezier, :639-664) into dense per-frame gain vectors that feed
the TPU pipeline as inputs.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Optional

import numpy as np

from ..constants import AnimationType, Codec, ParameterType, db_to_linear, q78_to_db
from ..obu import objects as o
from ..obu.bitstream import BitReader


def time_transform(t1: int, s1: int, s2: int) -> int:
    """Rescale a duration between rates (IAMF_decoder.c:92-96)."""
    if s1 == s2:
        return t1
    return int(t1 * s2 / s1 + 0.5)


def codec_config_sampling_rate(cc: o.CodecConfig) -> int:
    """Extract the stream sampling rate from the codec-specific decoder
    config (iamf_codec_conf_get_sampling_rate, IAMF_decoder.c:707-750)."""
    conf = cc.decoder_conf
    codec = cc.codec
    if codec == Codec.PCM:
        return int.from_bytes(conf[2:6], "big")
    if codec == Codec.OPUS:
        return int.from_bytes(conf[4:8], "big")
    if codec == Codec.AAC:
        # DecoderConfigDescriptor(14B) + DecSpecificInfoTag(1B) then ASC
        br = BitReader(conf[15:])
        sf = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
              16000, 12000, 11025, 8000, 7350, 0, 0, 0]
        aot = br.bits(5)
        if aot == 31:
            br.bits(6)
        idx = br.bits(4)
        return br.bits(24) if idx == 0xF else sf[idx]
    if codec == Codec.FLAC:
        br = BitReader(conf)
        while True:
            last = br.bits(1)
            btype = br.bits(7)
            size = br.bits(24)
            if btype == 0:  # STREAMINFO
                br.skip_bits(80)
                return br.bits(20)
            br.skip_bits(size * 8)
            if last:
                return 0
    return 0


@dataclasses.dataclass
class MixGainUnit:
    """Per-frame evaluated mix gain (constant or per-sample)."""

    count: int
    constant_gain: float = 1.0
    gains: Optional[np.ndarray] = None  # [count] float32 linear, or None


class ParameterItem:
    """One parameter timeline (ParameterItem, IAMF_decoder_private.h)."""

    def __init__(self, base: o.ParameterBase, parent_id: int, rate: int):
        self.id = base.id
        self.type = base.type
        self.parent_id = parent_id
        self.base = base
        self.rate = rate
        self.timestamp = 0
        self.duration = 0
        self.elapse = 0
        self.segments: deque = deque()
        self.default_mix_gain = 1.0
        self.use_default = base.type == ParameterType.MIX_GAIN

    def add_block(self, block: o.ParameterBlock, redundant: bool) -> None:
        """iamf_database_parameter_add (IAMF_decoder.c:1041-1070)."""
        if redundant and self.duration > 0:
            return
        if self.type == ParameterType.MIX_GAIN and self.use_default:
            self.use_default = False
        for seg in block.segments:
            self.segments.append(seg)
            self.duration += seg.segment_interval

    def clear_segments(self) -> None:
        self.segments.clear()
        # Note: reference clears the queue but keeps timestamp/duration
        # bookkeeping zeroed at configure time via item recreation.
        self.duration = 0
        self.elapse = 0
        self.timestamp = 0

    def time_elapse(self, duration: int, rate: int) -> None:
        """iamf_database_parameters_time_elapse (IAMF_decoder.c:1089-1126)."""
        if not self.segments and self.duration == 0:
            # reference only advances items with queues; empty queue with
            # pending elapse is harmless
            pass
        self.elapse += time_transform(duration, rate, self.base.rate)
        while self.segments:
            seg = self.segments[0]
            if seg.segment_interval <= self.elapse:
                self.timestamp += seg.segment_interval
                self.duration -= seg.segment_interval
                self.elapse -= seg.segment_interval
                self.segments.popleft()
            else:
                break

    def get_segment(self, pts: int):
        """Segment covering pts (iamf_database_parameter_get_segment,
        IAMF_decoder.c:810-840): requires timestamp < pts <= timestamp +
        duration."""
        if not (self.timestamp < pts <= self.timestamp + self.duration):
            return None
        start = pts - self.timestamp
        for seg in self.segments:
            if start < seg.segment_interval:
                return seg
            start -= seg.segment_interval
        return None

    def get_mix_gain_unit(self, pts: int, duration: int, rate: int) -> MixGainUnit:
        """Dense gain evaluation (iamf_database_parameter_get_mix_gain_unit,
        IAMF_decoder.c:857-982), incl. bezier/linear/step curves."""
        use_default = False
        start = 0
        if pts < self.timestamp:
            use_default = True
        else:
            start = pts - self.timestamp

        if self.use_default or use_default:
            return MixGainUnit(count=duration, constant_gain=self.default_mix_gain)

        ratio = 1.0
        if rate != self.base.rate:
            ratio = (rate + 0.1) / self.base.rate

        gains: Optional[np.ndarray] = None
        count = 0
        constant = 1.0
        left = duration
        sgd = 0
        for seg in self.segments:
            minterval = int(seg.segment_interval * ratio)
            sgd += minterval
            if start < sgd:
                s_lin = db_to_linear(q78_to_db(seg.start_q78))
                if seg.animation_type == AnimationType.STEP:
                    if count == 0 and start + duration <= sgd:
                        constant = s_lin
                        count = duration
                    elif count == 0:
                        gains = np.empty(duration, dtype=np.float32)
                        count = sgd - start
                        gains[:count] = s_lin
                        start = sgd
                    else:
                        e = count + minterval
                        if e >= duration:
                            e = duration
                        else:
                            start = sgd
                        gains[count:e] = s_lin
                        count = e
                else:
                    e_lin = db_to_linear(q78_to_db(seg.end_q78))
                    off = start - (sgd - minterval)
                    if gains is None:
                        gains = np.empty(duration, dtype=np.float32)
                    if start + left <= sgd:
                        d = left
                    else:
                        d = sgd - start
                        start = sgd
                        left -= d
                    i = off + np.arange(d, dtype=np.float64)
                    if seg.animation_type == AnimationType.LINEAR:
                        # mix_gain_bezier_linear (IAMF_decoder.c:639-645)
                        vals = s_lin + (e_lin - s_lin) * i / minterval
                    else:
                        # mix_gain_bezier_quad (IAMF_decoder.c:647-664)
                        c_lin = db_to_linear(q78_to_db(seg.control_q78))
                        crt = seg.control_relative_time_q08 / 255.0
                        ct = int(crt * (minterval + 0.1))
                        alpha = minterval - 2 * ct
                        if alpha:
                            a = (np.sqrt(float(ct) ** 2 + alpha * i) - ct) / alpha
                        else:
                            a = i / (2 * ct)
                        vals = (s_lin + e_lin - 2 * c_lin) * a**2 + 2 * a * (
                            c_lin - s_lin
                        ) + s_lin
                    gains[count : count + d] = vals.astype(np.float32)
                    count += d
            if count == duration:
                break

        if gains is None:
            return MixGainUnit(count=count or duration, constant_gain=constant)
        return MixGainUnit(count=count, gains=gains)


@dataclasses.dataclass
class ElementItem:
    element: o.AudioElement
    codec_config: o.CodecConfig
    demixing: Optional[ParameterItem] = None
    recon_gain: Optional[ParameterItem] = None
    mix_gain: Optional[ParameterItem] = None


class Database:
    """Descriptor + parameter database (iamf_database_*)."""

    def __init__(self) -> None:
        self.version: Optional[o.SequenceHeader] = None
        self.codec_configs: dict[int, o.CodecConfig] = {}
        self.elements: dict[int, ElementItem] = {}
        self.mix_presentations: list[o.MixPresentation] = []
        self.parameters: dict[int, ParameterItem] = {}

    # -- descriptor ingest ------------------------------------------------

    def add_sequence_header(self, sh: o.SequenceHeader) -> None:
        self.version = sh

    def add_codec_config(self, cc: o.CodecConfig) -> None:
        self.codec_configs[cc.codec_conf_id] = cc

    def add_element(self, el: o.AudioElement) -> None:
        if el.element_id in self.elements:
            return
        cc = self.codec_configs.get(el.codec_config_id)
        if cc is None:
            raise ValueError(f"element {el.element_id}: unknown codec config")
        item = ElementItem(element=el, codec_config=cc)
        self.elements[el.element_id] = item
        rate = codec_config_sampling_rate(cc)
        for pb in el.parameters:
            pi = self.add_parameter_definition(pb, el.element_id, rate)
            if pb.type == ParameterType.DEMIXING:
                item.demixing = pi
            elif pb.type == ParameterType.RECON_GAIN:
                item.recon_gain = pi

    def add_mix_presentation(self, mp: o.MixPresentation) -> None:
        self.mix_presentations.append(mp)

    def add_parameter_definition(
        self, base: o.ParameterBase, parent_id: int, rate: int
    ) -> ParameterItem:
        pi = self.parameters.get(base.id)
        if pi is None:
            pi = ParameterItem(base, parent_id, rate)
            self.parameters[base.id] = pi
        return pi

    def add_parameter_block(self, block: o.ParameterBlock, redundant: bool) -> None:
        pi = self.parameters.get(block.id)
        if pi is not None:
            pi.add_block(block, redundant)

    # -- lookups ----------------------------------------------------------

    def element_by_parameter(self, pid: int) -> Optional[o.AudioElement]:
        for item in self.elements.values():
            for pb in item.element.parameters:
                if pb.id == pid:
                    return item.element
            if item.mix_gain is not None and item.mix_gain.id == pid:
                return item.element
        return None

    def substream_index(self, element_id: int, substream_id: int) -> int:
        item = self.elements.get(element_id)
        if item is None:
            return -1
        try:
            return item.element.substream_ids.index(substream_id)
        except ValueError:
            return -1

    def get_mix_presentation(self, mix_id: int) -> Optional[o.MixPresentation]:
        for mp in self.mix_presentations:
            if mp.mix_presentation_id == mix_id:
                return mp
        return None

    def get_demix_mode(self, pid: int, pts: int) -> int:
        pi = self.parameters.get(pid)
        if pi is None:
            return -1
        seg = pi.get_segment(pts)
        if seg is None or not isinstance(seg, o.DemixingSegment):
            return -1
        return seg.demixing_mode

    def get_recon_gain(self, pid: int, pts: int) -> Optional[o.ReconGainSegment]:
        pi = self.parameters.get(pid)
        if pi is None:
            return None
        seg = pi.get_segment(pts)
        return seg if isinstance(seg, o.ReconGainSegment) else None

    def parameters_time_elapse(self, duration: int, rate: int) -> None:
        for pi in self.parameters.values():
            pi.time_elapse(duration, rate)

    def parameters_clear_segments(self) -> None:
        for pi in self.parameters.values():
            pi.clear_segments()
