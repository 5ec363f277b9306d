"""Per-element stream state: the host half of iamf_tpu/core/stream.py.

A copy of the reference module's lines 39-336 (layout maps, recon-gain
helpers, ``Stream`` layer selection) with its imports redirected: the
reference module imports JAX at module level for its serial decoder.
The serial ``StreamDecoder`` / ``StreamRenderer`` are not ported yet
(ROADMAP.md §1 item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..constants import (
    CH,
    ChannelLayout,
    ElementType,
    LAYOUT_CATEGORY_COUNT,
    LAYOUT_CHANNELS_CODEC,
    LayoutType,
    SoundSystem,
    SOUND_SYSTEM_CHANNEL_COUNT,
    db_to_linear,
    q78_to_db,
)
from ..dsp import render as rdr
from .database import ElementItem, codec_config_sampling_rate

AAC_FRAME_SIZE = 1024
MAX_FRAME_SIZE = AAC_FRAME_SIZE * 6

# sound system -> equivalent IA channel layout for downmix targeting
# (iamf_sound_system_get_channel_layout, IAMF_decoder.c:228-239)
SS_TO_LAYOUT = {
    SoundSystem.A: ChannelLayout.STEREO,
    SoundSystem.B: ChannelLayout.L510,
    SoundSystem.C: ChannelLayout.L512,
    SoundSystem.D: ChannelLayout.L514,
    SoundSystem.I: ChannelLayout.L710,
    SoundSystem.J: ChannelLayout.L714,
    SoundSystem.EXT_712: ChannelLayout.L712,
    SoundSystem.EXT_312: ChannelLayout.L312,
    SoundSystem.MONO: ChannelLayout.MONO,
}

# IA layer layout -> matching sound system
# (iamf_layer_layout_convert_sound_system, IAMF_decoder.c:269-276)
LAYOUT_TO_SS = {
    ChannelLayout.MONO: SoundSystem.MONO,
    ChannelLayout.STEREO: SoundSystem.A,
    ChannelLayout.L510: SoundSystem.B,
    ChannelLayout.L512: SoundSystem.C,
    ChannelLayout.L514: SoundSystem.D,
    ChannelLayout.L710: SoundSystem.I,
    ChannelLayout.L712: SoundSystem.EXT_712,
    ChannelLayout.L714: SoundSystem.J,
    ChannelLayout.L312: SoundSystem.EXT_312,
}


@dataclasses.dataclass
class OutputLayout:
    """Playback target (LayoutInfo equivalent, IAMF_decoder.c:3529-3581)."""

    type: int  # LayoutType
    sound_system: int = -1
    samsung_tv: bool = False

    @property
    def channels(self) -> int:
        if self.type == LayoutType.BINAURAL:
            return 2
        return SOUND_SYSTEM_CHANNEL_COUNT[SoundSystem(self.sound_system)]

    @property
    def render_id(self) -> int:
        if self.type == LayoutType.BINAURAL:
            return rdr.BINAURAL_ID
        return rdr.BS2051_IDS[SoundSystem(self.sound_system)]


def new_channels_for_layer(
    last: Optional[ChannelLayout], cur: ChannelLayout
) -> list[int]:
    """Channels added by a scalable layer, in codec order
    (iamf_channel_layout_get_new_channels, IAMF_decoder.c:454-521)."""
    if last is None:
        return list(LAYOUT_CHANNELS_CODEC[cur])
    s1, _, t1 = LAYOUT_CATEGORY_COUNT[last]
    s2, _, t2 = LAYOUT_CATEGORY_COUNT[cur]
    chs: list[int] = []
    if s1 < 5 <= s2:
        chs += [CH.L7, CH.R7]  # l5/r5
    if s1 < 7 <= s2:
        chs += [CH.SL7, CH.SR7]
    if t2 != t1 and t2 == 4:
        chs += [CH.HFL, CH.HFR]
    if t2 - t1 == 4:
        chs += [CH.HBL, CH.HBR]
    elif not t1 and t2 - t1 == 2:
        if s2 < 5:
            chs += [CH.TL, CH.TR]
        else:
            chs += [CH.HL, CH.HR]
    if s1 < 3 <= s2:
        chs += [CH.C, CH.LFE]
    if s1 < 2 <= s2:
        chs += [CH.L2]
    return chs


def output_gain_channel(layout: ChannelLayout, gain_ch: int) -> int:
    """iamf_output_gain_channel_map (IAMF_decoder.c:524-597).
    gain_ch: 0=RTF 1=LTF 2=RS 3=LS 4=R 5=L (IAMF_decoder_private.h:62-70)."""
    s = LAYOUT_CATEGORY_COUNT[layout][0]
    if gain_ch == 5:  # L
        return {
            ChannelLayout.MONO: CH.MONO,
            ChannelLayout.STEREO: CH.L2,
            ChannelLayout.L312: CH.L3,
        }.get(layout, CH.INVALID)
    if gain_ch == 4:  # R
        return {
            ChannelLayout.STEREO: CH.R2,
            ChannelLayout.L312: CH.R3,
        }.get(layout, CH.INVALID)
    if gain_ch == 3:  # LS
        return CH.SL5 if s == 5 else CH.INVALID
    if gain_ch == 2:  # RS
        return CH.SR5 if s == 5 else CH.INVALID
    if gain_ch == 1:  # LTF
        return CH.TL if s < 5 else CH.HL
    if gain_ch == 0:  # RTF
        return CH.TR if s < 5 else CH.HR
    return CH.INVALID


# Recon channel order + per-layout channel map
# (iamf_recon_channels_order_update, IAMF_decoder.c:410-452)
RECON_CHANNEL_ORDER = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11)
# index: recon channel id (IAReconChannel) -> actual channel per layout
RECON_CHANNEL_MAP = {
    ChannelLayout.MONO: (CH.MONO, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    ChannelLayout.STEREO: (CH.L2, 0, CH.R2, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    ChannelLayout.L510: (CH.L7, CH.C, CH.R7, CH.SL5, CH.SR5, 0, 0, 0, 0, 0, 0, CH.LFE),
    ChannelLayout.L512: (
        CH.L7, CH.C, CH.R7, CH.SL5, CH.SR5, CH.HL, CH.HR, 0, 0, 0, 0, CH.LFE,
    ),
    ChannelLayout.L514: (
        CH.L7, CH.C, CH.R7, CH.SL5, CH.SR5, CH.HFL, CH.HFR, 0, 0, CH.HBL, CH.HBR,
        CH.LFE,
    ),
    ChannelLayout.L710: (
        CH.L7, CH.C, CH.R7, CH.SL7, CH.SR7, 0, 0, CH.BL7, CH.BR7, 0, 0, CH.LFE,
    ),
    ChannelLayout.L712: (
        CH.L7, CH.C, CH.R7, CH.SL7, CH.SR7, CH.HL, CH.HR, CH.BL7, CH.BR7, 0, 0,
        CH.LFE,
    ),
    ChannelLayout.L714: (
        CH.L7, CH.C, CH.R7, CH.SL7, CH.SR7, CH.HFL, CH.HFR, CH.BL7, CH.BR7,
        CH.HBL, CH.HBR, CH.LFE,
    ),
    ChannelLayout.L312: (
        CH.L3, CH.C, CH.R3, 0, 0, CH.TL, CH.TR, 0, 0, 0, 0, CH.LFE,
    ),
}
# IAReconChannel enum order for iteration: L, C, R, LS, RS, LTF, RTF, LB, RB,
# LTB, RTB, LFE (recon_channel_order, IAMF_decoder.c:413-416)
RECON_ITER_ORDER = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11)


def recon_gain_flags_default(l1: ChannelLayout, l2: ChannelLayout) -> int:
    """iamf_recon_channels_get_flags (IAMF_decoder.c:371-408)."""
    if l1 == l2:
        return 0
    s1 = LAYOUT_CATEGORY_COUNT[l1][0]
    s2 = LAYOUT_CATEGORY_COUNT[l2][0]
    t1 = LAYOUT_CATEGORY_COUNT[l1][2]
    t2 = LAYOUT_CATEGORY_COUNT[l2][2]
    flags = 0
    if s1 != s2:
        if s2 <= 3:
            flags |= (1 << 0) | (1 << 2)  # RE_L, RE_R
        elif s2 == 5:
            flags |= (1 << 3) | (1 << 4)  # RE_LS, RE_RS
        elif s2 == 7:
            flags |= (1 << 7) | (1 << 8)  # RE_LB, RE_RB
    if t2 != t1 and t2 == 4:
        flags |= (1 << 9) | (1 << 10)  # RE_LTB, RE_RTB
    if s2 == 5 and t1 and t2 == t1:
        flags |= (1 << 5) | (1 << 6)  # RE_LTF, RE_RTF
    return flags


def recon_channels_from_flags(layout: ChannelLayout, flags: int) -> list[int]:
    """Actual channels selected by recon flags, in recon-channel order."""
    chs = []
    cmap = RECON_CHANNEL_MAP[layout]
    for rc in RECON_ITER_ORDER:
        if flags & (1 << rc):
            ch = cmap[rc]
            if ch:
                chs.append(ch)
    return chs


@dataclasses.dataclass
class LayerInfo:
    layout: ChannelLayout
    nb_substreams: int
    nb_coupled_substreams: int
    output_gain_flags: int = 0
    output_gain_linear: float = 1.0
    recon_gain: bool = False

    @property
    def nb_channels(self) -> int:
        return self.nb_substreams + self.nb_coupled_substreams


class Stream:
    """Per-element stream state (IAMF_Stream, IAMF_decoder_private.h:210-236)."""

    def __init__(
        self,
        item: ElementItem,
        layout: OutputLayout,
    ):
        el = item.element
        cc = item.codec_config
        self.element_id = el.element_id
        self.scheme = el.element_type
        self.codec = cc.codec
        self.codec_config = cc
        self.sampling_rate = codec_config_sampling_rate(cc)
        self.frame_size = cc.nb_samples_per_frame
        self.nb_substreams = el.nb_substreams
        self.final_layout = layout
        self.timestamp = 0
        self.trimming_start = 0
        self.trimming_end = 0
        self.max_frame_size = (
            cc.nb_samples_per_frame * 6
            if cc.nb_samples_per_frame > AAC_FRAME_SIZE
            else MAX_FRAME_SIZE
        )

        self.layers: list[LayerInfo] = []
        self.channels_order: list[int] = []
        self.layer = 0  # selected layer index
        self.dmx_mode = -1
        self.dmx_default_mode = -1
        self.dmx_default_w_idx = -1
        self.ambisonics_mode = -1
        self.ambisonics_mapping: bytes = b""
        self.nb_coupled_substreams = 0

        if self.scheme == ElementType.CHANNEL_BASED:
            conf = el.channels_config
            last = None
            for lc in conf.layers:
                layer = LayerInfo(
                    layout=ChannelLayout(lc.loudspeaker_layout),
                    nb_substreams=lc.nb_substreams,
                    nb_coupled_substreams=lc.nb_coupled_substreams,
                    recon_gain=lc.recon_gain_flag,
                )
                if lc.output_gain is not None:
                    layer.output_gain_flags = lc.output_gain.flags
                    layer.output_gain_linear = db_to_linear(
                        q78_to_db(lc.output_gain.gain_q78)
                    )
                self.layers.append(layer)
                self.channels_order += new_channels_for_layer(last, layer.layout)
                self.nb_coupled_substreams += lc.nb_coupled_substreams
                last = layer.layout
            self.nb_channels = self.nb_substreams + self.nb_coupled_substreams

            for pb in el.parameters:
                if pb.type == 1:  # DEMIXING
                    self.dmx_default_mode = pb.default_mode
                    self.dmx_default_w_idx = pb.default_w
                    break

            self.layer = len(self.layers) - 1
            self._select_layer(layout)
        else:
            amb = el.ambisonics_config
            self.nb_channels = amb.output_channel_count
            self.nb_substreams = amb.substream_count
            self.nb_coupled_substreams = amb.coupled_substream_count
            self.ambisonics_mode = amb.mode
            self.ambisonics_mapping = amb.mapping

    def _select_layer(self, layout: OutputLayout) -> None:
        """Scalable layer selection (iamf_stream_set_output_layout,
        IAMF_decoder.c:1779-1825; skipped under SAMSUNG_TV)."""
        if layout.samsung_tv:
            return  # always the highest layer
        if len(self.layers) == 1:
            return
        if layout.type == LayoutType.BINAURAL:
            self.layer = len(self.layers) - 1
            return
        target_ss = layout.sound_system
        for i, layer in enumerate(self.layers):
            if LAYOUT_TO_SS.get(layer.layout) == target_ss:
                self.layer = i
                return
        playback_channels = layout.channels
        for i, layer in enumerate(self.layers):
            if len(LAYOUT_CHANNELS_CODEC[layer.layout]) > playback_channels:
                self.layer = i
                return

    @property
    def selected_layout(self) -> ChannelLayout:
        """ctx->layout: layout of the selected layer."""
        return self.layers[self.layer].layout

    @property
    def selected_channels(self) -> int:
        return len(LAYOUT_CHANNELS_CODEC[self.selected_layout])
