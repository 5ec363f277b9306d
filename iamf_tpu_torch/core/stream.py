"""Per-element stream, stream decoder, and stream renderer (counterpart of
iamf_tpu/core/stream.py; reference: IAMF_decoder.c:1617-2430 stream and
decoder, :2440-2660 renderer).

The host half (layout maps, recon-gain helpers, ``Stream`` and its layer
selection) is a copy of the reference module's. ``StreamDecoder`` and
``StreamRenderer`` are the frame-serial decoder's (api.py): the codec
decode stays on the host (the port's copies of the codec decoders), then
the frame goes to the decoder's device once, together with the demixer's
per-sample factors and recon filters, and every sample operation after
that runs on tensors there: the demix (dsp/demix.demix_frame with one
frame), the ambisonics projection (torch.matmul, TF32 off), the gain-matrix
render in the reference's float32 order (``_accumulate_render``), the
downmix graph (dsp/downmix.downmix_apply) and the binaural HRTF
convolution (dsp/binaural.HRTFRenderer: K8 on the card). The H2M LFE
branch's biquad stays on the host, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..codecs.base import open_decoder
from ..constants import (
    CH,
    AmbisonicsMode,
    ChannelLayout,
    ElementType,
    LAYOUT_CATEGORY_COUNT,
    LAYOUT_CHANNELS_CODEC,
    LAYOUT_CHANNELS_RENDER,
    LayoutType,
    SoundSystem,
    SOUND_SYSTEM_CHANNEL_COUNT,
    db_to_linear,
    q78_to_db,
    q08_to_float,
)
from ..device import resolve_device
from ..dsp import render as rdr
from ..dsp.binaural import HRTFRenderer
from ..dsp.demix import DemixerState, DemixSpec, demix_frame
from ..dsp.downmix import DownmixerState, can_downmix, downmix_apply
from ..obu import objects as o
from .database import Database, ElementItem, codec_config_sampling_rate

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


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`: to the card from pinned
    memory without a host wait (the pinned block is not reused before its
    copy is done), on the CPU a copy."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


_DEMIX_KEYS = ("alpha", "beta", "gamma", "delta", "dw")


class StreamDecoder:
    """Per-element stream decoder (IAMF_StreamDecoder equivalent): host codec
    decode, then the frame on `device`."""

    def __init__(self, stream: Stream, db: Database, device="cuda"):
        self.stream = stream
        self.device = resolve_device(device)
        self.frame_size = stream.frame_size
        self.delay = -1
        self.frame_padding = 0
        cc = stream.codec_config

        self.sub_packets: list[Optional[bytes]] = [None] * stream.nb_substreams
        self.packet_count = 0
        self.strim = 0
        self.etrim = 0
        self._rg_index: dict = {}

        if stream.scheme == ElementType.CHANNEL_BASED:
            self.sub_decoders = []
            for i in range(stream.layer + 1):
                layer = stream.layers[i]
                self.sub_decoders.append(
                    open_decoder(
                        stream.codec,
                        cc.decoder_conf,
                        layer.nb_substreams,
                        layer.nb_coupled_substreams,
                        self.frame_size,
                    )
                )
            # demixer setup (iamf_stream_scale_demixer_configure :2351-2390)
            gains = []
            gain_map = {}
            for i in range(stream.layer + 1):
                layer = stream.layers[i]
                if layer.output_gain_flags:
                    for c in range(6):
                        if layer.output_gain_flags & (1 << c):
                            ch = output_gain_channel(layer.layout, c)
                            if ch != CH.INVALID:
                                gain_map[ch] = layer.output_gain_linear
            order = stream.channels_order[: stream.selected_channels]
            for ch in order:
                gains.append(gain_map.get(ch, 1.0))
            self.demix_spec = DemixSpec(
                layout=stream.selected_layout,
                channels_in=tuple(order),
                frame_size=self.frame_size,
                output_gains=tuple(gains),
            )
            self.demixer = DemixerState(self.demix_spec)
            if stream.dmx_default_mode >= 0:
                self.demixer.set_demixing_info(
                    stream.dmx_default_mode, stream.dmx_default_w_idx
                )
            self._set_default_recon_gain()
        else:
            self.sub_decoders = [
                open_decoder(
                    stream.codec,
                    cc.decoder_conf,
                    stream.nb_substreams,
                    stream.nb_coupled_substreams,
                    self.frame_size,
                )
            ]
            self.demixer = None
            self.demix_spec = None
            if stream.ambisonics_mode == AmbisonicsMode.PROJECTION:
                raw = stream.ambisonics_mapping
                n = stream.nb_channels
                m = stream.nb_substreams + stream.nb_coupled_substreams
                vals = np.frombuffer(raw, dtype=">i2").astype(np.float32) / 32768.0
                # stored [column=m][row=n] (IAMF_core_decoder.c:228-252)
                self.projection = vals.reshape(m, n)
                self._projection_t = to_device(self.projection.T, self.device)
            else:
                self.projection = None

    def _set_default_recon_gain(self) -> None:
        """iamf_stream_scale_decoder_set_default_recon_gain (:2209-2247)."""
        s = self.stream
        if s.layer > 0:
            flags = recon_gain_flags_default(s.layers[0].layout, s.selected_layout)
            chs = recon_channels_from_flags(s.selected_layout, flags)
            self.demixer.set_recon_gain(chs, [1.0] * len(chs), flags)
        else:
            self.demixer.set_recon_gain([], [], 0)

    # -- packets ----------------------------------------------------------

    def receive_packet(self, index: int, frame: o.AudioFrame) -> None:
        if 0 <= index < len(self.sub_packets):
            if self.sub_packets[index] is None:
                self.packet_count += 1
            self.sub_packets[index] = bytes(frame.data)
        if index == 0:
            self.strim = frame.trim_start
            self.etrim = frame.trim_end

    @property
    def packet_ready(self) -> bool:
        return self.packet_count == len(self.sub_packets)

    def finish_frame(self) -> None:
        self.sub_packets = [None] * self.stream.nb_substreams
        self.packet_count = 0

    # -- parameters -------------------------------------------------------

    def update_parameter(self, db: Database, pid: int) -> None:
        """iamf_stream_decoder_update_parameter (:2133-2152)."""
        pi = db.parameters.get(pid)
        if pi is None:
            return
        pts = self.stream.timestamp + self.frame_size // 2
        if pi.type == 1:  # DEMIXING
            self.stream.dmx_mode = db.get_demix_mode(pid, pts)
        elif pi.type == 2:  # RECON_GAIN
            seg = db.get_recon_gain(pid, pts)
            if seg is not None:
                self._update_recon_gain(seg)

    def _update_recon_gain(self, seg: o.ReconGainSegment) -> None:
        """iamf_stream_scale_decoder_update_recon_gain (:2249-2274):
        the demixer receives the gains of the *selected* layer."""
        s = self.stream
        for i in range(min(len(seg.entries), s.layer + 1)):
            entry = seg.entries[i]
            if entry is None or not s.layers[i].recon_gain:
                continue
            if i == s.layer:
                chs = recon_channels_from_flags(s.selected_layout, entry.flags)
                gains = [q08_to_float(g) for g in entry.gains_q08]
                self.demixer.set_recon_gain(chs, gains, entry.flags)

    # -- decode -----------------------------------------------------------

    def decode(self) -> torch.Tensor:
        """Decode one access unit -> planar float32 [channels, frame_size]
        on the device (scalable: stacked layer channels in codec order, then
        demixed to the selected layout's rendering order)."""
        s = self.stream
        self.frame_padding = 0
        if s.scheme == ElementType.CHANNEL_BASED:
            outs = []
            off = 0
            ret = self.frame_size
            for i, dec in enumerate(self.sub_decoders):
                n = s.layers[i].nb_substreams
                pcm = dec.decode(self.sub_packets[off : off + n])
                outs.append(pcm)
                off += n
                ret = pcm.shape[1]
            x = np.concatenate(outs, axis=0)
            if ret != self.frame_size:
                self.frame_padding = self.frame_size - ret
                pad = np.zeros((x.shape[0], self.frame_padding), dtype=x.dtype)
                x = np.concatenate([x, pad], axis=1)

            if self.delay < 0:
                self._discover_delay()

            # demix (iamf_stream_scale_decoder_demix :2276-2349): the
            # frame, its factor vectors and recon filters go to the device
            # in one copy
            if s.dmx_mode > -1:
                self.demixer.set_demixing_info(s.dmx_mode, -1)
            factors, rg_index, rg_filt = self.demixer.frame_params()
            c_in = len(self.demix_spec.channels_in)
            rows = [x[:c_in]] + [factors[k][None] for k in _DEMIX_KEYS]
            if rg_filt is not None:
                rows.append(rg_filt)
            buf = to_device(np.concatenate(rows, axis=0, dtype=np.float32),
                            self.device)
            ft = {k: buf[c_in + i][None] for i, k in enumerate(_DEMIX_KEYS)}
            rgf = None
            if rg_filt is not None:
                rgf = buf[c_in + len(_DEMIX_KEYS):][None]
            y = demix_frame(buf[None, :c_in], self.demix_spec, ft,
                            self._rg_index_tensor(rg_index), rgf)
            return y[0]
        else:
            pcm = self.sub_decoders[0].decode(self.sub_packets)
            ret = pcm.shape[1]
            if ret != self.frame_size:
                self.frame_padding = self.frame_size - ret
                pad = np.zeros((pcm.shape[0], self.frame_padding), dtype=pcm.dtype)
                pcm = np.concatenate([pcm, pad], axis=1)
            if self.delay < 0:
                self._discover_delay()
            if s.ambisonics_mode == AmbisonicsMode.MONO:
                # the channel mapping is a row copy: done before the copy
                mapping = list(s.ambisonics_mapping)
                out = np.zeros((s.nb_channels, pcm.shape[1]), dtype=np.float32)
                for i, m in enumerate(mapping):
                    if m < pcm.shape[0]:
                        out[i] = pcm[m]
                return to_device(out, self.device)
            x = to_device(pcm.astype(np.float32, copy=False), self.device)
            if s.ambisonics_mode == AmbisonicsMode.PROJECTION:
                # out[r] = sum_l in[l] * M[l, r]
                return torch.matmul(self._projection_t, x)
            return x

    def _rg_index_tensor(self, rg_index: tuple):
        """The recon-gain rows as an index tensor on the device, kept per
        set of rows (a list index would be copied to the card each
        frame)."""
        if not rg_index:
            return rg_index
        if rg_index not in self._rg_index:
            self._rg_index[rg_index] = torch.tensor(
                rg_index, dtype=torch.int64, device=self.device)
        return self._rg_index[rg_index]

    def _discover_delay(self) -> None:
        """iamf_stream_decoder_decode delay discovery (:2166-2189)."""
        s = self.stream
        if s.trimming_start != self.frame_size:
            self.delay = self.sub_decoders[0].delay
            s.trimming_start += self.delay
            if self.demixer is not None:
                self.demixer.set_frame_offset(self.delay)
        else:
            self.delay = self.sub_decoders[0].delay


def _accumulate_render(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Gain-matrix render with the reference's float32 accumulation order:
    out[n] += mat[m, n] * in[m] over ascending m (render_M2M m2m_rdr.c:
    1820-1840, render_H2M h2m_rdr.c:1088-1112), a separate multiply and
    add a step (never a fused multiply-add, never a matrix product), so
    the frame-serial path keeps the reference's roundings on any device.
    mat [M, N] and x [M, T] on one device -> [N, T]."""
    M, N = mat.shape
    out = x.new_zeros((N, x.shape[1]))
    for m in range(M):
        out = out + mat[m][:, None] * x[m][None, :]
    return out


class StreamRenderer:
    """Render one element's frame to the target layout
    (IAMF_StreamRenderer, IAMF_decoder.c:2440-2660) on the frame's
    device."""

    def __init__(self, stream: Stream, headphones_rendering_mode: int = 0,
                 lfe_hoa: bool = False, device="cuda"):
        self.stream = stream
        self.device = resolve_device(device)
        self.offset = 0
        self.headphones_rendering_mode = headphones_rendering_mode
        self.downmixer: Optional[DownmixerState] = None
        self.hrtf: Optional[HRTFRenderer] = None  # lazily created (M2B/H2B)
        # H2M LFE synthesis from W (the DISABLE_LFE_HOA=0 reference build,
        # h2m_rdr.c:1198-1238): 120 Hz biquad, state across frames
        self.lfe_hoa = lfe_hoa
        self.lfe_filter = None
        self._mats: dict = {}  # render matrices on the device
        layout = stream.final_layout

        if (
            stream.scheme == ElementType.CHANNEL_BASED
            and layout.type == LayoutType.SS_CONVENTION
            and stream.dmx_default_mode >= 0
        ):
            out_layout = SS_TO_LAYOUT.get(SoundSystem(layout.sound_system))
            in_layout = stream.selected_layout
            if out_layout is not None and can_downmix(in_layout, out_layout):
                self.downmixer = DownmixerState(in_layout, out_layout)
                self.downmixer.set_mode_weight(
                    stream.dmx_default_mode, stream.dmx_default_w_idx
                )

    def _mat(self, key, make) -> torch.Tensor:
        """A host render matrix (make()) on the device, built once."""
        if key not in self._mats:
            self._mats[key] = to_device(
                np.asarray(make(), dtype=np.float32), self.device)
        return self._mats[key]

    def render(self, x: torch.Tensor, frame_size: int) -> torch.Tensor:
        """x: [in_ch, T] (rendering order for channel-based) on the device
        -> [out_ch, T] on it."""
        s = self.stream
        layout = s.final_layout
        out_ch = layout.channels

        if s.scheme == ElementType.CHANNEL_BASED:
            in_ch = len(LAYOUT_CHANNELS_RENDER[s.selected_layout])
            xin = x[:in_ch]
            if (
                layout.type == LayoutType.BINAURAL
                and self.headphones_rendering_mode == 1
            ):
                # M2B: HRTF convolution of the channel bed (replaces BEAR;
                # reference default compiles this out and falls to M2M)
                if self.hrtf is None:
                    self.hrtf = HRTFRenderer(s.selected_layout, frame_size,
                                             device=self.device)
                return self.hrtf.render(xin)
            if self.downmixer is not None:
                # offset-split: delayed samples use previous demix weights
                # (iamf_stream_render :2574-2583)
                dm = self.downmixer
                prev_mode, prev_w = dm.mode, dm.w_idx
                if s.dmx_mode > -1:
                    dm.set_mode_weight(s.dmx_mode, -1)
                off = min(self.offset, frame_size)
                if off > 0:
                    y0 = downmix_apply(
                        xin[:, :off], dm.in_layout, dm.out_layout,
                        prev_mode, prev_w,
                    )
                    y1 = downmix_apply(
                        xin[:, off:], dm.in_layout, dm.out_layout,
                        dm.mode, dm.w_idx,
                    )
                    return torch.cat([y0, y1], dim=1)
                return downmix_apply(xin, dm.in_layout, dm.out_layout,
                                     dm.mode, dm.w_idx)
            # M2M static matrix
            if s.nb_channels == 1:
                in_id = rdr.LAYER_IDS[ChannelLayout.MONO]
            else:
                in_id = rdr.LAYER_IDS[s.selected_layout]
            mat = self._mat(("m2m", in_id), lambda: rdr.m2m_matrix(
                in_id, layout.render_id, layout.samsung_tv))
            return _accumulate_render(mat, xin)
        else:
            order = rdr.hoa_order_for_channels(x.shape[0])
            if order < 0:
                raise ValueError(f"bad ambisonics channel count {x.shape[0]}")
            if (
                layout.type == LayoutType.BINAURAL
                and self.headphones_rendering_mode == 1
            ):
                # H2B: HOA -> 7.1.2 virtual speaker bed -> HRTF convolution
                # (replaces Resonance)
                virt = self._mat(("h2b", order), lambda: rdr.h2m_full_matrix(
                    order, 0x712, 10, layout.samsung_tv))
                bed = torch.matmul(virt, x)
                if self.hrtf is None:
                    self.hrtf = HRTFRenderer(ChannelLayout.L712, frame_size,
                                             device=self.device)
                return self.hrtf.render(bed)
            full_t = self._mat(("h2m", order), lambda: rdr.h2m_full_matrix(
                order, layout.render_id, out_ch, layout.samsung_tv).T)
            out = _accumulate_render(full_t, x)
            if self.lfe_hoa:
                # LFE synthesis branch (h2m_rdr.c:1152-1190, the
                # DISABLE_LFE_HOA=0 build): the LFE slot(s) get the
                # 120 Hz-low-passed W channel, scaled by 0.5 (n_size<=2)
                # or 1/sqrt(n_size); one filter update per sample, lfe2
                # copying lfe1. The biquad runs on the host.
                mat, _, lfe1, lfe2 = rdr.h2m_matrix(
                    order, layout.render_id, layout.samsung_tv)
                if lfe1 >= 0 or lfe2 >= 0:
                    if self.lfe_filter is None:
                        self.lfe_filter = rdr.LFEFilter(
                            120.0, s.sampling_rate)
                    n_size = mat.shape[0]
                    y = self.lfe_filter.process(
                        x[0].cpu().numpy().astype(np.float32, copy=False))
                    if n_size <= 2:
                        sig = (np.float64(0.5) * y).astype(np.float32)
                    else:
                        sig = (y.astype(np.float64)
                               / np.sqrt(np.float64(n_size))
                               ).astype(np.float32)
                    sig = to_device(sig, self.device)
                    if 0 <= lfe1 < out_ch:
                        out[lfe1] = sig
                    if 0 <= lfe2 < out_ch:
                        out[lfe2] = sig
            return out
