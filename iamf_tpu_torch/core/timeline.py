"""Host-side parameter-timeline replay (a copy of iamf_tpu/core/timeline.py
with its imports redirected: the reference module imports dsp/demix.py and
core/stream.py, which import JAX).

The reference evaluates parameter curves inside its frame loop: mix-gain
step/linear/bezier curves (IAMF_decoder.c:639-664, :857-982), demix-mode
updates + the w-index walk (demixer.c:592-619, applied per frame at
iamf_stream_scale_decoder_decode :2276-2349 and per render at
DMRenderer_set_mode_weight downmix_renderer.c:180-216), and recon-gain
EMA smoothing (dmx_rms demixer.c:443-475). All of these are tiny scalar
state machines with strictly sequential per-frame recurrences — exactly
the wrong shape for a TPU but trivial for the host.

`replay` walks the stream's OBU event list (parameter blocks interleaved
with temporal units) once, in arrival order, mirroring the frame-serial
decoder's bookkeeping (api.IAMFDecoder._parse_obus + _decode_frame), and
emits dense per-frame parameter tensors in the scalar layout
core.pipeline.decode_frames consumes: factor pairs [N, 2, 5], recon EMA
triples [N, n_rg, 3], render-matrix indices [N, 2] into a table of the
distinct downmix matrices the stream visits, and gain curves ([N] scalar
per frame, widening to [N, T] only when a curve animates within a frame).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..constants import ElementType, ParameterType, q08_to_float
from ..dsp.demix import DemixerState
from ..dsp.downmix import DownmixerState, downmix_matrix
from ..obu import parser
from .database import Database, MixGainUnit
from .stream import recon_channels_from_flags, recon_gain_flags_default


@dataclasses.dataclass
class ElementParams:
    """Per-frame parameter tensors for one element (N = total frames)."""

    factors: np.ndarray  # [N, 2, 5] float32 (prev/cur x a,b,g,d,dw)
    rg: np.ndarray  # [N, n_rg, 3] float32 (last_sfavg, sfavg, active)
    rg_index: tuple[int, ...]  # static smoothed output-channel indices
    mats: np.ndarray  # [M, out, n_rendered] float32 distinct matrices
    mat_idx: np.ndarray  # [N, 2] int32 (prev, cur) into mats
    gain: np.ndarray  # [N] or [N, T] float32 linear element mix gain
    gain_per_sample: bool


@dataclasses.dataclass
class TimelineParams:
    elements: list[ElementParams]
    out_gain: np.ndarray  # [N] or [N, T]
    out_gain_per_sample: bool


class _GainTrack:
    """Accumulates one mix-gain curve as scalars, widening to per-sample
    vectors only if any frame animates within the frame."""

    def __init__(self, n: int, frame_size: int):
        self.scalars = np.ones(n, np.float32)
        self.vectors: dict[int, np.ndarray] = {}
        self.T = frame_size

    def set(self, u: int, unit: MixGainUnit) -> None:
        if unit.gains is not None:
            v = np.ones(self.T, np.float32)
            m = min(len(unit.gains), self.T)
            v[:m] = unit.gains[:m]
            if m < self.T:
                v[m:] = v[m - 1]
            self.vectors[u] = v
        elif unit.constant_gain != 1.0 and unit.constant_gain > 0.0:
            # matches _apply_gain / the reference's <=0 guard
            self.scalars[u] = unit.constant_gain
        # else: leave at 1.0 (no gain applied)

    def scale(self, g: float) -> None:
        if g == 1.0:
            return
        self.scalars *= np.float32(g)
        for v in self.vectors.values():
            v *= np.float32(g)

    def finalize(self) -> tuple[np.ndarray, bool]:
        if not self.vectors:
            return self.scalars, False
        out = np.broadcast_to(
            self.scalars[:, None], (len(self.scalars), self.T)
        ).copy()
        for u, v in self.vectors.items():
            out[u] = v
        return out, True


class _ElemReplay:
    """Mirrors one element's StreamDecoder/StreamRenderer parameter state
    (core/stream.py) through the timeline."""

    def __init__(self, ctx, econf, db: Database, n: int, frame_size: int,
                 rate: int):
        self.ctx = ctx
        self.element_id = ctx.stream.element_id
        self.item = db.elements[self.element_id]
        self.frame_size = frame_size
        self.rate = rate
        self.timestamp = 0
        self.dmx_mode = -1
        self.delay = int(getattr(ctx.codec, "delay", 0) or 0)

        s = ctx.stream
        self.demixer: Optional[DemixerState] = None
        if ctx.demix_spec is not None:
            self.demixer = DemixerState(ctx.demix_spec)
            if s.dmx_default_mode >= 0:
                self.demixer.set_demixing_info(
                    s.dmx_default_mode, s.dmx_default_w_idx)
            if self.delay:
                self.demixer.set_frame_offset(self.delay)
            # default recon gains of the selected layer
            # (iamf_stream_scale_decoder_set_default_recon_gain :2209-2247)
            if s.layer > 0:
                flags = recon_gain_flags_default(
                    s.layers[0].layout, s.selected_layout)
                chs = recon_channels_from_flags(s.selected_layout, flags)
                self.demixer.set_recon_gain(chs, [1.0] * len(chs), flags)
            else:
                self.demixer.set_recon_gain([], [], 0)

        # render matrix table: downmix-rendered elements walk (mode, w)
        self.downmixer: Optional[DownmixerState] = None
        if ctx.downmix is not None:
            self.downmixer = ctx.downmix
        base = np.asarray(ctx.render_mat, np.float32)
        self.mats: list[np.ndarray] = [base]
        self.mat_keys: dict = {None: 0}
        self.mat_idx = np.zeros((n, 2), np.int32)
        self.factors = np.ones((n, 2, 5), np.float32)
        self.rg_rows: list[list[tuple[int, float, float]]] = []
        self.gain = _GainTrack(n, frame_size)

    def _mat_index(self, mode: int, w_idx: int) -> int:
        key = (mode, max(0, w_idx))
        i = self.mat_keys.get(key)
        if i is None:
            i = len(self.mats)
            self.mats.append(downmix_matrix(
                self.downmixer.in_layout, self.downmixer.out_layout,
                mode, max(0, w_idx)))
            self.mat_keys[key] = i
        return i

    def on_parameter(self, db: Database, pid: int) -> None:
        """iamf_stream_decoder_update_parameter (IAMF_decoder.c:2133-2152)."""
        pi = db.parameters.get(pid)
        if pi is None:
            return
        pts = self.timestamp + self.frame_size // 2
        if pi.type == ParameterType.DEMIXING:
            self.dmx_mode = db.get_demix_mode(pid, pts)
        elif pi.type == ParameterType.RECON_GAIN and self.demixer is not None:
            seg = db.get_recon_gain(pid, pts)
            if seg is not None:
                self._update_recon_gain(seg)

    def _update_recon_gain(self, seg) -> None:
        """iamf_stream_scale_decoder_update_recon_gain (:2249-2274)."""
        s = self.ctx.stream
        for i in range(min(len(seg.entries), s.layer + 1)):
            entry = seg.entries[i]
            if entry is None or not s.layers[i].recon_gain:
                continue
            if i == s.layer:
                chs = recon_channels_from_flags(s.selected_layout, entry.flags)
                gains = [q08_to_float(g) for g in entry.gains_q08]
                self.demixer.set_recon_gain(chs, gains, entry.flags)

    def close_unit(self, u: int) -> int:
        """Per-frame parameter evaluation at decode time; returns f_pts."""
        if self.demixer is not None:
            if self.dmx_mode > -1:
                # iamf_stream_scale_decoder_decode :2276 applies the last
                # prepared mode every frame (the w walk advances per frame)
                self.demixer.set_demixing_info(self.dmx_mode, -1)
            last5, cur5, rg = self.demixer.frame_params_scalars()
            self.factors[u, 0] = last5
            self.factors[u, 1] = cur5
            self.rg_rows.append(rg)
        if self.downmixer is not None:
            dm = self.downmixer
            prev = self._mat_index(dm.mode, dm.w_idx)
            if self.dmx_mode > -1:
                dm.set_mode_weight(self.dmx_mode, -1)
            self.mat_idx[u] = (prev, self._mat_index(dm.mode, dm.w_idx))

        f_pts = self.timestamp - (self.delay if self.delay > 0 else 0)
        if self.item.mix_gain is not None:
            unit = self.item.mix_gain.get_mix_gain_unit(
                f_pts, self.frame_size, self.rate)
            self.gain.set(u, unit)
        self.timestamp += self.frame_size
        return f_pts

    def finalize(self, n: int) -> ElementParams:
        # recon rows: union of smoothed channels over the stream; inactive
        # frames pass through via the mask column
        rg_union: list[int] = []
        for rows in self.rg_rows:
            for idx, _, _ in rows:
                if idx not in rg_union:
                    rg_union.append(idx)
        rg_union.sort()
        pos = {c: i for i, c in enumerate(rg_union)}
        rg = np.zeros((n, len(rg_union), 3), np.float32)
        rg[:, :, 0:2] = 1.0
        for u, rows in enumerate(self.rg_rows):
            for idx, last, cur in rows:
                rg[u, pos[idx]] = (last, cur, 1.0)
        if not self.rg_rows:
            rg = np.zeros((n, 0, 3), np.float32)
            rg_union = []

        gain, per_sample = self.gain.finalize()
        return ElementParams(
            factors=self.factors,
            rg=rg,
            rg_index=tuple(rg_union),
            mats=np.stack(self.mats),
            mat_idx=self.mat_idx,
            gain=gain,
            gain_per_sample=per_sample,
        )


def replay(db: Database, elems, econfs, sub, events, n_frames: int,
           frame_size: int, rate: int, out_gain_default: float,
           norm_gain: float) -> TimelineParams:
    """Replay the OBU timeline and evaluate all parameter curves.

    elems:  batch decoder element contexts (stream/demix_spec/render_mat/
            downmix/codec/gain attributes)
    econfs: the sub-mix's element configs (mix gain param bases)
    events: ordered list of ("param", OBU) and ("unit", strim, etrim)
    """
    # register mix-gain parameter items (iamf_decoder_enable_mix_presentation
    # :3113: element mix gains + the output mix gain)
    states = []
    for ctx, econf in zip(elems, econfs):
        pi = db.add_parameter_definition(econf.element_mix_gain.base, -1, rate)
        pi.default_mix_gain = ctx.gain
        db.elements[ctx.stream.element_id].mix_gain = pi
        states.append(_ElemReplay(ctx, econf, db, n_frames, frame_size, rate))
    out_pi = db.add_parameter_definition(sub.output_mix_gain.base, -1, rate)
    out_pi.default_mix_gain = out_gain_default
    out_track = _GainTrack(n_frames, frame_size)

    u = 0
    for ev in events:
        if ev[0] == "param":
            obu = ev[1]
            pid = parser.peek_parameter_block_id(obu)
            pi = db.parameters.get(pid)
            if pi is None:
                continue
            elem = db.element_by_parameter(pid)
            nb_layers = 0
            rg_flags = 0
            if (elem is not None
                    and elem.element_type == ElementType.CHANNEL_BASED
                    and elem.channels_config is not None):
                nb_layers = elem.channels_config.nb_layers
                for i, layer in enumerate(elem.channels_config.layers):
                    if layer.recon_gain_flag:
                        rg_flags |= 1 << i
            block = parser.parse_parameter_block(obu, pi.base, nb_layers,
                                                 rg_flags)
            db.add_parameter_block(block, obu.redundant)
            if elem is not None:
                for es in states:
                    if es.element_id == elem.element_id:
                        es.on_parameter(db, pid)
        else:  # ("unit", strim, etrim)
            if u >= n_frames:
                break
            strim, etrim = ev[1], ev[2]
            first_pts = None
            for es in states:
                f_pts = es.close_unit(u)
                if first_pts is None:
                    first_pts = f_pts
            out_unit = out_pi.get_mix_gain_unit(
                first_pts, frame_size, rate)
            out_track.set(u, out_unit)
            # iamf_database_parameters_time_elapse :3471 advances by the
            # first stream's post-trim sample count
            samples = max(frame_size - strim - etrim, 0)
            db.parameters_time_elapse(samples, rate)
            u += 1

    out_track.scale(norm_gain)
    out_gain, out_ps = out_track.finalize()
    return TimelineParams(
        elements=[es.finalize(n_frames) for es in states],
        out_gain=out_gain,
        out_gain_per_sample=out_ps,
    )
