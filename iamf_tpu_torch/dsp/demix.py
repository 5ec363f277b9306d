"""Scalable-channel demixer (counterpart of iamf_tpu/dsp/demix.py;
reference: demixer.c).

- Device (``demix_frame``): the de-mixing chains S1->2, S2->3, S3->5,
  S5->7, TF2->T2, T2->T4 (demixer.c:124-378) as elementwise PyTorch ops,
  batched over the frame axis, with per-sample factor vectors for the
  demix-mode smoothing, output-gain-up (:421-430) and the recon-gain RMS
  equalization (:443-475). Plain PyTorch; the same order of operations as
  the reference's jnp version, so results agree bit for bit.
- Host (``DemixerState``, ``DemixSpec``, ``make_windows``): a copy of the
  reference's scalar state machines (the reference module imports JAX at
  module level).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..constants import (
    CH,
    DEMIX_FACTORS,
    ChannelLayout,
    LAYOUT_CHANNELS_RENDER,
    MAX_W_IDX,
    MIN_W_IDX,
    get_w,
    valid_demix_mode,
)

N_EMA_FRAMES = 7.0  # dmx_rms: N=7 frame EMA (demixer.c:444)


def make_windows(frame_size: int, frame_offset: int) -> tuple[np.ndarray, np.ndarray]:
    """start/stop hanning overlap windows (demixer_open :529-535 +
    demixer_set_frame_offset :537-563)."""
    window_len = frame_size // 8
    overlap = window_len // 2
    i = np.arange(window_len, dtype=np.float64)
    hanning = 0.5 * (1.0 - np.cos(2.0 * np.pi * i / (window_len - 1)))

    start = np.ones(frame_size, dtype=np.float32)
    stop = np.zeros(frame_size, dtype=np.float32)
    preskip = frame_offset % frame_size
    if preskip + overlap <= frame_size:
        start[:preskip] = 0.0
        stop[:preskip] = 1.0
        start[preskip : preskip + overlap] = hanning[:overlap]
        stop[preskip : preskip + overlap] = hanning[overlap : 2 * overlap]
        start[preskip + overlap :] = 1.0
        stop[preskip + overlap :] = 0.0
    return start, stop


@dataclasses.dataclass(frozen=True)
class DemixSpec:
    """Static (trace-time) description of one scalable-channel stream."""

    layout: ChannelLayout  # target layout (highest selected layer)
    channels_in: tuple[int, ...]  # decoded channel ids in codec order
    frame_size: int
    # per-input-channel linear output gain ("gain-up", demixer.c:421-430)
    output_gains: tuple[float, ...]  # len == len(channels_in), 1.0 = none

    @property
    def channels_out(self) -> tuple[int, ...]:
        return tuple(LAYOUT_CHANNELS_RENDER[self.layout])


def demix_frame(
    x,  # [B, C_in, T] float32 planar, codec channel order
    spec: DemixSpec,
    factors_t,  # dict of [B, T] (or broadcastable) tensors: alpha..dw
    rg_index,  # output-channel indices to smooth (static)
    rg_filt,  # [B, n_rg, T] smoothing filters, or None
):
    """Demix a batch of frames. Returns [B, C_out, T] in rendering order.

    The reference chains are demand-driven (dmx_channel demixer.c:380-419);
    the demand set is static, so exactly the chains needed are evaluated.
    """
    B, _, T = x.shape
    ch: dict[int, object] = {}
    for i, c in enumerate(spec.channels_in):
        g = spec.output_gains[i]
        ch[c] = x[:, i] * g if g != 1.0 else x[:, i]

    alpha = factors_t["alpha"]
    beta = factors_t["beta"]
    gamma = factors_t["gamma"]
    delta = factors_t["delta"]
    dw = factors_t["dw"]

    def need(c) -> bool:
        return c in spec.channels_out and c not in ch

    # S1to2: R2 = 2*MONO - L2 (demixer.c:124-147)
    def ensure_r2():
        if CH.R2 not in ch:
            ch[CH.R2] = 2.0 * ch[CH.MONO] - ch[CH.L2]

    # S2to3: L3 = L2 - 0.707*C (:149-180)
    def ensure_s3():
        if CH.R3 not in ch:
            ensure_r2()
            ch[CH.L3] = ch[CH.L2] - 0.707 * ch[CH.C]
            ch[CH.R3] = ch[CH.R2] - 0.707 * ch[CH.C]

    # S3to5: SL5 = (L3 - L5)/delta (:182-228)
    def ensure_s5():
        if CH.SR5 not in ch:
            ensure_s3()
            ch[CH.SL5] = (ch[CH.L3] - ch[CH.L7]) / delta
            ch[CH.SR5] = (ch[CH.R3] - ch[CH.R7]) / delta

    # S5to7: BL7 = (SL5 - alpha*SL7)/beta (:230-281)
    def ensure_s7():
        if CH.BR7 not in ch:
            ensure_s5()
            ch[CH.BL7] = (ch[CH.SL5] - ch[CH.SL7] * alpha) / beta
            ch[CH.BR7] = (ch[CH.SR5] - ch[CH.SR7] * alpha) / beta

    # TF2toT2: HL = TL - delta*w*SL5 (:283-333)
    def ensure_h2():
        if CH.HR not in ch:
            ensure_s5()
            ch[CH.HL] = ch[CH.TL] - dw * ch[CH.SL5]
            ch[CH.HR] = ch[CH.TR] - dw * ch[CH.SR5]

    # T2toT4: HBL = (HL - HFL)/gamma (:335-378)
    def ensure_h4():
        if CH.HBR not in ch:
            ensure_h2()
            ch[CH.HBL] = (ch[CH.HL] - ch[CH.HFL]) / gamma
            ch[CH.HBR] = (ch[CH.HR] - ch[CH.HFR]) / gamma

    dispatch = {
        CH.R2: ensure_r2,
        CH.L3: ensure_s3,
        CH.R3: ensure_s3,
        CH.SL5: ensure_s5,
        CH.SR5: ensure_s5,
        CH.BL7: ensure_s7,
        CH.BR7: ensure_s7,
        CH.HL: ensure_h2,
        CH.HR: ensure_h2,
        CH.HBL: ensure_h4,
        CH.HBR: ensure_h4,
    }
    for c in spec.channels_out:
        if need(c):
            dispatch[c]()

    zero = None
    rows = []
    for c in spec.channels_out:
        if c in ch:
            rows.append(torch.broadcast_to(ch[c], (B, T)))
        else:
            if zero is None:
                zero = torch.zeros((B, T), dtype=x.dtype, device=x.device)
            rows.append(zero)
    out = torch.stack(rows, dim=1)

    # recon-gain RMS equalization (dmx_rms, demixer.c:443-475)
    if rg_filt is not None and len(rg_index):
        # a tensor of indices (the serial decoder keeps one on the device)
        # or a sequence
        idx = rg_index if torch.is_tensor(rg_index) else list(rg_index)
        out[:, idx] = out[:, idx] * rg_filt
    return out


class DemixerState:
    """Host-side demixer state (the sequential per-frame recurrences)."""

    def __init__(self, spec: DemixSpec):
        self.spec = spec
        self.frame_size = spec.frame_size
        # mode/w state machine (demixer_set_demixing_info :592-619)
        self.demixing_mode = 0
        self.last_dmixtypenum = 0
        self.weight_state_idx = 0
        self.last_weight_state_idx = 0
        # recon gain state
        self.rg_flags = 0
        self.rg_channels: list[int] = []
        self.rg_gains: list[float] = []
        self.ch_last_sfavg = {c: 1.0 for c in range(24)}
        self.ch_last_sf = {c: 1.0 for c in range(24)}
        # windows
        self.skip = 0
        self.start_window, self.stop_window = make_windows(spec.frame_size, 0)

    def set_frame_offset(self, offset: int) -> None:
        self.skip = offset % self.frame_size
        self.start_window, self.stop_window = make_windows(self.frame_size, offset)

    def set_demixing_info(self, mode: int, w_idx: int = -1) -> None:
        if not valid_demix_mode(mode):
            return
        if not (MIN_W_IDX <= w_idx <= MAX_W_IDX):
            self.last_dmixtypenum = self.demixing_mode
            self.demixing_mode = mode
            self.last_weight_state_idx = self.weight_state_idx
            offset = DEMIX_FACTORS[mode][4]
            if offset > 0:
                self.weight_state_idx = min(self.last_weight_state_idx + 1, MAX_W_IDX)
            else:
                self.weight_state_idx = max(self.last_weight_state_idx - 1, MIN_W_IDX)
        else:
            if mode != self.demixing_mode:
                self.last_dmixtypenum = self.demixing_mode = mode
            if self.weight_state_idx != w_idx:
                self.last_weight_state_idx = self.weight_state_idx = w_idx

    def set_recon_gain(
        self, channels: Sequence[int], gains: Sequence[float], flags: int
    ) -> None:
        """demixer_set_recon_gain (demixer.c:621-634)."""
        if flags and flags != self.rg_flags:
            self.rg_channels = list(channels)
            self.rg_flags = flags
        self.rg_gains = list(gains)

    def frame_params_scalars(self):
        """Scalar per-frame parameters, then advance the EMA state.

        Returns (last5, cur5, rg) where last5/cur5 are the
        (alpha, beta, gamma, delta, delta*w) factor tuples for the skip
        region / rest of the frame, and rg is a list of
        (out_channel_index, last_sfavg, sfavg) recon-gain EMA pairs. The
        batched device pipeline rebuilds the per-sample vectors from these
        plus the static skip/window constants; `frame_params` below keeps
        the dense host form for the frame-serial path."""
        cur = DEMIX_FACTORS.get(self.demixing_mode, (0, 0, 1, 1, 0))
        last = DEMIX_FACTORS.get(self.last_dmixtypenum, (0, 0, 1, 1, 0))
        w_cur = get_w(self.weight_state_idx)
        w_last = get_w(self.last_weight_state_idx)
        last5 = (
            last[0], last[1], last[2], last[3],
            float(np.float32(np.float32(last[3]) * np.float32(w_last))),
        )
        cur5 = (
            cur[0], cur[1], cur[2], cur[3],
            float(np.float32(np.float32(cur[3]) * np.float32(w_cur))),
        )

        out_index = {c: i for i, c in enumerate(self.spec.channels_out)}
        rg: list[tuple[int, float, float]] = []
        for ch_id, sf in zip(self.rg_channels, self.rg_gains):
            if ch_id not in out_index:
                continue
            sfavg = (2.0 / (N_EMA_FRAMES + 1.0)) * sf + (
                1.0 - 2.0 / (N_EMA_FRAMES + 1.0)
            ) * self.ch_last_sfavg[ch_id]
            rg.append((out_index[ch_id], self.ch_last_sfavg[ch_id], sfavg))
            self.ch_last_sf[ch_id] = sf
            self.ch_last_sfavg[ch_id] = sfavg
        return last5, cur5, rg

    def frame_params(self):
        """Per-sample factor vectors + recon filters for the current frame,
        then advance the EMA state (host-side part of dmx_rms). Numpy, as
        the reference's: the frame-serial decoder (core/stream.py) sends
        them to the device with the frame's PCM."""
        T = self.frame_size
        last5, cur5, rg = self.frame_params_scalars()

        def blend(last_v: float, cur_v: float) -> np.ndarray:
            v = np.full(T, cur_v, dtype=np.float32)
            if self.skip:
                v[: self.skip] = last_v
            return v

        factors = {
            k: blend(last5[i], cur5[i])
            for i, k in enumerate(("alpha", "beta", "gamma", "delta", "dw"))
        }

        rg_index: list[int] = []
        rg_filt_rows: list[np.ndarray] = []
        for out_idx, last_sfavg, sfavg in rg:
            filt = (
                last_sfavg * self.stop_window + sfavg * self.start_window
            ).astype(np.float32)
            rg_index.append(out_idx)
            rg_filt_rows.append(filt)

        rg_filt = np.stack(rg_filt_rows) if rg_filt_rows else None
        return factors, tuple(rg_index), rg_filt
