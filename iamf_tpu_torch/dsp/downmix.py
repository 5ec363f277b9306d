"""Channel-layout downmix renderer (DMRenderer equivalent; counterpart of
iamf_tpu/dsp/downmix.py): the matrix and the mode/w state machine are
copied (the batched decode applies the matrix in core/pipeline.py), and
``downmix_apply`` evaluates the graph on tensors for the frame-serial
decoder (core/stream.py).

The reference computes each missing output channel per-sample via a recursive
dependency graph (downmix_renderer.c:47-129). That graph is data-independent:
for a fixed (input layout, output layout, demix mode, w index) it flattens to
a constant [out_ch, in_ch] gain matrix, precomputed here on the host, so the
render step is a single matrix product.

Dependency rules (downmix_renderer.c:65-75, factors from the demix parameter):
    MONO = 0.5*L2 + 0.5*R2
    L2   = L3 + 0.707*C          R2 = R3 + 0.707*C
    L3   = L5 + delta*SL5        R3 = R5 + delta*SR5
    SL5  = alpha*SL7 + beta*BL7  SR5 = alpha*SR7 + beta*BR7
    TL   = HL + gamma*w*SL5      TR = HR + gamma*w*SR5
    HL   = HFL + gamma*HBL       HR = HFR + gamma*HBR
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import (
    CH,
    DEMIX_FACTORS,
    ChannelLayout,
    LAYOUT_CATEGORY_COUNT,
    LAYOUT_CHANNELS_RENDER,
    get_w,
    valid_demix_mode,
)


def valid_downmix(in_layout: ChannelLayout, out_layout: ChannelLayout) -> bool:
    """Downmix validity: surround/top counts cannot grow, and a layout with
    tops cannot target a top-less layout unless it has none
    (downmix_renderer.c:81-91)."""
    s1, _, t1 = LAYOUT_CATEGORY_COUNT[in_layout]
    s2, _, t2 = LAYOUT_CATEGORY_COUNT[out_layout]
    if t1 and not t2:
        return False
    return not (s1 < s2 or t1 < t2)


def can_downmix(in_layout: ChannelLayout, out_layout: ChannelLayout) -> bool:
    if in_layout == out_layout:
        return False
    if ChannelLayout.BINAURAL in (in_layout, out_layout):
        return False
    return valid_downmix(in_layout, out_layout)


def _dep_graph(alpha: float, beta: float, gamma: float, delta: float, w: float):
    return {
        CH.MONO: ((CH.R2, 0.5), (CH.L2, 0.5)),
        CH.L2: ((CH.L3, 1.0), (CH.C, 0.707)),
        CH.R2: ((CH.R3, 1.0), (CH.C, 0.707)),
        CH.TL: ((CH.HL, 1.0), (CH.SL5, gamma * w)),
        CH.TR: ((CH.HR, 1.0), (CH.SR5, gamma * w)),
        CH.L3: ((CH.L7, 1.0), (CH.SL5, delta)),  # L5 == L7
        CH.R3: ((CH.R7, 1.0), (CH.SR5, delta)),
        CH.SL5: ((CH.SL7, alpha), (CH.BL7, beta)),
        CH.SR5: ((CH.SR7, alpha), (CH.BR7, beta)),
        CH.HL: ((CH.HFL, 1.0), (CH.HBL, gamma)),
        CH.HR: ((CH.HFR, 1.0), (CH.HBR, gamma)),
    }


@functools.lru_cache(maxsize=None)
def downmix_matrix(
    in_layout: ChannelLayout,
    out_layout: ChannelLayout,
    mode: int,
    w_idx: int,
) -> np.ndarray:
    """[out_ch, in_ch] float32 downmix matrix for the given demix mode/w.

    Channels are in *rendering* order on both sides (ia_channel_layout_get_
    channels order, as DMRenderer uses chs_in/chs_out from that table).
    """
    if not valid_demix_mode(mode):
        raise ValueError(f"invalid demix mode {mode}")
    alpha, beta, gamma, delta, _ = DEMIX_FACTORS[mode]
    deps = _dep_graph(alpha, beta, gamma, delta, get_w(w_idx))

    chs_in = LAYOUT_CHANNELS_RENDER[in_layout]
    chs_out = LAYOUT_CHANNELS_RENDER[out_layout]
    index_in = {ch: i for i, ch in enumerate(chs_in)}

    n_in = len(chs_in)

    memo: dict = {}

    def resolve(ch) -> np.ndarray:
        if ch in index_in:
            v = np.zeros(n_in, dtype=np.float64)
            v[index_in[ch]] = 1.0
            return v
        if ch in memo:
            return memo[ch]
        if ch not in deps:
            return np.zeros(n_in, dtype=np.float64)
        v = np.zeros(n_in, dtype=np.float64)
        for dep_ch, scale in deps[ch]:
            v = v + scale * resolve(dep_ch)
        memo[ch] = v
        return v

    mat = np.stack([resolve(ch) for ch in chs_out])
    return mat.astype(np.float32)


def downmix_apply(
    x,  # [in_ch, T] float32 tensor, rendering order of in_layout
    in_layout: ChannelLayout,
    out_layout: ChannelLayout,
    mode: int,
    w_idx: int,
):
    """Evaluate the downmix dependency graph with the reference's float32
    rounding order (_downmix_channel_data, downmix_renderer.c:115-129
    computes `sum += child * scale` per node in float): one multiply and
    one add per edge, each its own operation (no fused multiply-add, no
    matrix fold), on x's device. Returns [out_ch, T]."""
    alpha, beta, gamma, delta, _ = DEMIX_FACTORS[mode]
    w = get_w(max(0, w_idx))
    f = np.float32
    gw = f(f(gamma) * f(w))
    deps = {
        CH.MONO: ((CH.R2, f(0.5)), (CH.L2, f(0.5))),
        CH.L2: ((CH.L3, f(1.0)), (CH.C, f(0.707))),
        CH.R2: ((CH.R3, f(1.0)), (CH.C, f(0.707))),
        CH.TL: ((CH.HL, f(1.0)), (CH.SL5, gw)),
        CH.TR: ((CH.HR, f(1.0)), (CH.SR5, gw)),
        CH.L3: ((CH.L7, f(1.0)), (CH.SL5, f(delta))),
        CH.R3: ((CH.R7, f(1.0)), (CH.SR5, f(delta))),
        CH.SL5: ((CH.SL7, f(alpha)), (CH.BL7, f(beta))),
        CH.SR5: ((CH.SR7, f(alpha)), (CH.BR7, f(beta))),
        CH.HL: ((CH.HFL, f(1.0)), (CH.HBL, f(gamma))),
        CH.HR: ((CH.HFR, f(1.0)), (CH.HBR, f(gamma))),
    }
    chs_in = LAYOUT_CHANNELS_RENDER[in_layout]
    chs_out = LAYOUT_CHANNELS_RENDER[out_layout]
    data = {c: x[i] for i, c in enumerate(chs_in)}
    memo: dict = {}
    T = x.shape[1]

    def resolve(c):
        if c in data:
            return data[c]
        if c in memo:
            return memo[c]
        if c not in deps:
            return x.new_zeros(T)
        acc = None
        for dep_ch, scale in deps[c]:
            # a float32 scalar multiplies a float32 tensor in float32
            term = resolve(dep_ch) * float(scale)
            acc = term if acc is None else acc + term
        memo[c] = acc
        return acc

    return torch.stack([resolve(c) for c in chs_out])


class DownmixerState:
    """Host-side mode/w state machine mirroring DMRenderer_set_mode_weight
    (downmix_renderer.c:180-216)."""

    def __init__(self, in_layout: ChannelLayout, out_layout: ChannelLayout):
        self.in_layout = in_layout
        self.out_layout = out_layout
        self.mode = -1
        self.w_idx = -1

    def set_mode_weight(self, mode: int, w_idx: int = -1) -> None:
        if not valid_demix_mode(mode):
            return
        self.mode = mode
        if not (0 <= w_idx <= 10):
            # walk the w index by the mode's offset
            offset = DEMIX_FACTORS[mode][4]
            if offset > 0:
                self.w_idx = min(self.w_idx + 1, 10)
            else:
                self.w_idx = max(self.w_idx - 1, 0)
        else:
            self.w_idx = w_idx

    def matrix(self) -> np.ndarray:
        return downmix_matrix(
            self.in_layout, self.out_layout, self.mode, max(0, self.w_idx)
        )
