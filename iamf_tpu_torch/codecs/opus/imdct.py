"""K1: the CELT-960 synthesis filterbank (IMDCT + TDAC overlap + short-block
interleave) as folded constant products.

Counterpart of iamf_tpu/codecs/opus/pallas_imdct.py (the reference's one
Pallas kernel, ``fused_imdct_overlap``). Every output sample of a frame is
linear in (spectrum, previous frame's raw 60-sample MDCT tail), so

    y      = freq @ A_mode.T + tail_in @ C_mode.T      (mode = long | short)
    tail'  = freq @ D_mode.T

with A [960, 960], C [960, 60], D [60, 960] built once in float64 and
rounded to float32 (``fused_mats``). On a CUDA tensor the hand-written
kernel csrc/imdct.cu runs (design and bound in its source note): one
split-TF32 tensor-core product per mode with W = [A | D | 0]
(``product_mats``, columns in ``k_order``, stored split by
``split_tf32``), then C, which has 120 nonzeros, as an epilogue. On a CPU tensor the plain twin ``imdct_overlap_plain`` runs the
folded formula with ``torch.matmul``. The folded constants differ from the
reference's jnp path (window applied after the matmul) by < 2e-2 at s16
scale; the tests hold both to the 0.25 bound of tests/test_opus_pallas.py.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ...kernels.build import I, Kernel, P

FRAME = 960
OVER = 60  # TDAC mirror half-overlap (celt overlap 120, mirror mixes 60)
NOUT = 1024  # K1's product columns: 960 samples, 60 tail, 4 zero

_TABLES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "data", "opus_tables.npz")

K1 = Kernel("iamf_k1_imdct", [P, I, P, P, I, I] + [P] * 5 + [P] * 4)


@functools.lru_cache(maxsize=None)
def window120() -> np.ndarray:
    """The 120-tap CELT overlap window, float32."""
    return np.asarray(np.load(_TABLES)["window120"], np.float32)


def _basis64(n2: int) -> np.ndarray:
    """IMDCT basis in float64: t[m] = sum_k X[k] cos(2pi/N (m+N/2+.5)(k+.5))."""
    n = 2 * n2
    m = np.arange(n2)[:, None].astype(np.float64)
    k = np.arange(n2)[None, :].astype(np.float64)
    return np.cos(2.0 * np.pi / n * (m + n / 2.0 + 0.5) * (k + 0.5))


@functools.lru_cache(maxsize=None)
def fused_mats():
    """(A_long, A_short, C_long, C_short, D_long, D_short), float32,
    transposed for ``x @ M`` (contraction dim first): A [960, 960],
    C [60, 960], D [960, 60]. A copy of pallas_imdct._fused_mats in numpy
    float64 (bit-equal; tests/test_torch_imdct.py checks it)."""
    w = np.asarray(window120(), np.float64)
    bl = _basis64(FRAME)   # [m, k] long raw IMDCT
    b120 = _basis64(120)
    # combined short basis: block j holds freq[j::8] (stride-8 interleave)
    bs = np.zeros((FRAME, FRAME), np.float64)
    for j in range(8):
        bs[j * 120:(j + 1) * 120, j::8] = b120

    i = np.arange(OVER)
    wl = w[119 - i]  # mirror window, left half
    wr = w[i]

    a_l = np.zeros((FRAME, FRAME), np.float64)
    c_l = np.zeros((FRAME, OVER), np.float64)
    # y[i]    = wl[i]*tail[i]        - wr[i]*t[59-i]
    a_l[i] = -wr[:, None] * bl[59 - i]
    c_l[i, i] = wl
    # y[60+i] = wl[59-i]*t[i]        + wr[59-i]*tail[59-i]
    a_l[60 + i] = wl[59 - i][:, None] * bl[i]
    c_l[60 + i, 59 - i] = wr[59 - i]
    # y[120:] = t[60:900]
    a_l[120 + np.arange(840)] = bl[60:900]
    d_l = bl[900:960]

    a_s = np.zeros((FRAME, FRAME), np.float64)
    c_s = np.zeros((FRAME, OVER), np.float64)
    for j in range(8):
        pj = bs[(j - 1) * 120 + 60:(j - 1) * 120 + 120] if j else None
        r0 = j * 120 + i
        a_s[r0] = -wr[:, None] * bs[j * 120 + 59 - i]
        if j:
            a_s[r0] += wl[:, None] * pj[i]
        else:
            c_s[r0, i] = wl
        r1 = j * 120 + 60 + i
        a_s[r1] = wl[59 - i][:, None] * bs[j * 120 + i]
        if j:
            a_s[r1] += wr[59 - i][:, None] * pj[59 - i]
        else:
            c_s[r1, 59 - i] = wr[59 - i]
    d_s = bs[7 * 120 + 60:7 * 120 + 120]

    def t32(m):
        return np.ascontiguousarray(m.T).astype(np.float32)

    return (t32(a_l), t32(a_s), t32(c_l), t32(c_s), t32(d_l), t32(d_s))


def k_order(k: int = FRAME) -> np.ndarray:
    """The contraction order of K1's product (and K7's, k = 1024): slot q
    of each 32-deep k-step holds spectrum offset p(q) of the step. With
    q = 8 kk + 4 h + t (8-deep slice kk, TF32 wgmma A-fragment column
    t + 4 h), p = 8 t + 2 kk + h puts each thread's 8 values of a step next
    to each other in shared memory."""
    q = np.arange(32)
    kk, h, t = q // 8, (q // 4) % 2, q % 4
    p = 8 * t + 2 * kk + h
    return (np.arange(0, k, 32)[:, None] + p).reshape(-1)


def product_mats():
    """K1's product matrices (W_long, W_short), float32 [1024, 960]:
    W = [A | D | 0], rows 0..959 the output samples, 960..1019 the new raw
    tail, 4 zero rows; K-major as TF32 wgmma takes its B operand, columns
    in ``k_order()``."""
    atl, ats, _, _, dtl, dts = fused_mats()
    pad = np.zeros((NOUT - FRAME - OVER, FRAME), np.float32)
    order = k_order()
    return tuple(
        np.ascontiguousarray(np.concatenate([a.T, d.T, pad])[:, order])
        for a, d in ((atl, dtl), (ats, dts)))


def split_tf32(x: np.ndarray):
    """(hi, lo), float32 with the low 13 mantissa bits zero: hi = x rounded
    to TF32, lo = (x - hi) rounded to TF32, both to nearest with ties away
    from zero, as cvt.rna.tf32.f32 rounds. hi + lo is within 2^-22 of x."""
    def rna(v):
        b = np.ascontiguousarray(v, np.float32).view(np.uint32)
        return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
            np.float32)

    hi = rna(x)
    return hi, rna(x - hi)


@functools.lru_cache(maxsize=None)
def _split_product_mats():
    return tuple(split_tf32(w) for w in product_mats())


class FusedMats(torch.nn.Module):
    """The folded constants as buffers, moved with ``.to(device)``: the six
    matrices of the plain twin (atl .. dts), K1's product matrices split in
    TF32 (w_long_hi, w_long_lo, w_short_hi, w_short_lo) and the window."""

    def __init__(self):
        super().__init__()
        for name, m in zip(("atl", "ats", "ctl", "cts", "dtl", "dts"),
                           fused_mats()):
            self.register_buffer(name, torch.from_numpy(m.copy()))
        for mode, (hi, lo) in zip(("long", "short"), _split_product_mats()):
            self.register_buffer(f"w_{mode}_hi", torch.from_numpy(hi.copy()))
            self.register_buffer(f"w_{mode}_lo", torch.from_numpy(lo.copy()))
        self.register_buffer("window", torch.from_numpy(window120().copy()))


def _tail_in(tails, tail0):
    """Incoming tail per frame: tail0 for frame 0, frame b-1's otherwise."""
    return torch.cat([tail0[None], tails[:-1]], dim=0)


def imdct_overlap_plain(mats: FusedMats, freq, transient, tail0):
    """Plain twin of K1: the folded formula with torch.matmul, both modes
    computed and selected per lane as the reference kernel does."""
    K1.note_plain(freq)
    trans = transient[..., None]
    tails = torch.where(trans, freq @ mats.dts, freq @ mats.dtl)
    tin = _tail_in(tails, tail0)
    y_l = freq @ mats.atl + tin @ mats.ctl
    y_s = freq @ mats.ats + tin @ mats.cts
    return torch.where(trans, y_s, y_l), tails[-1]


def imdct_overlap_cuda(mats: FusedMats, freq, transient, tail0):
    """K1 on the card. freq [B, L, 960] may be a view into the packed
    [B, L, 973] buffer (unit last stride, rows ld apart)."""
    B, L, n = freq.shape
    if n != FRAME or tail0.shape != (L, OVER) or transient.shape != (B, L):
        raise ValueError(
            f"K1 takes freq [B, L, {FRAME}], transient [B, L], tail0 "
            f"[L, {OVER}]; got {list(freq.shape)}, {list(transient.shape)}, "
            f"{list(tail0.shape)}")
    if freq.dtype != torch.float32 or tail0.dtype != torch.float32:
        raise TypeError("K1 takes float32 spectra and tail")
    ld = freq.stride(1)
    if freq.stride(2) != 1 or freq.stride(0) != L * ld:
        freq = freq.contiguous()
        ld = FRAME
    trans = transient.to(torch.uint8).contiguous()
    tail0 = tail0.contiguous()
    dev = freq.device
    R = B * L
    y = torch.empty((B, L, FRAME), dtype=torch.float32, device=dev)
    tails = torch.empty((R, OVER), dtype=torch.float32, device=dev)
    lists = torch.empty((2 * R,), dtype=torch.int32, device=dev)
    counts = torch.empty((2,), dtype=torch.int32, device=dev)
    K1(freq, ld, trans, tail0, B, L, mats.w_long_hi, mats.w_long_lo,
       mats.w_short_hi, mats.w_short_lo, mats.window, y, tails, lists, counts)
    return y, tails[(B - 1) * L:]


def imdct_overlap(mats: FusedMats, freq, transient, tail0):
    """(y [B, L, 960], tail [L, 60]) from spectra freq [B, L, 960],
    transient [B, L] bool and the previous batch's tail0 [L, 60].
    CUDA tensors run K1; CPU tensors run the plain twin."""
    if freq.is_cuda:
        return imdct_overlap_cuda(mats, freq, transient, tail0)
    return imdct_overlap_plain(mats, freq, transient, tail0)
