"""K1: the CELT synthesis filterbank (IMDCT + TDAC overlap + short-block
interleave) as folded constant products, for frames of n = 120, 240, 480 or
960 samples.

Counterpart of iamf_tpu/codecs/opus/pallas_imdct.py (the reference's one
Pallas kernel, ``fused_imdct_overlap``). Every output sample of a frame is
linear in (spectrum, previous frame's raw 60-sample MDCT tail), so

    y      = freq @ A_mode.T + tail_in @ C_mode.T      (mode = long | short)
    tail'  = freq @ D_mode.T

with A [n, n], C [n, 60], D [60, n] built once per n in float64 and
rounded to float32 (``fused_mats``). A transient frame has M = n/120 short
blocks; at n = 120, M = 1 and both modes are the long one (the reference
ignores the transient flag there). On a CUDA tensor the hand-written
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
FRAMES = (120, 240, 480, 960)  # the CELT frame sizes
OVER = 60  # TDAC mirror half-overlap (celt overlap 120, mirror mixes 60)
BK = 32  # K1's k-step: the contraction is padded to a multiple of it
NOUT = 1024  # K1's product columns at n = 960: 960 samples, 60 tail, 4 zero


def nout(n: int) -> int:
    """K1's product columns for frames of n: n samples, the 60-sample tail,
    zeros up to the 64-column tile."""
    return -(-(n + OVER) // 64) * 64


def kpad(n: int) -> int:
    """K1's contraction depth for frames of n: n rounded up to the k-step."""
    return -(-n // BK) * BK

_TABLES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "data", "opus_tables.npz")

K1 = Kernel("iamf_k1_imdct", [P, I, I, P, P, I, I] + [P] * 5 + [P] * 4)


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
def fused_mats(n: int = FRAME):
    """(A_long, A_short, C_long, C_short, D_long, D_short), float32,
    transposed for ``x @ M`` (contraction dim first): A [n, n], C [60, n],
    D [n, 60]. At n = 960 a copy of pallas_imdct._fused_mats in numpy
    float64 (bit-equal; tests/test_torch_imdct.py checks it); other n
    fold tpu_synth._imdct_overlap_jnp's M = n/120 short blocks the same
    way."""
    if n not in FRAMES:
        raise ValueError(f"CELT frames are {FRAMES} samples, not {n}")
    M = n // 120
    w = np.asarray(window120(), np.float64)
    bl = _basis64(n)   # [m, k] long raw IMDCT
    b120 = _basis64(120)
    # combined short basis: block j holds freq[j::M] (stride-M interleave)
    bs = np.zeros((n, n), np.float64)
    for j in range(M):
        bs[j * 120:(j + 1) * 120, j::M] = b120

    i = np.arange(OVER)
    wl = w[119 - i]  # mirror window, left half
    wr = w[i]

    a_l = np.zeros((n, n), np.float64)
    c_l = np.zeros((n, OVER), np.float64)
    # y[i]    = wl[i]*tail[i]        - wr[i]*t[59-i]
    a_l[i] = -wr[:, None] * bl[59 - i]
    c_l[i, i] = wl
    # y[60+i] = wl[59-i]*t[i]        + wr[59-i]*tail[59-i]
    a_l[60 + i] = wl[59 - i][:, None] * bl[i]
    c_l[60 + i, 59 - i] = wr[59 - i]
    # y[120:] = t[60:n-60]
    a_l[120 + np.arange(n - 120)] = bl[60:n - 60]
    d_l = bl[n - 60:n]

    a_s = np.zeros((n, n), np.float64)
    c_s = np.zeros((n, OVER), np.float64)
    for j in range(M):
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
    d_s = bs[(M - 1) * 120 + 60:M * 120]

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


def product_mats(n: int = FRAME):
    """K1's product matrices (W_long, W_short) for frames of n, float32
    [nout(n), kpad(n)]: W = [A | D | 0], rows 0..n-1 the output samples,
    n..n+59 the new raw tail, zero rows up to nout(n); K-major as TF32
    wgmma takes its B operand, zero columns from n to kpad(n), columns in
    ``k_order(kpad(n))``."""
    atl, ats, _, _, dtl, dts = fused_mats(n)
    order = k_order(kpad(n))
    out = []
    for a, d in ((atl, dtl), (ats, dts)):
        w = np.zeros((nout(n), kpad(n)), np.float32)
        w[:n, :n] = a.T
        w[n:n + OVER, :n] = d.T
        out.append(np.ascontiguousarray(w[:, order]))
    return tuple(out)


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
def _split_product_mats(n: int):
    return tuple(split_tf32(w) for w in product_mats(n))


class FusedMats(torch.nn.Module):
    """The folded constants of frames of n as buffers, moved with
    ``.to(device)``: the six matrices of the plain twin (atl .. dts), K1's
    product matrices split in TF32 (w_long_hi, w_long_lo, w_short_hi,
    w_short_lo) and the window."""

    def __init__(self, n: int = FRAME):
        super().__init__()
        self.n = n
        for name, m in zip(("atl", "ats", "ctl", "cts", "dtl", "dts"),
                           fused_mats(n)):
            self.register_buffer(name, torch.from_numpy(m.copy()))
        for mode, (hi, lo) in zip(("long", "short"), _split_product_mats(n)):
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
    """K1 on the card. freq [B, L, n] (n = mats.n) may be a view into the
    packed [B, L, n + 13] or [B, L, 2n + 13] buffer (unit last stride, rows
    ld apart)."""
    B, L, n = freq.shape
    if (n != mats.n or tail0.shape != (L, OVER)
            or transient.shape != (B, L)):
        raise ValueError(
            f"K1 takes freq [B, L, {mats.n}], transient [B, L], tail0 "
            f"[L, {OVER}]; got {list(freq.shape)}, {list(transient.shape)}, "
            f"{list(tail0.shape)}")
    if freq.dtype != torch.float32 or tail0.dtype != torch.float32:
        raise TypeError("K1 takes float32 spectra and tail")
    ld = freq.stride(1)
    if freq.stride(2) != 1 or freq.stride(0) != L * ld:
        freq = freq.contiguous()
        ld = n
    trans = transient.to(torch.uint8).contiguous()
    tail0 = tail0.contiguous()
    dev = freq.device
    R = B * L
    y = torch.empty((B, L, n), dtype=torch.float32, device=dev)
    tails = torch.empty((R, OVER), dtype=torch.float32, device=dev)
    lists = torch.empty((2 * R,), dtype=torch.int32, device=dev)
    counts = torch.empty((2,), dtype=torch.int32, device=dev)
    K1(freq, ld, n, trans, tail0, B, L, mats.w_long_hi, mats.w_long_lo,
       mats.w_short_hi, mats.w_short_lo, mats.window, y, tails, lists, counts)
    return y, tails[(B - 1) * L:]


def imdct_overlap(mats: FusedMats, freq, transient, tail0):
    """(y [B, L, n], tail [L, 60]) from spectra freq [B, L, n] (n =
    mats.n), transient [B, L] bool and the previous batch's tail0 [L, 60].
    CUDA tensors run K1; CPU tensors run the plain twin."""
    if freq.is_cuda:
        return imdct_overlap_cuda(mats, freq, transient, tail0)
    return imdct_overlap_plain(mats, freq, transient, tail0)
