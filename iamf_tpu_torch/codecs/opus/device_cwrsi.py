"""Batched CWRS index -> PVQ pulse decode: K11 and its plain twin.

The counterpart of iamf_tpu/codecs/opus/device_cwrsi.py. A CELT leaf is
coded as (n, k, index): the index of its pulse vector among the V(n, k)
vectors of n integers whose magnitudes sum to k. cwrsi turns the index
back into the vector, one dimension at a time from n down to 3 (a search
of the row U(., d) of the CWRS count table for the largest k' whose
count is at most the index left), then the closed forms of n = 2 and
n = 1. It mirrors the native walk (native/src/opus/celt_pvq.cc ``cwrsi``)
exactly, in u32 arithmetic with its wraps.

- ``u_table`` / ``u_rows``: the count table and its per-dimension rows
  (numpy, copied from the JAX package);
- ``host_reference``: the native walk, the oracle;
- ``cwrsi_batch(n, k, idx, align=True, n_max=N_MAX)``: on CUDA tensors
  K11 (csrc/celt_cwrsi.cu: a warp a leaf, the search of a row the
  popcount of the lanes' ballots, runs of zero steps 32 dimensions a
  pass, the rows in shared memory by one bulk copy a block, a block's
  leaves longest first); on CPU tensors ``cwrsi_plain``, the same walk
  vectorized over the leaves with ``torch.searchsorted``.

The JAX package evaluates each row lookup as a one-hot select because
XLA:TPU gathers slowly; both forms here read the row directly.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from ...kernels.build import I, P, Kernel

U_MAX_N = 212
U_MAX_K = 132
N_MAX = 96   # largest PVQ leaf dimension at 48 kHz (celt_pvq.cc census)
K_MAX = 128
M32 = 0xFFFFFFFF

K11 = Kernel("iamf_k11_cwrsi", [P, P, P, P, I, I, I, P])


@functools.lru_cache(maxsize=None)
def u_table() -> np.ndarray:
    """U(n,k) CWRS count table, identical to celt_pvq.cc u_table():
    u64 DP saturated to u32."""
    dp = np.zeros((U_MAX_N, U_MAX_K), np.uint64)
    for n in range(1, U_MAX_N):
        dp[n, 1] = 1
        for k in range(2, U_MAX_K):
            v = dp[n - 1, k] + dp[n, k - 1] + dp[n - 1, k - 1]
            dp[n, k] = min(v, 0xFFFFFFFF)
    return dp.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def u_rows() -> np.ndarray:
    """[N_MAX + 1, U_MAX_K] u32: row d holds u_d[j] = U(j, d) (symmetric
    canonicalization of the 2-D table), the per-dimension constant the
    kernel broadcasts against. Saturated (overflow) entries stay huge so
    they never win a <=i compare."""
    t = u_table()
    rows = np.empty((N_MAX + 1, U_MAX_K), np.uint32)
    for d in range(N_MAX + 1):
        for j in range(U_MAX_K):
            a, b = max(j, d), min(j, d)
            rows[d, j] = t[a, b] if a < U_MAX_N else 0xFFFFFFFF
    return rows


@functools.lru_cache(maxsize=None)
def rows_on(device: torch.device) -> torch.Tensor:
    """u_rows() on a device, as int32 holding the u32 bits (K11 reads
    them as u32)."""
    return torch.from_numpy(u_rows().view(np.int32)).to(device)


def host_reference(n, k, idx) -> np.ndarray:
    """Host cwrsi via the native lib (the oracle for the kernel)."""
    lib = ctypes.CDLL(os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "..", "..", "..", "native", "lib", "libiamf_native.so"))
    cnt = len(n)
    y = np.zeros((cnt, 208), np.int32)
    lib.iamf_cwrsi_bench.restype = ctypes.c_longlong
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    lib.iamf_cwrsi_bench(
        ip(np.ascontiguousarray(n, np.int32)),
        ip(np.ascontiguousarray(k, np.int32)),
        np.ascontiguousarray(idx, np.uint32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint32)),
        int(cnt), 1, ip(y))
    return y[:, :N_MAX]


def u32_to_i64(t: torch.Tensor) -> torch.Tensor:
    """u32 values (a uint32 tensor, or any integer tensor) as int64 in
    [0, 2^32)."""
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.to(torch.int64) & M32


def i64_to_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 -> a uint32 tensor."""
    return (((t & M32) ^ 0x80000000) - 0x80000000).to(torch.int32).view(
        torch.uint32)


def contiguous(t: torch.Tensor) -> torch.Tensor:
    """t.contiguous(), also for uint32 on the card (CUDA has no uint32
    copy kernel: the copy goes through an int32 view)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).contiguous().view(torch.uint32)
    return t.contiguous()


def aligned(t: torch.Tensor) -> torch.Tensor:
    """contiguous(t) at a 16-byte aligned address (a kernel's vector loads
    and bulk copies); a tensor of 4-byte elements."""
    c = contiguous(t)
    if c.data_ptr() % 16:  # a copy through int32 (CUDA copies no uint32)
        c = c.view(torch.int32).clone().view(t.dtype)
    return c


def wrap_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with the wrap of two's complement."""
    return (((t & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded to nearest, as the reference's and the
    card's: through float64 (exact for float32 inputs), since torch's CPU
    float32 sqrt can miss by an ulp."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _check(n, k, idx, n_max):
    if not 2 <= n_max <= N_MAX:
        raise ValueError(f"cwrsi: n_max must be in [2, {N_MAX}], got {n_max}")
    if (n.dtype != torch.int32 or k.dtype != torch.int32
            or idx.dtype != torch.uint32 or n.dim() != 1
            or n.shape != k.shape or n.shape != idx.shape):
        raise ValueError(
            f"cwrsi takes n, k int32 [L] and idx uint32 [L]; got "
            f"{n.dtype} {list(n.shape)}, {k.dtype} {list(k.shape)}, "
            f"{idx.dtype} {list(idx.shape)}")


def look(row: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """row[v] (row int64 [U_MAX_K]), 0 where v is outside the row."""
    ok = (v >= 0) & (v < U_MAX_K)
    return torch.where(ok, row[v.clamp(0, U_MAX_K - 1)], 0)


def search(row: torch.Tensor, i: torch.Tensor,
           upper: torch.Tensor) -> torch.Tensor:
    """max{j <= upper : row[j] <= i}, or -1 (row int64 [U_MAX_K],
    nondecreasing: the j with row[j] <= i are a prefix)."""
    c = torch.searchsorted(row, i, right=True) - 1
    return torch.minimum(c, upper).clamp(min=-1)


def cwrsi_plain(n, k, idx, align: bool = True, n_max: int = N_MAX):
    """Plain twin of K11: (n, k int32 [L], idx uint32 [L]) -> pulses int32
    [L, n_max]. u32 values are held in int64 and wrapped after every
    subtraction; the search of a row is ``torch.searchsorted`` (the row is
    nondecreasing, so the counts at most i are a prefix)."""
    _check(n, k, idx, n_max)
    K11.note_plain(n)
    dev = n.device
    rows = rows_on(dev).to(torch.int64) & M32       # [97, 132]
    i = u32_to_i64(idx)
    kk = k.to(torch.int64)
    n0 = n.to(torch.int64)
    L = n.shape[0]
    walk = torch.zeros((L, n_max), dtype=torch.int64, device=dev)

    for d in range(n_max, 2, -1):
        act = n0 >= d
        row = rows[d]
        ge = kk >= d                       # lots of pulses
        p_k1 = look(row, kk + 1)
        p_k0 = look(row, kk)
        sA = ge & (i >= p_k1)
        iA = torch.where(sA, (i - p_k1) & M32, i)
        upperA = torch.where(row[d] > iA, d - 1, kk)
        kA = search(row, iA, upperA)
        zero = ~ge & (p_k0 <= i) & (i < p_k1)
        sB = ~ge & ~zero & (i >= p_k1)
        iB = torch.where(zero, (i - p_k0) & M32,
                         torch.where(sB, (i - p_k1) & M32, i))
        kB = search(row, iB, kk - 1)
        s = torch.where(ge, sA, sB)
        k_new = torch.where(ge, kA, torch.where(zero, kk, kB))
        p_new = look(row, k_new)
        i_new = torch.where(ge, (iA - p_new) & M32,
                            torch.where(zero, iB, (iB - p_new) & M32))
        si = s.to(torch.int64).neg()
        y = torch.where(zero, 0, (kk - k_new + si) ^ si)
        kk = torch.where(act, k_new, kk)
        i = torch.where(act, i_new, i)
        walk[:, n_max - d] = torch.where(act, y, 0)

    # n == 2
    p = (2 * (kk & M32) + 1) & M32
    s2 = i >= p
    i = torch.where(s2, (i - p) & M32, i)
    k0 = kk
    kk = ((i + 1) & M32) >> 1
    i = torch.where(kk > 0, (i - ((2 * kk - 1) & M32)) & M32, i)
    si = s2.to(torch.int64).neg()
    walk[:, n_max - 2] = (k0 - kk + si) ^ si
    # n == 1 (C: s = -(int)i)
    si = wrap_i32(i).to(torch.int64).neg()
    walk[:, n_max - 1] = (kk + si) ^ si

    walk = wrap_i32(walk)
    if not align:
        return walk
    # leaf coefficient j was emitted at walk column n_max - n + j
    j = torch.arange(n_max, device=dev)[None, :]
    src = (n_max - n0[:, None] + j).clamp(0, n_max - 1)
    y = torch.gather(walk, 1, src)
    return torch.where(j < n0[:, None], y, 0)


def cwrsi_cuda(n, k, idx, align: bool = True, n_max: int = N_MAX):
    """K11 on the card: (n, k int32 [L], idx uint32 [L]) -> pulses int32
    [L, n_max] in one launch, a warp a leaf."""
    _check(n, k, idx, n_max)
    n, k, idx = n.contiguous(), k.contiguous(), contiguous(idx)
    L = n.shape[0]
    out = torch.empty((L, n_max), dtype=torch.int32, device=n.device)
    if L:
        K11(n, k, idx, rows_on(n.device), L, n_max, int(align), out)
    return out


def cwrsi_batch(n, k, idx, align: bool = True, n_max: int = N_MAX):
    """Decode a batch of PVQ leaves: (n, k int32 [L], idx uint32 [L]) ->
    pulses int32 [L, n_max], on the tensors' device.

    align=True places each leaf's coefficients at [0, n) (entries beyond
    are 0). align=False returns the walk order: leaf coefficient j at
    column n_max - n + j. n_max bounds the walk's dimensions (leaves
    bucketed by dimension skip the idle top steps), as the JAX function's
    static unroll bound does."""
    if n.is_cuda:
        return cwrsi_cuda(n, k, idx, align, n_max)
    return cwrsi_plain(n, k, idx, align, n_max)
