"""PVQ leaf reconstruction and the noise-fill LCG: K12 and its plain twins.

The counterpart of iamf_tpu/codecs/opus/device_leaf.py. alg_unquant
(native/src/opus/celt_pvq.cc) scales a decoded pulse vector y to the
theta-path gain on the unit sphere, X = y * (gain / sqrt(sum y^2)), then
spreads it with exp_rotation(X, n, -1, blocks, k, spread). The rotation is
a linear map fixed by (n, k, spread, blocks), so the host builds each
configuration's dense matrix once by pushing unit vectors through the
exact native rotation, and the device applies a gathered matvec. The
matvec sums in another order than the sequential two-pass rotation, so
it agrees to about 1e-6 relative; the normalization is exact (the sum of
integer squares is exact in float32 below 2^24).

Host side (numpy, copied): ``needs_rotation``, ``rotation_matrix``,
``build_rotation_bank``, the LCG constants and ``lcg_jump_tables``.

Device side, K12 (csrc/celt_leaf.cu) on CUDA tensors, the plain twins on
CPU tensors:
- ``normalize_pulses`` / ``apply_rotations`` / the two fused in
  ``normalize_rotate``: one launch, a block a configuration (its matrix
  in shared memory once, its leaves gathered from cfg, a thread an output
  row on the CUDA cores in fp32), then a warp a leaf for the others;
- ``lcg_noise_fill`` and ``lcg_leaf_entry_seeds``: celt_lcg_rand's
  seed' = 1664525 seed + 1013904223 (mod 2^32) by jump-ahead,
  seed_after_j = A^j seed + B_j, the tables in shared memory, exact;
- ``reconstruct``: K11, then normalize-and-rotate in one K12 launch.

The JAX function pads the leaf, rotation and configuration axes to powers
of two to bound XLA's compile count; nothing here pads.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from ...kernels.build import I, P, U, Kernel
from ...convert import leaf_batch
from ...device import resolve_device
from .device_cwrsi import (M32, aligned, contiguous, cwrsi_batch,
                           i64_to_u32, sqrt_rn, u32_to_i64, wrap_i32)

ROT_W = 96  # rotation matrix pad (largest rotating leaf dimension)

K12 = Kernel("iamf_k12_normrot", [P, P, P, P, P, I, I, I, P])
K12_FILL = Kernel("iamf_k12_lcg_fill", [P, I, I, P, P])
K12_ENTRY = Kernel("iamf_k12_lcg_entry", [U, P, I, P, P])
KERNELS = (K12, K12_FILL, K12_ENTRY)


@functools.lru_cache(maxsize=None)
def _native():
    lib = ctypes.CDLL(os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "..", "..", "..", "native", "lib", "libiamf_native.so"))
    lib.iamf_exp_rotation.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.iamf_exp_rotation.restype = None
    return lib


def needs_rotation(n, k, spread) -> np.ndarray:
    """exp_rotation's early-out predicate (host-known per leaf)."""
    return ~((2 * np.asarray(k) >= np.asarray(n)) | (np.asarray(spread) == 0))


@functools.lru_cache(maxsize=None)
def rotation_matrix(n: int, k: int, spread: int, blocks: int) -> np.ndarray:
    """[n, n] dense matrix of exp_rotation(X, n, -1, blocks, k, spread),
    built by pushing unit vectors through the exact native rotation."""
    lib = _native()
    m = np.zeros((n, n), np.float32)
    for j in range(n):
        v = np.zeros(n, np.float32)
        v[j] = 1.0
        lib.iamf_exp_rotation(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, -1, blocks, k, spread)
        m[:, j] = v
    return m


def build_rotation_bank(configs) -> np.ndarray:
    """[n_cfg, ROT_W, ROT_W] padded matrix bank for a config list of
    (n, k, spread, blocks) tuples (identity outside each n x n block so
    padded lanes pass through)."""
    bank = np.tile(np.eye(ROT_W, dtype=np.float32),
                   (len(configs), 1, 1))
    for i, (n, k, spread, blocks) in enumerate(configs):
        bank[i, :n, :n] = rotation_matrix(int(n), int(k), int(spread),
                                          int(blocks))
    return bank


def rotation_plan(n, k, spread, blocks):
    """The rotating leaves' configurations: (cfg [L] int32, -1 where the
    leaf does not rotate, and the bank [n_cfg, ROT_W, ROT_W] of the
    distinct (n, k, spread, blocks) in np.unique's order)."""
    n = np.asarray(n, np.int32)
    k = np.asarray(k, np.int32)
    rot = needs_rotation(n, k, spread)
    cfg = np.full(len(n), -1, np.int32)
    if not rot.any():
        return cfg, np.zeros((0, ROT_W, ROT_W), np.float32)
    sel = np.flatnonzero(rot)
    cfgs, inv = np.unique(
        np.stack([n[sel], k[sel], np.asarray(spread)[sel],
                  np.asarray(blocks)[sel]], axis=1),
        axis=0, return_inverse=True)
    cfg[sel] = inv.reshape(-1)
    return cfg, build_rotation_bank([tuple(c) for c in cfgs])


# ---- normalization and rotation ---------------------------------------

def _rotate_plain(X, cfg, bank):
    """X [L, ROT_W] by bank[cfg] where cfg >= 0; other rows pass."""
    out = X.clone()
    sel = torch.nonzero(cfg >= 0).flatten()
    if len(sel):
        mats = bank[cfg[sel].long()]
        out[sel] = torch.bmm(mats, X[sel][:, :, None])[:, :, 0]
    return out


def normalize_rotate_plain(y, gain, cfg=None, bank=None):
    """Plain twin of K12's normalize-and-rotate: y int32 [L, W] pulses,
    gain [L] -> X [L, W] = y * (gain / sqrt(sum y^2)), then the rows with
    cfg >= 0 times bank[cfg] (W == ROT_W)."""
    K12.note_plain(y)
    yf = y.to(torch.float32)
    ryy = torch.sum(yf * yf, dim=1)
    X = yf * (gain / sqrt_rn(ryy))[:, None]
    if cfg is None:
        return X
    return _rotate_plain(X, cfg, bank)


def _normrot_cuda(y, x, gain, cfg, bank, L, W):
    dev = (y if y is not None else x).device
    want = ((y, torch.int32, (L, W)), (x, torch.float32, (L, W)),
            (gain, torch.float32, (L,)), (cfg, torch.int32, (L,)))
    if (W > ROT_W or (cfg is not None and W != ROT_W)
            or (cfg is None) != (bank is None)
            or any(t is not None and (t.dtype != dt or tuple(t.shape) != sh)
                   for t, dt, sh in want)
            or (bank is not None and (bank.dtype != torch.float32
                                      or tuple(bank.shape[1:])
                                      != (ROT_W, ROT_W)))):
        raise ValueError(f"K12 takes pulses int32 or X float32 [L, W <= "
                         f"{ROT_W}], gain float32 [L], cfg int32 [L] and a "
                         f"bank float32 [n, {ROT_W}, {ROT_W}] (W = {ROT_W} "
                         f"to rotate)")
    out = torch.empty((L, W), dtype=torch.float32, device=dev)
    n_cfg = 0 if bank is None else bank.shape[0]
    if L:
        K12(*(t.contiguous() if t is not None else None for t in (y, x, gain)),
            *(aligned(t) if t is not None else None for t in (cfg, bank)),
            L, W, n_cfg, out)
    return out


def normalize_rotate(y, gain, cfg=None, bank=None):
    """X = y * (gain / sqrt(sum y^2)) over y int32 [L, W], then the rows
    with cfg >= 0 (int32 [L]) times bank[cfg] (float32 [n_cfg, 96, 96]),
    on the tensors' device (K12 on the card: one launch)."""
    if y.is_cuda:
        return _normrot_cuda(y, None, gain, cfg, bank, *y.shape)
    return normalize_rotate_plain(y, gain, cfg, bank)


def normalize_pulses(y, gain):
    """alg_unquant normalization: X = y * gain / sqrt(sum y^2).
    y: [L, N_MAX] int32 pulses (zero-padded), gain: [L] float32."""
    return normalize_rotate(y, gain)


def apply_rotations(X, cfg_idx, bank):
    """Gathered batched matvec: X [L, ROT_W], cfg_idx [L] int32 into
    bank [n_cfg, ROT_W, ROT_W]."""
    if X.is_cuda:
        return _normrot_cuda(None, X, None, cfg_idx, bank, *X.shape)
    K12.note_plain(X)
    return _rotate_plain(X, cfg_idx, bank)


def reconstruct(n, k, idx, gain, spread, blocks, device="cuda"):
    """Leaf reconstruction for a batch of real leaves: cwrsi (K11) ->
    normalize -> rotation of the rotating leaves by the configuration
    bank (K12, one launch). The leaf arrays are numpy (as the native tap
    gives them); returns [L, N_MAX] float32 leaf vectors on `device`."""
    dev = resolve_device(device)
    cfg, bank = rotation_plan(n, k, spread, blocks)
    lb = leaf_batch(n, k, idx, gain, spread, blocks, dev)
    y = cwrsi_batch(lb["n"], lb["k"], lb["idx"])
    if not (cfg >= 0).any():
        return normalize_rotate(y, lb["gain"])
    return normalize_rotate(y, lb["gain"], torch.from_numpy(cfg).to(dev),
                            torch.from_numpy(bank).to(dev))


# ---- the noise-fill LCG ------------------------------------------------
# celt_lcg_rand (celt_energy.cc / libopus celt.h): seed' = 1664525*seed +
# 1013904223 (mod 2^32). Noise/fold leaves draw N values each, and the
# draw COUNT depends on device-resident collapse masks, so the seed that
# reaches a given leaf is device data. Jump-ahead makes it parallel:
# seed_after_j = A^j * seed + B_j (mod 2^32) with precomputed (A^j, B_j)
# tables — one u32 multiply-add per (leaf, position) instead of a scan.

LCG_A = np.uint32(1664525)
LCG_C = np.uint32(1013904223)
LCG_MAX = 4096  # >= max cumulative draws per frame (<= coded bins, 960)


@functools.lru_cache(maxsize=None)
def lcg_jump_tables() -> tuple[np.ndarray, np.ndarray]:
    """(A^j, B_j) for j = 0..LCG_MAX, u32: seed_after_j = A^j*seed + B_j."""
    a = np.empty(LCG_MAX + 1, np.uint32)
    b = np.empty(LCG_MAX + 1, np.uint32)
    aj, bj = 1, 0
    for j in range(LCG_MAX + 1):
        a[j], b[j] = aj, bj
        aj = (aj * 1664525) & 0xFFFFFFFF
        bj = (bj * 1664525 + 1013904223) & 0xFFFFFFFF
    return a, b


@functools.lru_cache(maxsize=None)
def lcg_tables_on(device: torch.device) -> torch.Tensor:
    """[2, LCG_MAX + 1] int32 holding the u32 bits of (A^j, B_j), on a
    device (K12's and K13's copy)."""
    return torch.from_numpy(np.stack(lcg_jump_tables()).view(np.int32)).to(
        device)


def mul32(a, b):
    """a * b mod 2^32 for int64 tensors of u32 values, in int64 without
    overflow (b split in 16-bit halves)."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def lcg_noise_fill(seed0, draws, width: int):
    """Batched noise-fill draws: given each leaf's ENTRY seed (already
    jump-ahead-composed), emit its first `width` draws. seed0: [L] u32
    entry seeds; draws: [L] int32 actual counts (values beyond are junk);
    returns [L, width] u32: v[l, j] = A^(j+1) seed0[l] + B_(j+1)."""
    del draws  # static width; callers mask by count
    if not 0 <= width <= LCG_MAX:
        raise ValueError(f"lcg_noise_fill: width must be in [0, {LCG_MAX}]")
    if seed0.dtype != torch.uint32 or seed0.dim() != 1:
        raise ValueError(f"lcg_noise_fill takes seeds uint32 [L], got "
                         f"{seed0.dtype} {list(seed0.shape)}")
    L = seed0.shape[0]
    tab = lcg_tables_on(seed0.device)
    if seed0.is_cuda:
        out = torch.empty((L, width), dtype=torch.uint32,
                          device=seed0.device)
        if L and width:
            K12_FILL(contiguous(seed0), L, width, tab, out)
        return out
    K12_FILL.note_plain(seed0)
    t = u32_to_i64(tab)
    s = u32_to_i64(seed0)[:, None]
    return i64_to_u32((mul32(s, t[0, 1:width + 1][None])
                       + t[1, 1:width + 1][None]) & M32)


def lcg_leaf_entry_seeds(frame_seed, leaf_draws):
    """Seed threading ACROSS leaves of one frame: leaf l's entry seed =
    frame_seed advanced by the total draws of earlier leaves (an exclusive
    prefix sum in int32, clipped to [0, LCG_MAX], then the jump-ahead
    tables). frame_seed: an int or a one-element tensor; leaf_draws: [L]
    int32. Returns [L] u32 on leaf_draws' device (K12: one block)."""
    if leaf_draws.dtype != torch.int32 or leaf_draws.dim() != 1:
        raise ValueError(f"lcg_leaf_entry_seeds takes draws int32 [L], got "
                         f"{leaf_draws.dtype} {list(leaf_draws.shape)}")
    if isinstance(frame_seed, torch.Tensor):
        frame_seed = int(u32_to_i64(frame_seed.reshape(-1))[0])
    frame_seed = int(frame_seed) & M32
    L = leaf_draws.shape[0]
    tab = lcg_tables_on(leaf_draws.device)
    if leaf_draws.is_cuda:
        out = torch.empty(L, dtype=torch.uint32, device=leaf_draws.device)
        if L:
            K12_ENTRY(frame_seed, leaf_draws.contiguous(), L, tab, out)
        return out
    K12_ENTRY.note_plain(leaf_draws)
    incl = wrap_i32(torch.cumsum(leaf_draws.to(torch.int64), 0))
    prefix = (incl.to(torch.int64) - leaf_draws.to(torch.int64))
    prefix = wrap_i32(prefix).to(torch.int64).clamp(0, LCG_MAX)
    t = u32_to_i64(tab)
    return i64_to_u32(mul32(torch.full_like(prefix, frame_seed),
                            t[0][prefix]) + t[1][prefix])
