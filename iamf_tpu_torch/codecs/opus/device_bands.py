"""The packed mono band walk of a CELT frame: K13 and its plain twin.

The counterpart of iamf_tpu/codecs/opus/device_bands.py. band_pack
flattens a frame's band-walk records into fixed-shape tables: per band
its fold range, lowband offset and transform configuration, per leaf slot
(16 a band) its placement, fill map (a 16-column bit matrix), collapse
shift, gain and, for a PVQ leaf, its reconstructed vector. ``run_frame``
executes them: a 21-band loop that threads the collapse masks, the LCG
seed and the norm buffer [800]. In each band the noise and fold leaves
draw their LCG values by jump-ahead (an intra-band prefix of the draws),
the fold source is read from the norm buffer through the band's lowband
pre-transform, the leaves are placed, and the band's upward transform and
collapse post-map come from the configuration banks (``cfg_banks``: at
LM = 3 mono, a handful of (B_in, tf) combinations a band size).

Scope, as the JAX package's (``packable``): C == 1, LM == 3, mono bands
(long-block and transient frames).

Host side (numpy, copied from the JAX package): the constants,
``band_sizes``, ``band_offsets``, ``packable``, ``CFGS``/``CFG_ID``,
``_post_matrix``, ``_pre_matrix``, ``cfg_banks`` and ``pack_tensors``.
``device_banks(device)`` puts the banks (≈ 8.3 MB of fp32 matrices, the
cm and B-mask banks, the LCG tables and sqrt(N) of each band) on a device
once; ``k13_banks`` K13's copy of the matrices, laid out for its cluster.

``run_frame(bt, lt, seed0, device="cuda")`` takes pack_tensors' numpy
dicts (one frame, or sequences of them) or convert.packed_frame's tensors
(a leading frame axis F; they keep their device) and returns (spec
[F, 800] f32, seed out [F] u32, collapse [F, 21] u32), without the frame
axis for one frame's numpy dicts. On CUDA tensors it runs K13
(csrc/celt_bands.cu, a cluster of four CTAs a frame, the bands in
sequence, each CTA a quarter of every matvec's rows); on CPU tensors
``run_frames_plain``, the same walk vectorized over frames and slots.

The JAX program reads its windows with ``dynamic_slice``, which clamps a
start so that the window stays in bounds, and places a leaf with
``jnp.roll`` (bin j to (j + off) mod N); both forms here do the same.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...convert import packed_frame
from ...device import resolve_device
from ...kernels.build import I, P, Kernel, load
from .band_replay import EBANDS
from .device_cwrsi import (M32, aligned, contiguous, i64_to_u32, sqrt_rn,
                           u32_to_i64, wrap_i32)
from .device_leaf import LCG_MAX, lcg_jump_tables, lcg_tables_on, mul32


NBANDS = 21
SLOTS = 16          # max leaves per band (census max for one band)
W = 176             # widest band at LM=3
NBINS = 800         # 8 * eBands[21]
M = 8               # LM=3


def band_sizes():
    return (M * (EBANDS[1:] - EBANDS[:-1])).astype(np.int32)  # [21]


def band_offsets():
    return (M * EBANDS[:-1]).astype(np.int32)


def packable(pf) -> bool:
    """True when the frame fits the jitted program's class (mono LM=3,
    long-block AND transient: per-band transforms come from the config
    matrix banks)."""
    if pf.C != 1 or pf.M != M or pf.norm_offset != 0:
        return False
    for b in pf.bands:
        if b.mode != 0 or b.avg:
            return False
    for lf in pf.leaves:
        if lf.k == -1 or lf.n > W:
            return False
    return True


# Per-band transform-config banks: at LM=3 mono, a band's upward X
# transform and its lowband pre-transform are linear maps determined by
# (B_in, tf) — a handful of combos. Matrices are built by pushing unit
# vectors through the exact numpy transforms (band_replay's
# haar/hadamard), the same treatment device_leaf gives rotations.
CFGS = []            # (B_in, tf) combos, index = cfg id
for _b in (1, 8):
    for _tf in (-3, -2, -1, 0, 1, 2, 3):
        CFGS.append((_b, _tf))
CFG_ID = {c: i for i, c in enumerate(CFGS)}


@functools.lru_cache(maxsize=None)
def _post_matrix(N: int, B_in: int, tf: int) -> np.ndarray:
    """[N, N] matrix of quant_band's upward X transforms
    (interleave_hadamard + time-divide haars + recombine haars)."""
    from .band_replay import haar1, interleave_hadamard

    recombine = tf if tf > 0 else 0
    B = B_in >> recombine
    nb = (N // B_in) << recombine
    tfc = tf
    td = 0
    while (nb & 1) == 0 and tfc < 0:
        B <<= 1
        nb >>= 1
        tfc += 1
        td += 1
    B0, N_B0 = B, nb
    longBlocks = int(B_in == 1)
    m = np.zeros((N, N), np.float32)
    for j in range(N):
        x = np.zeros(N, np.float32)
        x[j] = 1.0
        if B0 > 1:
            interleave_hadamard(x, N_B0 >> recombine, B0 << recombine,
                                longBlocks)
        tdB, tdN = B0, N_B0
        for _ in range(td):
            tdB >>= 1
            tdN <<= 1
            haar1(x, tdN, tdB)
        for kk in range(recombine):
            haar1(x, N >> kk, 1 << kk)
        m[:, j] = x
    return m


@functools.lru_cache(maxsize=None)
def _pre_matrix(N: int, B_in: int, tf: int) -> np.ndarray:
    """[N, N] matrix of the lowband pre-transforms (haar chain +
    deinterleave_hadamard)."""
    from .band_replay import deinterleave_hadamard, haar1

    recombine = tf if tf > 0 else 0
    B = B_in >> recombine
    nb = (N // B_in) << recombine
    tfc = tf
    td = 0
    while (nb & 1) == 0 and tfc < 0:
        B <<= 1
        nb >>= 1
        tfc += 1
        td += 1
    B0, N_B0 = B, nb
    longBlocks = int(B_in == 1)
    m = np.zeros((N, N), np.float32)
    for j in range(N):
        x = np.zeros(N, np.float32)
        x[j] = 1.0
        for kk in range(recombine):
            haar1(x, N >> kk, 1 << kk)
        tdB = B_in >> recombine
        tdN = (N // B_in) << recombine
        tfc2 = tf
        while (tdN & 1) == 0 and tfc2 < 0:
            haar1(x, tdN, tdB)
            tdB <<= 1
            tdN >>= 1
            tfc2 += 1
        if B0 > 1:
            deinterleave_hadamard(x, N_B0 >> recombine, B0 << recombine,
                                  longBlocks)
        m[:, j] = x
    return m


@functools.lru_cache(maxsize=None)
def cfg_banks():
    """Per-band matrix banks [n_cfg, N, N] (post and pre) + cm-map bank
    [n_cfg, 16] and final-B-mask bank [n_cfg] for every (B_in, tf)
    combo at each of the 21 static band sizes."""
    from .band_pack import _band_cm_cols

    sizes = band_sizes()
    post, pre, cmc, bmask = [], [], [], []
    for i in range(NBANDS):
        N = int(sizes[i])
        po = np.zeros((len(CFGS), N, N), np.float32)
        pr = np.zeros((len(CFGS), N, N), np.float32)
        cc = np.zeros((len(CFGS), 16), np.uint32)
        bm = np.zeros(len(CFGS), np.uint32)
        for ci, (B_in, tf) in enumerate(CFGS):
            if N % B_in:
                po[ci] = np.eye(N, dtype=np.float32)
                pr[ci] = np.eye(N, dtype=np.float32)
                bm[ci] = 1
                cc[ci] = 0
                continue
            po[ci] = _post_matrix(N, B_in, tf)
            pr[ci] = _pre_matrix(N, B_in, tf)
            recombine = tf if tf > 0 else 0
            B = B_in >> recombine
            nb = (N // B_in) << recombine
            tfc = tf
            td = 0
            while (nb & 1) == 0 and tfc < 0:
                B <<= 1
                nb >>= 1
                tfc += 1
                td += 1
            cc[ci] = _band_cm_cols(recombine, td, B)
            B_fin = (B >> td) << recombine
            bm[ci] = (1 << B_fin) - 1
        post.append(po)
        pre.append(pr)
        cmc.append(cc)
        bmask.append(bm)
    return post, pre, cmc, bmask


def pack_tensors(pf, leaf_vecs):
    """PackedFrame -> fixed-shape numpy tensors for the jitted program."""
    sizes = band_sizes()
    offs = band_offsets()
    bt = {
        "present": np.zeros(NBANDS, np.int32),
        "has_lb": np.zeros(NBANDS, np.int32),
        "eff": np.zeros(NBANDS, np.int32),
        "fs": np.zeros(NBANDS, np.int32),
        "fe": np.zeros(NBANDS, np.int32),
        "last": np.ones(NBANDS, np.int32),
        "B_in": np.ones(NBANDS, np.int32),
        "cfg_id": np.zeros(NBANDS, np.int32),
    }
    lt = {
        "n": np.zeros((NBANDS, SLOTS), np.int32),
        "k": np.full((NBANDS, SLOTS), -2, np.int32),
        "off": np.zeros((NBANDS, SLOTS), np.int32),
        "gain": np.zeros((NBANDS, SLOTS), np.float32),
        "b_leaf": np.ones((NBANDS, SLOTS), np.int32),
        "cm_shift": np.zeros((NBANDS, SLOTS), np.int32),
        "fill_cols": np.zeros((NBANDS, SLOTS, 16), np.uint32),
        "vec": np.zeros((NBANDS, SLOTS, W), np.float32),
    }
    counts = np.zeros(NBANDS, np.int32)
    for b in pf.bands:
        assert sizes[b.i] == b.N and offs[b.i] == b.offX + pf.norm_offset
        bt["present"][b.i] = 1
        bt["has_lb"][b.i] = int(b.has_lb)
        bt["eff"][b.i] = b.eff if b.has_lb else 0
        bt["fs"][b.i] = b.fs
        bt["fe"][b.i] = max(b.fe, b.fs + 1)
        bt["last"][b.i] = int(b.last)
        bt["B_in"][b.i] = b.B
        bt["cfg_id"][b.i] = CFG_ID[(b.B, max(min(b.tf, 3), -3))]
    for lf in pf.leaves:
        s = counts[lf.band]
        counts[lf.band] += 1
        assert s < SLOTS
        lt["n"][lf.band, s] = lf.n
        lt["k"][lf.band, s] = lf.k
        lt["off"][lf.band, s] = lf.off
        lt["gain"][lf.band, s] = lf.gain
        lt["b_leaf"][lf.band, s] = lf.b_leaf
        lt["cm_shift"][lf.band, s] = lf.cm_shift
        lt["fill_cols"][lf.band, s] = lf.fill_cols
        if lf.vec_idx >= 0:
            v = leaf_vecs[lf.vec_idx]
            lt["vec"][lf.band, s, :min(len(v), W)] = v[:W]
    return bt, lt


# ---- on the device ------------------------------------------------------

BT_KEYS = ("present", "has_lb", "eff", "fs", "fe", "last", "B_in", "cfg_id")
LT_INTS = ("n", "k", "off", "b_leaf", "cm_shift")

K13 = Kernel("iamf_k13_bands", [P] * 10 + [I] + [P] * 3)


def k13_cluster() -> int:
    """CTAs a frame of the loaded K13 (csrc/celt_bands.cu's CLUSTER)."""
    return int(load().iamf_k13_cluster())


def row_parts(mats, cluster: int) -> np.ndarray:
    """K13's layout of the bands' [14, N, N] banks, flat in band order:
    matrix m of a band as `cluster` parts q of R = N / cluster rows (a
    CTA's each), part q's element m[q R + row, 4 u + r] at [u][row][r]
    (the four threads of a row, thread r reading column 4 u + r, read 32
    consecutive floats a warp)."""
    return np.concatenate([
        m.reshape(len(m), cluster, m.shape[1] // cluster, m.shape[2] // 4, 4)
        .transpose(0, 1, 3, 2, 4).reshape(-1) for m in mats])


@functools.lru_cache(maxsize=None)
def device_banks(device: torch.device) -> dict:
    """cfg_banks() and the walk's other tables on a device, built once a
    device: ``post_bands``/``pre_bands`` the 21 bands' [14, N, N] matrix
    banks; ``cm`` [21, 14, 16] and ``bm`` [21, 14] (int32 holding u32
    bits), ``sq`` [21] the float32 of float64 sqrt(N), ``lcg`` the LCG
    jump tables."""
    post, pre, cmc, bmask = cfg_banks()
    sizes = band_sizes()
    return {
        "post_bands": [torch.from_numpy(m).to(device) for m in post],
        "pre_bands": [torch.from_numpy(m).to(device) for m in pre],
        "cm": torch.from_numpy(np.stack(cmc).view(np.int32)).to(device),
        "bm": torch.from_numpy(np.stack(bmask).view(np.int32)).to(device),
        "sq": torch.from_numpy(np.sqrt(sizes.astype(np.float64)).astype(
            np.float32)).to(device),
        "lcg": lcg_tables_on(device),
    }


@functools.lru_cache(maxsize=None)
def k13_banks(device: torch.device, cluster: int) -> tuple:
    """K13's post and pre banks on a device, in row_parts' layout for
    `cluster` CTAs a frame."""
    post, pre, _, _ = cfg_banks()
    return tuple(torch.from_numpy(row_parts(m, cluster)).to(device)
                 for m in (post, pre))


def _shl(x, s):
    """u32 x << s as XLA's shift_left: 0 for a shift outside [0, 32)."""
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, (x << s.clamp(0, 31)) & M32, 0)


def _or_reduce(x, dim: int):
    """Bitwise OR of u32 values (int64) along `dim`."""
    sh = torch.arange(32, device=x.device)
    bits = ((x.unsqueeze(-1) >> sh) & 1).amax(dim=dim % x.dim())
    return (bits << sh).sum(-1)


def _apply_cols16(cols, v):
    """OR-map apply: cols [..., 16] u32 (int64), v [...] -> [...]: the OR
    of cols[..., i] over the bits i set in v."""
    hit = ((v.unsqueeze(-1) >> torch.arange(16, device=v.device)) & 1) > 0
    return _or_reduce(torch.where(hit, cols, 0), -1)


def run_frames_plain(bt: dict, lt: dict, seed0):
    """Plain twin of K13 over F frames: bt {key: int32 [F, 21]}, lt
    {n, k, off, b_leaf, cm_shift: int32 [F, 21, 16], gain f32 [F, 21, 16],
    fill_cols uint32 [F, 21, 16, 16], vec f32 [F, 21, 16, W]}, seed0
    uint32 [F] -> (spec [F, 800] f32, seed uint32 [F], collapse uint32
    [F, 21]). The band loop runs in sequence; frames and slots are
    vectorized (a band's slots fill disjoint bins, added in slot order)."""
    K13.note_plain(lt["vec"])
    dev = lt["vec"].device
    banks = device_banks(dev)
    tab = u32_to_i64(banks["lcg"])
    ja, jb = tab[0], tab[1]
    cmb, bmb = u32_to_i64(banks["cm"]), u32_to_i64(banks["bm"])
    F = lt["vec"].shape[0]
    sizes, offs = band_sizes(), band_offsets()
    jw = torch.arange(W, device=dev)
    bands = torch.arange(NBANDS, device=dev)
    blocks8 = torch.arange(8, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    norm = torch.zeros((F, NBINS + W), **f32)   # pad(norm, W)
    spec = torch.zeros((F, NBINS), **f32)
    collapse = torch.zeros((F, NBANDS), dtype=torch.int64, device=dev)
    seed = u32_to_i64(seed0)

    for i in range(NBANDS):
        N, a = int(sizes[i]), int(offs[i])
        b = {key: bt[key][:, i].to(torch.int64) for key in BT_KEYS}
        present = b["present"] > 0
        has_lb = b["has_lb"] > 0
        cfg = b["cfg_id"]
        # band entry fill: OR of collapse over the fold range, or full
        in_rng = (bands >= b["fs"][:, None]) & (bands < b["fe"][:, None])
        cm_or = _or_reduce(torch.where(in_rng, collapse, 0), 1)
        full = (_shl(torch.ones_like(cm_or), b["B_in"]) - 1) & M32
        entry = torch.where(has_lb, cm_or, full)
        # fold source window (start clamped into the padded buffer),
        # through the band's lowband pre-transform
        start = b["eff"].clamp(0, NBINS)
        lb_raw = torch.gather(norm, 1, start[:, None] + jw[None, :N])
        lb_t = torch.bmm(banks["pre_bands"][i][cfg], lb_raw[:, :, None])
        lb_cat = torch.cat([lb_t[:, :, 0], torch.zeros((F, 2 * W - N),
                                                       **f32)], 1)
        # the slots: fills, draws and the intra-band seed prefix
        n, k, off, bl, cms = (lt[key][:, i].to(torch.int64)
                              for key in LT_INTS)
        gain, vec = lt["gain"][:, i], lt["vec"][:, i]
        fill = _apply_cols16(u32_to_i64(lt["fill_cols"][:, i]), entry[:, None])
        cmask = (_shl(torch.ones_like(bl), bl) - 1) & M32
        f2 = fill & cmask
        draws = torch.where((k == 0) & (f2 > 0), n, 0)
        prefix = torch.cumsum(draws, 1) - draws
        steps = (prefix[:, :, None] + jw + 1).clamp(0, LCG_MAX)
        vals = (mul32(seed[:, None, None], ja[steps]) + jb[steps]) & M32
        noise = (wrap_i32(vals).to(torch.int64) >> 20).to(torch.float32)
        sgn = torch.where((vals & 0x8000) > 0, np.float32(1 / 256),
                          np.float32(-1 / 256))
        fstart = off.clamp(0, W)
        fold_src = torch.gather(
            lb_cat, 1, (fstart[:, :, None] + jw).reshape(F, -1)).view(
            F, SLOTS, W)
        mask = jw < n[:, :, None]
        q0v = torch.where(f2[:, :, None] == 0, 0.0,
                          torch.where(has_lb[:, None, None],
                                      fold_src + sgn, noise))
        q0v = torch.where(mask, q0v, 0.0)
        e = np.float32(1e-15) + torch.sum(q0v * q0v, dim=2)
        q0v = q0v * (gain / sqrt_rn(e))[:, :, None]
        active = k > -2
        v = torch.where(k[:, :, None] > 0, vec, q0v)
        v = torch.where(mask & active[:, :, None], v, 0.0)
        # placement: bin j of a slot to (j + off) mod N, in slot order
        X = torch.zeros((F, N), **f32)
        for s in range(SLOTS):
            if bool(active[:, s].any()):
                tgt = (jw[None, :N] + off[:, s, None]) % N
                X = X.scatter_add(1, tgt, v[:, s, :N])
        # collapse: bit b set when block b of a PVQ leaf has energy
        blk = torch.where(n[:, :, None] > 0,
                          (jw * bl[:, :, None]) // n.clamp(min=1)[:, :, None],
                          0)
        nz = (v != 0) & mask
        hit = ((blk[..., None] == blocks8) & nz[..., None]).any(2)
        cm_pvq = (hit.to(torch.int64) << blocks8).sum(-1)
        cm_q0 = torch.where(f2 == 0, 0,
                            torch.where(has_lb[:, None], f2, cmask))
        cm = torch.where(k > 0, torch.where(bl > 1, cm_pvq, 1), cm_q0)
        cm = torch.where(active, cm, 0)
        cm_acc = _or_reduce(_shl(cm, cms), 1)
        # advance the seed by the band's draws
        tot = (prefix[:, -1] + draws[:, -1]).clamp(0, LCG_MAX)
        seed = (mul32(seed, ja[tot]) + jb[tot]) & M32
        # upward transforms and cm post-map from the configuration banks
        X = torch.bmm(banks["post_bands"][i][cfg], X[:, :, None])[:, :, 0]
        cmv = _apply_cols16(cmb[i][cfg], cm_acc) & bmb[i][cfg]
        collapse[:, i] = torch.where(present, cmv, collapse[:, i])
        spec[:, a:a + N] = torch.where(present[:, None], X, spec[:, a:a + N])
        wn = (present & (b["last"] == 0))[:, None]
        norm[:, a:a + N] = torch.where(wn, banks["sq"][i] * X,
                                       norm[:, a:a + N])
    return spec, i64_to_u32(seed), i64_to_u32(collapse)


def run_frames_cuda(bt: dict, lt: dict, seed0):
    """K13 on the card: the same tensors as run_frames_plain, all F frames
    in one launch (a cluster of four CTAs a frame)."""
    dev = lt["vec"].device
    F = lt["vec"].shape[0]
    if dev.type != "cuda":  # before the library is asked for its cluster
        raise ValueError(f"{K13.symbol}: every tensor must be on one CUDA "
                         f"device, got {dev}")
    if (lt["vec"].shape[1:] != (NBANDS, SLOTS, W)
            or lt["vec"].dtype != torch.float32
            or lt["gain"].dtype != torch.float32
            or lt["gain"].shape != (F, NBANDS, SLOTS)
            or lt["fill_cols"].dtype != torch.uint32
            or lt["fill_cols"].shape != (F, NBANDS, SLOTS, 16)
            or seed0.dtype != torch.uint32 or seed0.shape != (F,)):
        raise ValueError("K13 takes convert.packed_frame's tensors and "
                         "seeds uint32 [F]")
    fields = [bt[key] for key in BT_KEYS] + [lt[key] for key in LT_INTS]
    shapes = [(F, NBANDS)] * len(BT_KEYS) + [(F, NBANDS, SLOTS)] * len(LT_INTS)
    if any(t.dtype != torch.int32 or t.device != dev or tuple(t.shape) != sh
           for t, sh in zip(fields, shapes)):
        raise ValueError("K13 takes the packed tables' fields as int32 "
                         "[F, 21] / [F, 21, 16] on the tables' device")
    fields = [aligned(t) for t in fields]
    ptrs = (ctypes.c_void_p * len(fields))(*(t.data_ptr() for t in fields))
    banks = device_banks(dev)
    post, pre = k13_banks(dev, k13_cluster())
    spec = torch.empty((F, NBINS), dtype=torch.float32, device=dev)
    seed = torch.empty(F, dtype=torch.uint32, device=dev)
    collapse = torch.empty((F, NBANDS), dtype=torch.uint32, device=dev)
    if F:
        K13(ctypes.addressof(ptrs), aligned(lt["gain"]),
            aligned(lt["fill_cols"]), aligned(lt["vec"]),
            contiguous(seed0), post, pre, banks["cm"], banks["bm"],
            banks["sq"], F, spec, seed, collapse)
    return spec, seed, collapse


def _seeds(seed0, F: int, device) -> torch.Tensor:
    if isinstance(seed0, torch.Tensor):
        s = seed0.reshape(-1)
        if s.dtype != torch.uint32:
            s = i64_to_u32(s.to(torch.int64))
        return s.to(device)
    s = np.atleast_1d(np.asarray(seed0, np.int64) & M32).astype(np.uint32)
    if s.shape != (F,):
        raise ValueError(f"run_frame: {F} frames and {s.shape} seeds")
    return torch.from_numpy(s).to(device)


def run_frame(bt, lt, seed0, device="cuda"):
    """Execute packed mono frames (long-block or transient). bt, lt:
    pack_tensors' numpy dicts of one frame (or sequences of them, a
    frame each), sent to `device`; or convert.packed_frame's tensors,
    which keep their device. seed0: each frame's entry seed. Returns
    (spec [F, NBINS] f32, seed_out [F] u32, collapse [F, NBANDS] u32),
    the frame axis dropped for one frame's numpy dicts."""
    one = isinstance(bt, dict) and isinstance(bt["present"], np.ndarray)
    if isinstance(bt, dict) and isinstance(bt["present"], torch.Tensor):
        dev = bt["present"].device
    else:
        dev = resolve_device(device)
        bt, lt = packed_frame(bt, lt, dev)
    seeds = _seeds(seed0, lt["vec"].shape[0], dev)
    run = run_frames_cuda if dev.type == "cuda" else run_frames_plain
    spec, seed, collapse = run(bt, lt, seeds)
    if one:
        return spec[0], seed[0], collapse[0]
    return spec, seed, collapse
