"""numpy models of what K12 and K13 (csrc/celt_leaf.cu, csrc/celt_bands.cu)
compute in another form than the plain twins, held to the twins' forms on
the CPU, and the frames that K13's card tests add to the sample's: the
kernels run only on the card (tests/test_torch_cuda.py).

- K13's placement is a gather (target bin t takes bin (t - off) mod N of
  each active slot, in slot order, with C's remainder): np.array_equal to
  run_frames_plain's scatter_add in slot order, on the Opus sample's 32
  mono frames and on random offsets (negative and >= N);
- K13's banks (device_bands.row_parts: a CTA's rows, [u][row][r]) read
  as the kernel reads them give each matrix, and a row's four partials
  through them equal the block-a-frame design's thread-a-row form on the
  transposed banks bit for bit, at 2 and 4 CTAs a cluster;
- synthetic_frames, packed mono frames made from a seed that reach what
  the sample's frames do not (a band's LCG draws far along, n = 1 and
  n above the band's width, offsets outside [0, N), windows past the norm
  buffer, k = -1, inactive slots between active ones, absent and last
  bands): the twin on them within rel 2e-5 of the JAX run_frame (run op
  by op), seeds and collapse masks equal; the card tests hold K13 to the
  twin on them;
- K12's grouping (a block a configuration: the cfg entries scanned eight
  a thread, a block scan of the counts, the list flushed when full) gives
  each configuration its leaves in leaf order, every rotating leaf once,
  none when no leaf rotates, held to rotation_plan's cfg.
"""

import os
import re

import numpy as np
import pytest
import torch

from iamf_tpu_torch.codecs.opus import band_pack
from iamf_tpu_torch.codecs.opus import device_bands as db
from iamf_tpu_torch.codecs.opus import device_leaf as dl
from iamf_tpu_torch.tools import celt_taps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "iamf_tpu_torch", "csrc")
SAMPLE = os.path.join(ROOT, "iamf_tpu", "data", "sample_opus_714.iamf")
F32 = np.float32


def _constant(file: str, name: str) -> int:
    """`constexpr int NAME = <int>;` of a kernel source."""
    src = open(os.path.join(CSRC, file)).read()
    hits = re.findall(rf"constexpr int {name} = (\d+);", src)
    assert len(hits) == 1, name
    return int(hits[0])


@pytest.fixture(scope="module")
def sample():
    """The sample's leaves (n, k, idx, gain, spread, blocks) and its 32
    mono frames' packed tables (bt, lt) on the twin's leaf vectors."""
    frames = celt_taps.tap_stream(open(SAMPLE, "rb").read())
    leaves = celt_taps.all_leaves(frames)[:6]
    vecs = dl.reconstruct(*leaves, device="cpu").numpy()
    bts, lts, off = [], [], 0
    for f in frames:
        L = len(f.leaves[0])
        if f.tap_C == 1:
            bt, lt = db.pack_tensors(band_pack.pack_frame(f.recs),
                                     list(vecs[off:off + L]))
            bts.append(bt)
            lts.append(lt)
        off += L
    return leaves, bts, lts


# ---- K13: the placement ----------------------------------------------------

def _scatter(v, off, active, N):
    """run_frames_plain's placement: v [F, 16, >= N], off [F, 16] int64,
    active [F, 16] -> X [F, N], slot by slot with scatter_add."""
    v, off = torch.from_numpy(v), torch.from_numpy(off)
    jw = torch.arange(N)
    X = torch.zeros((v.shape[0], N), dtype=torch.float32)
    for s in range(v.shape[1]):
        if bool(torch.from_numpy(active[:, s]).any()):
            tgt = (jw[None, :N] + off[:, s, None]) % N
            X = X.scatter_add(1, tgt, torch.where(
                torch.from_numpy(active[:, s])[:, None], v[:, s, :N], 0.0))
    return X.numpy()


def _gather(v, off, active, N):
    """K13's placement: target t adds bin (t - off % N) of each active
    slot (C's remainder, one wrap), in slot order, from an f32 zero."""
    F, S = off.shape
    X = np.zeros((F, N), F32)
    t = np.arange(N)
    for f in range(F):
        for s in range(S):
            if not active[f, s]:
                continue
            src = t - int(np.fmod(off[f, s], N))
            src = np.where(src < 0, src + N, np.where(src >= N, src - N, src))
            X[f] = (X[f] + v[f, s, src]).astype(F32)
    return X


@pytest.mark.parametrize("case", ["sample", "random", "edges"])
def test_k13_placement_gather_equals_scatter(case, sample):
    if case == "sample":  # every band of the 32 frames: their leaf vectors
        _, bts, lts = sample
        for i, N in enumerate(db.band_sizes()):
            N = int(N)
            k = np.stack([lt["k"][i] for lt in lts])
            n = np.stack([lt["n"][i] for lt in lts])
            vec = np.stack([lt["vec"][i] for lt in lts])
            v = np.where(np.arange(db.W) < n[:, :, None], vec, 0).astype(F32)
            off = np.stack([lt["off"][i] for lt in lts]).astype(np.int64)
            active = k > -2
            assert np.array_equal(_gather(v, off, active, N),
                                  _scatter(v, off, active, N)), i
        return
    rng = np.random.default_rng(12)
    for N in (8, 48, 176):
        F = 40
        v = rng.normal(size=(F, db.SLOTS, db.W)).astype(F32)
        v[rng.random(v.shape) < 0.2] = 0  # zeros, of both signs
        v[rng.random(v.shape) < 0.05] = -0.0
        if case == "random":
            off = rng.integers(-3 * N, 3 * N, size=(F, db.SLOTS))
        else:
            off = rng.choice([0, N, -N, N - 1, 1 - N, 2 * N, -1],
                             size=(F, db.SLOTS))
        active = rng.random((F, db.SLOTS)) < 0.7
        assert np.array_equal(_gather(v, off, active, N),
                              _scatter(v, off, active, N)), N


# ---- K13: the banks' layout and a row's sum --------------------------------

@pytest.mark.parametrize("cluster", [2, 4])
def test_k13_row_parts_match_rows(cluster):
    """The banks in K13's layout, read as the kernel reads them (CTA q,
    element (u R + row) 4 + r), give m[q R + row, 4u + r]; a row's four
    partials over them, met as ((p0 + p1) + (p2 + p3)), equal the
    block-a-frame design's thread-a-row sum over the transposed banks
    (mT[j][t]) bit for bit."""
    post, pre, _, _ = db.cfg_banks()
    rng = np.random.default_rng(cluster)

    def rowsum(e, x):  # e [N rows, N/4 u, 4 r]: four partials over u
        acc = np.zeros((e.shape[0], 4), F32)
        for u in range(e.shape[1]):
            acc = (acc + (e[:, u] * x[4 * u:4 * u + 4]).astype(F32)).astype(F32)
        return ((acc[:, 0] + acc[:, 1]).astype(F32)
                + (acc[:, 2] + acc[:, 3]).astype(F32)).astype(F32)

    for bank in (post, pre):
        flat = db.row_parts(bank, cluster)
        mT = np.concatenate([m.transpose(0, 2, 1).reshape(-1) for m in bank])
        base = 0
        for i, N in enumerate(db.band_sizes()):
            N, R = int(N), int(N) // cluster
            row = np.arange(N)[:, None, None]
            u = np.arange(N // 4)[None, :, None]
            r = np.arange(4)[None, None, :]
            for c in rng.choice(len(db.CFGS), 3, replace=False):
                m = bank[i][c]
                part = base + (c * N + (row // R) * R) * N  # CTA q's part
                e = flat[part + (u * R + row % R) * 4 + r]
                assert np.array_equal(e, m.reshape(N, N // 4, 4)), (i, c)
                eT = mT[base + c * N * N + (4 * u + r) * N + row]
                x = rng.normal(size=N).astype(F32)
                got = rowsum(e, x)
                assert np.array_equal(got, rowsum(eT, x)), (i, c)
                np.testing.assert_allclose(got, m.astype(np.float64) @ x,
                                           rtol=1e-5, atol=1e-5)
            base += len(db.CFGS) * N * N


# ---- K13: synthetic frames -------------------------------------------------

SYNTHETIC = ("noise", "pvq", "fold")


def synthetic_frames(kind: str, F: int, seed: int = 12):
    """F packed mono frames (pack_tensors' numpy dicts) and their entry
    seeds, made from `seed`. "noise": no band folds, 16 q0 slots a band of
    n up to 176 (a band's LCG draws up to 2,816 along); "pvq": 1-16 PVQ
    slots of n from 1 to 176, b_leaf up to 16, offsets from -3N to 3N,
    half the bands with a lowband; "fold": a lowband from band 1 on, its
    window anywhere in the norm buffer and past it, slots of k -2, -1, 0
    and 3 mixed, a fifth of the fill maps empty, offsets from 0 to past
    176, absent bands and bands marked last. A fold offset is never
    negative, nor is one that pack_tensors makes: at a negative window
    start the JAX program's dynamic_slice counts from the buffer's end,
    where the port clamps it to 0."""
    rng = np.random.default_rng(seed)
    W, S = db.W, db.SLOTS
    empty = band_pack.PackedFrame(C=1, M=8, norm_offset=0, seed0=0,
                                  bands=[], leaves=[])
    bts, lts = [], []
    for _ in range(F):
        bt, lt = db.pack_tensors(empty, [])
        for i, N in enumerate(db.band_sizes()):
            N = int(N)
            cfg = int(rng.integers(len(db.CFGS)))
            bt["present"][i] = kind != "fold" or rng.random() < 0.9
            bt["cfg_id"][i], bt["B_in"][i] = cfg, db.CFGS[cfg][0]
            bt["has_lb"][i] = (i > 0 and kind == "fold") or (
                kind == "pvq" and rng.random() < 0.5)
            bt["eff"][i] = rng.integers(0, 820)
            bt["fs"][i] = rng.integers(0, i + 1)
            bt["fe"][i] = rng.integers(bt["fs"][i] + 1, i + 2)
            bt["last"][i] = i == db.NBANDS - 1 or (
                kind == "fold" and rng.random() < 0.1)
            if kind == "noise":
                k = np.zeros(S, np.int32)
                n = rng.integers(1, W + 1, S)
                off = rng.integers(-N, 2 * N, S)
            elif kind == "pvq":
                k = np.where(np.arange(S) < rng.integers(1, S + 1),
                             rng.integers(1, 129, S), -2)
                n = rng.choice([1, 2, 3, 5, 8, 11, 16, 33, 88, N, W], S)
                off = rng.integers(-3 * N, 3 * N + 1, S)
            else:
                k = rng.choice([-2, -1, 0, 0, 3], S)
                n = rng.integers(1, min(N + 8, W) + 1, S)
                off = rng.integers(0, W + 6, S)
            lt["k"][i], lt["n"][i], lt["off"][i] = k, n, off
            lt["gain"][i] = rng.uniform(0.05, 1.0, S)
            lt["b_leaf"][i] = rng.choice([1, 2, 3, 4, 5, 8, 16], S)
            lt["cm_shift"][i] = rng.integers(0, 15, S)
            lt["fill_cols"][i] = rng.integers(0, 1 << 32, (S, 16),
                                              dtype=np.uint64)
            lt["fill_cols"][i][rng.random(S) < 0.2] = 0
            vec = rng.normal(size=(S, W)).astype(F32)
            vec[rng.random((S, W)) < 0.3] = 0
            vec[np.arange(W) >= n[:, None]] = 0
            lt["vec"][i] = np.where((k > 0)[:, None], vec, 0)
        bts.append(bt)
        lts.append(lt)
    return bts, lts, [int(x) for x in rng.integers(0, 1 << 32, F)]


@pytest.mark.parametrize("kind", SYNTHETIC)
def test_twin_on_synthetic_frames_matches_jax(kind):
    """run_frame's twin on a synthetic frame within rel 2e-5 of the JAX
    run_frame run op by op (jax.disable_jit), seed and collapse masks
    equal; the frames K13's card tests take."""
    import jax

    from iamf_tpu.codecs.opus import device_bands as jdb

    bts, lts, seeds = synthetic_frames(kind, 1)
    with jax.disable_jit():
        jspec, jseed, jcoll = jdb.run_frame(bts[0], lts[0], seeds[0])
    jspec = np.asarray(jspec)
    spec, seed, coll = db.run_frame(bts[0], lts[0], seeds[0], device="cpu")
    assert np.abs(jspec).max() > 0
    assert np.abs(spec.numpy() - jspec).max() / np.abs(jspec).max() < 2e-5
    assert int(seed) == int(np.uint32(jseed))
    assert np.array_equal(coll.numpy(), np.asarray(jcoll, np.uint32))
    assert coll.numpy().any()


# ---- K12: the grouping -------------------------------------

def _k12_groups(cfg, n_cfg):
    """K12's configuration blocks on cfg: for each block c, the leaves it
    rotates, in its order: each pass scans threads x PER entries, PER a
    thread, the threads' counts scanned into list positions; a full list
    is rotated (flushed) before the pass's leaves join it."""
    threads = _constant("celt_leaf.cu", "NR_WARPS") * 32
    per = _constant("celt_leaf.cu", "PER")
    chunk = threads * per
    out = []
    for c in range(n_cfg):
        done, lst = [], []
        for base in range(0, len(cfg), chunk):
            runs = [[l for l in range(l0, min(l0 + per, len(cfg)))
                     if cfg[l] == c]
                    for l0 in range(base, base + chunk, per)]
            counts = [len(run) for run in runs]
            if len(lst) + sum(counts) > chunk:  # the list is full
                done += lst
                lst = []
            pos = len(lst) + np.concatenate([[0], np.cumsum(counts)[:-1]])
            lst += [None] * sum(counts)
            for p, run in zip(pos, runs):
                lst[p:p + len(run)] = run
        out.append(done + lst)
    return out


def _k12_cfg(case, sample):
    n, k, _, _, spread, blocks = sample[0]
    cfg, bank = dl.rotation_plan(n, k, spread, blocks)
    if case == "sample":
        return cfg, len(bank)
    rng = np.random.default_rng(5)
    if case == "none":
        return np.full(len(cfg), -1, np.int32), 4
    if case == "full":  # one configuration over more than a list holds
        c = rng.choice([-1, 0, 0, 0, 1], size=9000).astype(np.int32)
        return c, 2
    return rng.integers(-1, 40, size=5003).astype(np.int32), 40


@pytest.mark.parametrize("case", ["sample", "none", "full", "random"])
def test_k12_grouping(case, sample):
    cfg, n_cfg = _k12_cfg(case, sample)
    groups = _k12_groups(cfg, n_cfg)
    for c, g in enumerate(groups):
        assert g == list(np.flatnonzero(cfg == c)), c
    flat = sorted(leaf for g in groups for leaf in g)
    assert flat == list(np.flatnonzero((cfg >= 0) & (cfg < n_cfg)))
    if case == "none":
        assert not flat
