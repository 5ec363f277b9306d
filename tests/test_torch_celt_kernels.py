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
  none when no leaf rotates, held to rotation_plan's cfg;
- K11's warp search (csrc/celt_cwrsi.cu: lane l holds entries
  j = l + 32 r of a row and of the next; the j <= upper with row[j] <= i
  counted by a warp sum, row[c - 1], next[c - 1] and next[c] by warp
  maxima and a minimum over the lanes' own entries) equals the twin's
  searchsorted search and its row reads on every row of u_rows(), for i
  at each entry, each entry +-1, 0 and 0xFFFFFFFF and every upper in
  [-1, 131], with five entries a lane and with as few as the kernel
  holds; the whole warp walk on that search (the lots-of-pulses and
  lots-of-dimensions cases as selects) equals cwrsi_plain bit for bit on
  the random corpus, the edges, the sample's leaves and leaves outside
  the walk's range; K11's grid takes every leaf once.
"""

import os
import re

import numpy as np
import pytest
import torch

from iamf_tpu_torch.codecs.opus import band_pack
from iamf_tpu_torch.codecs.opus import device_bands as db
from iamf_tpu_torch.codecs.opus import device_cwrsi as dc
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


# ---- K11: the warp search and walk ------------------------------------------

M32 = 0xFFFFFFFF
K11_J = np.arange(5)[:, None] * 32 + np.arange(32)[None, :]  # [r, lane]


def _k11_R(k):
    """K11's R for leaves of k pulses: (k + 1) / 32 + 1 rows of lanes."""
    k = np.asarray(k, np.int64)
    return np.where(k < 0, 0, np.minimum(k + 1, dc.U_MAX_K - 1)) // 32 + 1


def _k11_held(k):
    """[..., 5, 32]: the entries j = lane + 32 r a lane holds for a leaf of
    k pulses (j < 132, r < R)."""
    r = np.arange(5)[:, None]
    return (K11_J < dc.U_MAX_K) & (r < _k11_R(k)[..., None, None])




def _at(row, v):
    """row[..., v], 0 where v is outside [0, 132): a read of the rows (row
    [132] or [..., 132], v int [...])."""
    v = np.asarray(v, np.int64)
    row = np.broadcast_to(row, v.shape + (dc.U_MAX_K,))
    got = np.take_along_axis(row, np.clip(v, 0, dc.U_MAX_K - 1)[..., None],
                             -1)[..., 0]
    return np.where((v >= 0) & (v < dc.U_MAX_K), got, 0).astype(np.uint32)


def k11_search(row, nxt, i, upper, held):
    """K11's search as its warp computes it: row and nxt u32 [132] or
    [..., 132] (rows d and d - 1), i u32 and upper int [...], held bool
    [..., 5, 32] (the entries j = lane + 32 r the lanes hold). For each r,
    the ballot of j <= upper & row[j] <= i over the lanes; c is the sum of
    the ballots' popcounts, the j counted being a prefix [0, c). Returns
    (c, row[c - 1], nxt[c - 1], nxt[c]), the reads 0 outside the row."""
    e = np.asarray(row)[..., np.minimum(K11_J, dc.U_MAX_K - 1)]
    i = np.asarray(i, np.uint32)[..., None]
    upper = np.asarray(upper, np.int64)[..., None]
    c = 0
    for r in range(5):
        q = held[..., r, :] & (K11_J[r] <= upper) & (e[..., r, :] <= i)
        ballot = (q.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
            -1).astype(np.uint32)
        c = c + np.bitwise_count(ballot).astype(np.int64)
    return c, _at(row, c - 1), _at(nxt, c - 1), _at(nxt, c)


def k11_zero_run(rows, d, kk, i):
    """K11's run of zero steps from dimension d (each leaf's step at d is
    one): lane l tests dimension d - l with i less the prefix sum (u32) of
    row[kk] over the lanes before it; the first lane that fails ends the
    run. Returns (F, i, row[kk], row[kk + 1]) after the F zero steps, the
    reads those of dimension d - F (lane F's; lane 31's where F = 32)."""
    dl = d[:, None] - np.arange(32)[None, :]
    rl = rows[np.maximum(dl, 2)]                          # [L, 32, 132]
    a = np.take_along_axis(rl, kk[:, None, None], -1)[..., 0]
    b = np.take_along_axis(rl, kk[:, None, None] + 1, -1)[..., 0]
    incl = np.cumsum(a, axis=1, dtype=np.uint32)
    il = i[:, None] - (incl - a)
    fail = ~((dl > 2) & (kk[:, None] < dl) & (a <= il) & (il < b))
    F = np.where(fail.any(1), fail.argmax(1), 32)
    src = np.minimum(F, 31)[:, None]
    i = np.where(F < 32, np.take_along_axis(il, src, 1)[:, 0],
                 i - incl[:, 31])
    return (F, i, np.take_along_axis(a, src, 1)[:, 0],
            np.take_along_axis(b, src, 1)[:, 0])


def _look(row, v):
    """cwrsi_plain's read row[v], 0 outside the row (device_cwrsi.look)."""
    return dc.look(torch.from_numpy(row.astype(np.int64)),
                   torch.from_numpy(v)).numpy()


@pytest.mark.parametrize("held", ["all", "fewest"])
def test_k11_warp_search_equals_searchsorted(held):
    """K11's search on every row of u_rows(), for i at each entry, each
    entry +-1, 0 and 0xFFFFFFFF and every upper in [-1, 131]: the count
    less one is searchsorted's k' and the three reductions are row[k'],
    next[k'] and next[k' + 1], with five entries a lane ("all") and with
    the fewest the kernel holds for a leaf whose k bounds upper
    ("fewest": k = upper)."""
    rows = dc.u_rows()
    uppers = np.arange(-1, 132)
    for d in range(dc.N_MAX + 1):
        row, nxt = rows[d], rows[max(d - 1, 0)]
        v = row.astype(np.int64)
        iv = np.unique(np.concatenate([v, v + 1, v - 1, [0, M32]]))
        iv = iv[(iv >= 0) & (iv <= M32)].astype(np.uint32)
        i, up = (a.ravel() for a in np.meshgrid(iv, uppers, indexing="ij"))
        h = (_k11_held(np.full(len(up), 131)) if held == "all"
             else _k11_held(up))
        c, mx, nmx, nmn = k11_search(row, nxt, i, up, h)
        kn = dc.search(torch.from_numpy(v), torch.from_numpy(
            i.astype(np.int64)), torch.from_numpy(up)).numpy()
        assert np.array_equal(c - 1, kn), d
        assert np.array_equal(mx, _look(row, kn)), d
        assert np.array_equal(nmx, _look(nxt, kn)), d
        assert np.array_equal(nmn, _look(nxt, kn + 1)), d


def _sd(k0, k, s):
    """(int)(((u32)k0 - (u32)k + (u32)s) ^ (u32)s)."""
    return (((k0 - k + s) & M32) ^ (s & M32)).astype(np.uint32).view(
        np.int32).astype(np.int64)


def k11_model(n, k, idx, align=True, n_max=dc.N_MAX, runs=True):
    """numpy model of K11's warp walk, every leaf at once, each at its own
    dimension d from min(n, n_max) down to 3: a pass is a run of zero
    steps (k11_zero_run) where the step at d is one and `runs`, else one
    step, its upper bound selected from the lots-of-pulses and
    lots-of-dimensions cases and its search k11_search; the state is kk, i
    and p0 = row[kk], p1 = row[kk + 1]. Then the closed forms of n = 2
    and n = 1 and the layout."""
    rows = dc.u_rows()
    n = np.asarray(n, np.int64)
    kk = np.asarray(k, np.int64).copy()
    i = np.asarray(idx, np.uint32).copy()
    held = _k11_held(kk)
    d = np.minimum(n, n_max)
    ys = np.zeros((len(n), n_max), np.int64)
    at = rows[np.clip(d, 0, n_max)]
    p0, p1 = _at(at, kk), _at(at, kk + 1)
    while (d > 2).any():
        act = d > 2
        run = act & (kk < d) & (p0 <= i) & (i < p1) & runs
        step = act & ~run
        if run.any():
            F, ir, a, b = k11_zero_run(rows, d[run], kk[run], i[run])
            dr = d[run] - F
            at = rows[np.clip(dr, 0, n_max)]
            kr = kk[run]
            i[run] = ir
            p0[run] = np.where(F < 32, a, _at(at, kr))
            p1[run] = np.where(F < 32, b, _at(at, kr + 1))
            d[run] = dr
        if step.any():
            ds, ks, i_s = d[step], kk[step], i[step]
            row, nxt = rows[ds], rows[ds - 1]
            s = i_s >= p1[step]
            ix = np.where(s, i_s - p1[step], i_s)
            ge = ks >= ds
            zero = ~ge & ~s & (p0[step] <= i_s)
            rd = rows[ds, ds]
            upper = np.where(ge, np.where(rd > ix, ds - 1, ks),
                             np.where(zero, ks, ks - 1))
            c, mx, nmx, nmn = k11_search(row, nxt, ix, upper, held[step])
            ys[np.flatnonzero(step), n_max - ds] = _sd(ks, c - 1,
                                                       -s.astype(np.int64))
            kk[step], i[step] = c - 1, ix - mx
            p0[step], p1[step] = nmx, nmn
            d[step] = ds - 1
    # n == 2
    p = ((2 * kk + 1) & M32).astype(np.uint32)
    s2 = i >= p
    i = np.where(s2, i - p, i)
    k0 = kk
    kk = ((i.astype(np.int64) + 1) & M32) >> 1
    i = np.where(kk > 0, i - ((2 * kk - 1) & M32).astype(np.uint32), i)
    ys[:, n_max - 2] = _sd(k0, kk, -s2.astype(np.int64))
    # n == 1 (C: s = -(int)i)
    si = -i.view(np.int32).astype(np.int64)
    ys[:, n_max - 1] = _sd(kk, 0, si)
    ys = ys.astype(np.int32)
    if not align:
        return ys
    j = np.arange(n_max)[None, :]
    src = np.clip(n_max - n[:, None] + j, 0, n_max - 1)
    return np.where(j < n[:, None], np.take_along_axis(ys, src, 1), 0)


def _k11_leaves(case, sample):
    """(n, k, idx) of a K11 corpus: celt_taps' random leaves (4,096, seed
    11) and edges, the sample's leaves, and leaves outside the walk's
    range (n in [-3, 110), k in [-3, 140), any index)."""
    from iamf_tpu_torch.tools import celt_taps

    if case == "sample":
        return sample[0][:3]
    if case == "random":
        return celt_taps.random_leaves(np.random.default_rng(11), 4096)
    if case == "edges":
        return celt_taps.edge_leaves()
    rng = np.random.default_rng(5)
    return (rng.integers(-3, 110, 600).astype(np.int32),
            rng.integers(-3, 140, 600).astype(np.int32),
            rng.integers(0, 1 << 32, 600, dtype=np.uint64).astype(np.uint32))


@pytest.mark.parametrize("runs", [True, False])
@pytest.mark.parametrize("n_max", [96, 24])
@pytest.mark.parametrize("case", ["random", "edges", "sample", "outside"])
def test_k11_warp_walk_matches_twin(case, n_max, runs, sample):
    """k11_model, with the runs of zero steps and a step a dimension, bit
    for bit equal to cwrsi_plain, both layouts."""
    n, k, idx = _k11_leaves(case, sample)
    tn, tk = torch.from_numpy(n), torch.from_numpy(k)
    ti = torch.from_numpy(idx.view(np.int32)).view(torch.uint32)
    for align in (True, False):
        want = dc.cwrsi_plain(tn, tk, ti, align, n_max).numpy()
        assert np.array_equal(k11_model(n, k, idx, align, n_max, runs), want)


