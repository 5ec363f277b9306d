"""The port's device CELT entropy stages against the JAX package's and
the native decoder's taps, on the CPU (the kernels' plain twins).

- cwrsi_batch (K11's twin): exactly equal to the JAX function and the
  native walk (host_reference) on the JAX tests' random corpus of 4,096
  leaves and its edges (tests/test_device_cwrsi.py), and on the 7,751
  leaves the native decoder taps from the Opus sample, in both layouts and
  at n_max < 96;
- normalize_pulses / apply_rotations / reconstruct (K12's twin): within
  rel 1e-6 of each row's largest |x| of the JAX functions (the matvec sums
  in another order), and reconstruct within rel 1e-5 of the native leaf
  tap's first 32 coefficients (tests/test_device_leaf.py's bar), with
  rotating and non-rotating leaves both present; the LCG functions
  exactly equal to the JAX ones and the host's sequential walk;
- run_frame (K13's twin) on all 32 mono frames of the sample: within rel
  2e-5 of the spectrum's peak of the tap's X and of
  band_pack.packed_replay_frame (the replays' bar,
  tests/test_band_replay.py), the seed out equal to the emitted end seed
  and the collapse masks equal to the tap's; against the JAX run_frame
  run eagerly (jax.disable_jit: the jitted program takes minutes to
  compile) on a long-block and a transient frame, within rel 2e-5 with
  the seed and collapse masks equal.

The JAX cwrsi calls are padded to one leaf count, so that its jitted walk
compiles once for the default layout.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iamf_tpu.codecs.opus import device_bands as jdb
from iamf_tpu.codecs.opus import device_cwrsi as jdc
from iamf_tpu.codecs.opus import device_leaf as jdl
from iamf_tpu_torch import convert
from iamf_tpu_torch.codecs.opus import band_pack
from iamf_tpu_torch.codecs.opus import device_bands as db
from iamf_tpu_torch.codecs.opus import device_cwrsi as dc
from iamf_tpu_torch.codecs.opus import device_leaf as dl
from iamf_tpu_torch.tools import celt_taps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "iamf_tpu", "data", "sample_opus_714.iamf")
JAX_L = 8192  # the JAX cwrsi's leaf count (its reconstruct pads to it)


@pytest.fixture(scope="module")
def taps():
    return celt_taps.tap_stream(open(SAMPLE, "rb").read())


@pytest.fixture(scope="module")
def leaves(taps):
    return celt_taps.all_leaves(taps)


@pytest.fixture(scope="module")
def recon(leaves):
    """The port's leaf vectors of every tapped leaf (numpy)."""
    return dl.reconstruct(*leaves[:6], device="cpu").numpy()


@pytest.fixture(scope="module")
def mono(taps, recon):
    """The mono frames: (frame, packed frame, bt, lt, leaf vectors)."""
    out, off = [], 0
    for f in taps:
        L = len(f.leaves[0])
        vecs = recon[off:off + L]
        off += L
        if f.tap_C != 1:
            continue
        pf = band_pack.pack_frame(f.recs)
        assert db.packable(pf)
        bt, lt = db.pack_tensors(pf, list(vecs))
        out.append((f, pf, bt, lt, vecs))
    return out


def _tensors(n, k, idx):
    return (torch.from_numpy(np.asarray(n, np.int32)),
            torch.from_numpy(np.asarray(k, np.int32)),
            torch.from_numpy(np.asarray(idx, np.uint32)))


def _jax_cwrsi(n, k, idx, **kw):
    """The JAX cwrsi_batch, padded to JAX_L leaves (n=2, k=1, idx=0)
    unless other static arguments are given."""
    L = len(n)
    P = JAX_L if not kw else L
    pn = np.full(P, 2, np.int32)
    pk = np.ones(P, np.int32)
    pi = np.zeros(P, np.uint32)
    pn[:L], pk[:L], pi[:L] = n, k, idx
    return np.asarray(jdc.cwrsi_batch(jnp.asarray(pn), jnp.asarray(pk),
                                      jnp.asarray(pi), **kw))[:L]


def _corpus(case, leaves):
    if case == "random":
        return celt_taps.random_leaves(np.random.default_rng(11), 4096)
    if case == "edges":
        return celt_taps.edge_leaves()
    return leaves[0], leaves[1], leaves[2]


def _row_rel(a, b):
    """max over rows of max|a - b| / max|b| of the row."""
    scale = np.maximum(np.abs(b).max(axis=1), 1e-30)
    return float((np.abs(a - b).max(axis=1) / scale).max())


# ---- the copies and the tables -------------------------------------------

@pytest.mark.parametrize("path", ["codecs/opus/band_replay.py",
                                  "codecs/opus/band_pack.py",
                                  "utils/logging.py"])
def test_copies_identical(path):
    assert filecmp.cmp(os.path.join(ROOT, "iamf_tpu", path),
                       os.path.join(ROOT, "iamf_tpu_torch", path),
                       shallow=False)


def test_tables_match_jax(mono):
    """The numpy tables the port copies equal the JAX package's: the
    CWRS rows, the LCG jump tables, the configuration banks and a frame's
    packed tensors; K13's band table (csrc/celt_bands.cu) is EBANDS."""
    assert np.array_equal(dc.u_rows(), jdc.u_rows())
    for a, b in zip(dl.lcg_jump_tables(), jdl.lcg_jump_tables()):
        assert np.array_equal(a, b)
    for a, b in zip(db.cfg_banks(), jdb.cfg_banks()):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    f, pf, bt, lt, vecs = mono[0]
    jbt, jlt = jdb.pack_tensors(pf, list(vecs))
    for mine, theirs in ((bt, jbt), (lt, jlt)):
        assert mine.keys() == theirs.keys()
        for key in mine:
            assert np.array_equal(mine[key], theirs[key]), key
    src = open(os.path.join(ROOT, "iamf_tpu_torch", "csrc",
                            "celt_bands.cu")).read()
    body = src.split("EBANDS[NBANDS + 1] = {")[1].split("}")[0]
    from iamf_tpu_torch.codecs.opus.band_replay import EBANDS

    assert [int(v) for v in body.split(",")] == list(EBANDS)


# ---- K11: cwrsi ------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "edges", "sample"])
def test_cwrsi_matches_jax_and_native(case, leaves):
    n, k, idx = _corpus(case, leaves)
    if case == "sample":
        assert len(n) == 7751
    got = dc.cwrsi_batch(*_tensors(n, k, idx))
    assert got.dtype == torch.int32 and got.shape == (len(n), dc.N_MAX)
    got = got.numpy()
    assert np.array_equal(got, dc.host_reference(n, k, idx))
    assert np.array_equal(got, _jax_cwrsi(n, k, idx))


@pytest.mark.parametrize("align,n_max", [(False, 96), (True, 24),
                                         (False, 24)])
def test_cwrsi_layouts_and_n_max(align, n_max, leaves):
    """The walk-order layout and a walk bounded at n_max < 96, on the
    sample's leaves of n <= n_max, against the JAX function; the aligned
    rows against the native walk."""
    n, k, idx = leaves[:3]
    sel = n <= n_max
    n, k, idx = n[sel], k[sel], idx[sel]
    assert len(n) > 1000
    got = dc.cwrsi_batch(*_tensors(n, k, idx), align=align,
                         n_max=n_max).numpy()
    want = _jax_cwrsi(n, k, idx, align=align, n_max=n_max)
    assert got.shape == want.shape == (len(n), n_max)
    assert np.array_equal(got, want)
    if align:
        assert np.array_equal(got, dc.host_reference(n, k, idx)[:, :n_max])


# ---- K12: normalization, rotation, reconstruction, the LCG -----------------

def test_normalize_and_rotate_match_jax(leaves):
    n, k, idx, gain, spread, blocks, _ = leaves
    y = dc.cwrsi_batch(*_tensors(n, k, idx))
    g = torch.from_numpy(gain)
    X = dl.normalize_pulses(y, g).numpy()
    jX = np.asarray(jdl.normalize_pulses(jnp.asarray(y.numpy()),
                                         jnp.asarray(gain)))
    assert _row_rel(X, jX) <= 1e-6
    cfg, bank = dl.rotation_plan(n, k, spread, blocks)
    sel = np.flatnonzero(cfg >= 0)
    assert 0 < len(sel) < len(n)
    R = dl.apply_rotations(torch.from_numpy(jX[sel]),
                           torch.from_numpy(cfg[sel]),
                           torch.from_numpy(bank)).numpy()
    jR = np.asarray(jdl.apply_rotations(jnp.asarray(jX[sel]),
                                        jnp.asarray(cfg[sel]),
                                        jnp.asarray(bank)))
    assert _row_rel(R, jR) <= 1e-6
    # the fused form (K12's one launch) equals the two steps' twins
    F = dl.normalize_rotate(y, g, torch.from_numpy(cfg),
                            torch.from_numpy(bank)).numpy()
    want = X.copy()
    want[sel] = dl.apply_rotations(torch.from_numpy(X[sel]),
                                   torch.from_numpy(cfg[sel]),
                                   torch.from_numpy(bank)).numpy()
    assert np.array_equal(F, want)


def test_reconstruct_matches_jax_and_tap(leaves, recon):
    n, k, idx, gain, spread, blocks, xo = leaves
    assert recon.shape == (len(n), dc.N_MAX) and recon.dtype == np.float32
    want = jdl.reconstruct(n, k, idx, gain, spread, blocks)
    assert _row_rel(recon, want) <= 1e-6
    W = celt_taps.LEAF_X
    mask = np.arange(W)[None, :] < np.minimum(n, W)[:, None]
    a = np.where(mask, xo[:, :W], 0)
    b = np.where(mask, recon[:, :W], 0)
    scale = np.maximum(np.abs(a).max(axis=1, keepdims=True), 1e-3)
    assert (np.abs(a - b) / scale).max() < 1e-5
    rot = dl.needs_rotation(n, k, spread)
    assert rot.any() and (~rot).any()  # both paths exercised


def test_rotation_matrix_matches_sequential():
    """tests/test_device_leaf.py's check on the port's rotation_matrix:
    the matrix form against the native sequential rotation."""
    import ctypes

    rng = np.random.default_rng(5)
    lib = dl._native()
    for (n, k, spread, blocks) in ((44, 4, 1, 1), (18, 5, 2, 1),
                                   (8, 2, 3, 2), (96, 10, 1, 1)):
        m = dl.rotation_matrix(n, k, spread, blocks)
        assert np.array_equal(m, jdl.rotation_matrix(n, k, spread, blocks))
        v = rng.normal(0, 1, n).astype(np.float32)
        want = v.copy()
        lib.iamf_exp_rotation(
            want.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, -1, blocks, k, spread)
        np.testing.assert_allclose(m @ v, want, rtol=2e-5, atol=2e-6)


def test_lcg_matches_jax_and_host():
    """Entry seeds by prefix jump-ahead and each leaf's draws, exactly
    equal to the JAX functions and the host's sequential celt_lcg_rand
    walk (tests/test_device_leaf.py's case), and clipped where the
    prefix passes LCG_MAX as the JAX function clips."""

    def host_lcg(seed, n):
        out, s = [], int(seed)
        for _ in range(n):
            s = (1664525 * s + 1013904223) & 0xFFFFFFFF
            out.append(s)
        return np.array(out, np.uint32), np.uint32(s)

    rng = np.random.default_rng(9)
    draws = rng.choice([0, 0, 0, 4, 8, 16, 22, 176], size=40).astype(
        np.int32)
    frame_seed = np.uint32(0xDEADBEEF)
    seed, host_entry, host_vals = frame_seed, [], []
    for d in draws:
        host_entry.append(seed)
        v, seed = host_lcg(seed, int(d))
        host_vals.append(v)
    entry = dl.lcg_leaf_entry_seeds(int(frame_seed), torch.from_numpy(draws))
    assert entry.dtype == torch.uint32
    entry = entry.numpy()
    np.testing.assert_array_equal(entry, np.array(host_entry, np.uint32))
    np.testing.assert_array_equal(entry, np.asarray(jdl.lcg_leaf_entry_seeds(
        jnp.uint32(frame_seed), jnp.asarray(draws))))
    vals = dl.lcg_noise_fill(torch.from_numpy(entry), None, 176).numpy()
    for i, d in enumerate(draws):
        np.testing.assert_array_equal(vals[i, :d], host_vals[i])
    np.testing.assert_array_equal(vals, np.asarray(jdl.lcg_noise_fill(
        jnp.asarray(entry), jnp.asarray(draws), 176)))
    # past LCG_MAX draws the prefix clips (the JAX function's jnp.clip)
    big = rng.integers(0, 700, size=50).astype(np.int32)
    np.testing.assert_array_equal(
        dl.lcg_leaf_entry_seeds(torch.tensor(7, dtype=torch.int64),
                                torch.from_numpy(big)).numpy(),
        np.asarray(jdl.lcg_leaf_entry_seeds(jnp.uint32(7),
                                            jnp.asarray(big))))


# ---- K13: the band walk ----------------------------------------------------

def test_run_frame_sample_matches_tap_and_replay(mono):
    """All 32 mono frames of the sample in one call (a frame axis)."""
    assert len(mono) == 32 and sum(m[0].transient for m in mono) == 2
    spec, seed, collapse = db.run_frame(
        [m[2] for m in mono], [m[3] for m in mono],
        [m[1].seed0 for m in mono], device="cpu")
    assert spec.shape == (32, db.NBINS) and spec.dtype == torch.float32
    assert seed.dtype == collapse.dtype == torch.uint32
    spec, seed, collapse = spec.numpy(), seed.numpy(), collapse.numpy()
    for j, (f, pf, bt, lt, vecs) in enumerate(mono):
        want = f.X[0]
        scale = max(np.abs(want).max(), 1e-3)
        assert np.abs(spec[j] - want).max() / scale < 2e-5, j
        rep = band_pack.packed_replay_frame(pf, list(vecs))[0]
        assert np.abs(spec[j] - rep).max() / scale < 2e-5, j
        assert int(seed[j]) == f.seed_out, j
        present = bt["present"] > 0
        assert np.array_equal(collapse[j][present], f.collapse[0][present])
        assert not collapse[j][~present].any()


def test_run_frame_one_frame_and_tensors(mono):
    """One frame's numpy dicts give the frame without its axis, equal to
    the same frame in a batch's tensors (convert.packed_frame)."""
    f, pf, bt, lt, _ = mono[5]
    spec, seed, collapse = db.run_frame(bt, lt, pf.seed0, device="cpu")
    assert spec.shape == (db.NBINS,) and collapse.shape == (db.NBANDS,)
    tbt, tlt = convert.packed_frame([bt, mono[6][2]], [lt, mono[6][3]], "cpu")
    assert tbt["present"].shape == (2, db.NBANDS)
    assert tlt["fill_cols"].dtype == torch.uint32
    assert tlt["vec"].shape == (2, db.NBANDS, db.SLOTS, db.W)
    s2, se2, c2 = db.run_frame(tbt, tlt, torch.tensor(
        [pf.seed0, mono[6][1].seed0], dtype=torch.int64))
    scale = float(spec.abs().max())
    assert float((s2[0] - spec).abs().max()) / scale < 2e-5
    assert int(se2[0]) == int(seed) == f.seed_out
    assert torch.equal(c2[0], collapse)


@pytest.mark.parametrize("which", ["long", "transient"])
def test_run_frame_matches_eager_jax(which, mono):
    """The JAX run_frame, run op by op (jax.disable_jit), on the same
    packed tensors."""
    j = next(i for i, m in enumerate(mono)
             if m[0].transient == (which == "transient"))
    f, pf, bt, lt, _ = mono[j]
    with jax.disable_jit():
        jspec, jseed, jcoll = jdb.run_frame(bt, lt, pf.seed0)
    jspec = np.asarray(jspec)
    spec, seed, collapse = db.run_frame(bt, lt, pf.seed0, device="cpu")
    scale = max(np.abs(jspec).max(), 1e-3)
    assert np.abs(spec.numpy() - jspec).max() / scale < 2e-5
    assert int(seed) == int(np.uint32(jseed)) == f.seed_out
    assert np.array_equal(collapse.numpy(), np.asarray(jcoll, np.uint32))
