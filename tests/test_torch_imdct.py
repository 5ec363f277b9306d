"""K1 (IMDCT + TDAC overlap) of the PyTorch port vs the JAX package.

On the CPU the port runs K1's plain twin (the folded-matrix formula with
torch.matmul); the JAX side runs the Pallas kernel in interpret mode and
the jnp path, as tests/test_opus_pallas.py does. Bound: 0.25 at s16 scale
(1 LSB = 1.0), the bound of tests/test_opus_pallas.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iamf_tpu.codecs.opus import pallas_imdct, tpu_synth
from iamf_tpu_torch.codecs.opus import imdct

BOUND = 0.25


def test_fused_mats_bit_equal():
    for ours, ref in zip(imdct.fused_mats(), pallas_imdct._fused_mats()):
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


PATTERNS = {
    "all-long": lambda rng, B, L: np.zeros((B, L), bool),
    "all-short": lambda rng, B, L: np.ones((B, L), bool),
    "mixed-per-lane": lambda rng, B, L: rng.rand(B, L) < 0.4,
}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_plain_k1_matches_reference(name):
    B, L = 6, 3
    rng = np.random.RandomState(7)
    mats = imdct.FusedMats()
    tail0 = rng.randn(L, 60).astype(np.float32) * 1024.0
    tails = {"pallas": tail0, "jnp": tail0, "port": tail0}
    # two calls, the tail chained from the first into the second
    for _ in range(2):
        freq = rng.randn(B, L, 960).astype(np.float32) * 1000.0
        trans = PATTERNS[name](rng, B, L)
        y_pl, t_pl = pallas_imdct.fused_imdct_overlap(
            jnp.asarray(freq), jnp.asarray(trans),
            jnp.asarray(tails["pallas"]), interpret=True)
        y_j, t_j = tpu_synth._imdct_overlap_jnp(
            jnp.asarray(freq), jnp.asarray(trans), jnp.asarray(tails["jnp"]))
        y_p, t_p = imdct.imdct_overlap(
            mats, torch.from_numpy(freq), torch.from_numpy(trans),
            torch.from_numpy(tails["port"]))
        y_p, t_p = y_p.numpy(), t_p.numpy()
        assert y_p.shape == (B, L, 960) and t_p.shape == (L, 60)
        for y_ref, t_ref in ((y_pl, t_pl), (y_j, t_j)):
            assert np.abs(y_p - np.asarray(y_ref)).max() < BOUND, name
            assert np.abs(t_p - np.asarray(t_ref)).max() < BOUND, name
        tails = {"pallas": np.asarray(t_pl), "jnp": np.asarray(t_j),
                 "port": t_p}


def overlap_taps():
    """The C term of both modes as K1's epilogue (csrc/imdct.cu k1_overlap)
    applies it: y[:, j] += weight[j] * tail_in[:, src[j]] for j < 120."""
    j = np.arange(120)
    return imdct.window120()[119 - j], np.where(j < 60, j, 119 - j)


def test_k1_constants_structure():
    """What K1's design relies on: one C for both modes, with 120 nonzeros
    that the epilogue's taps reproduce, and TF32 splits of W = [A | D | 0]
    that are exact TF32 values and rebuild W to 2^-22."""
    atl, ats, ctl, cts, dtl, dts = imdct.fused_mats()
    assert np.array_equal(ctl, cts)
    weight, src = overlap_taps()
    c = np.zeros((960, 60), np.float32)  # C[output column, tail index]
    c[np.arange(120), src] = weight
    assert np.array_equal(ctl.T, c)  # nonzeros only in columns 0..119
    mats = imdct.FusedMats()
    order = imdct.k_order()
    assert np.array_equal(np.sort(order), np.arange(960))
    assert np.array_equal(order // 32, np.arange(960) // 32)  # within steps
    for mode, (a, d) in (("long", (atl, dtl)), ("short", (ats, dts))):
        w = np.concatenate([a.T, d.T, np.zeros((4, 960), np.float32)])
        w = w[:, order]
        assert np.array_equal(imdct.product_mats()[mode == "short"], w)
        hi = getattr(mats, f"w_{mode}_hi").numpy()
        lo = getattr(mats, f"w_{mode}_lo").numpy()
        for part in (hi, lo):
            assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))
        err = np.abs(hi.astype(np.float64) + lo - w)
        assert np.all(err <= 2.0 ** -22 * np.abs(w.astype(np.float64)))
        assert np.any(lo != 0)


def _emulate_k1(freq, trans, tail0):
    """K1's arithmetic in numpy: the spectra in the product's k order, split
    in TF32 as the kernel splits them; per 32-deep k-step a fresh fp32
    partial, to which each 8-deep slice (one wgmma) adds the exact sums of
    a_hi.b_hi, a_hi.b_lo and a_lo.b_hi in that order; the 30 partials
    summed in fp32; then the 120-tap overlap epilogue in fp32."""
    B, L, _ = freq.shape
    x = freq.reshape(B * L, 960)[:, imdct.k_order()]
    a_hi, a_lo = imdct.split_tf32(x)
    mode = trans.reshape(-1)
    out = np.zeros((B * L, imdct.NOUT), np.float32)
    for m, w in enumerate(imdct.product_mats()):
        rows = np.nonzero(mode == m)[0]
        b_hi, b_lo = imdct.split_tf32(w)
        total = np.zeros((len(rows), imdct.NOUT), np.float32)
        for k0 in range(0, 960, 32):
            part = np.zeros_like(total)
            for k in range(k0, k0 + 32, 8):
                ks = slice(k, k + 8)
                for a, b in ((a_hi, b_hi), (a_hi, b_lo), (a_lo, b_hi)):
                    p = a[rows, ks].astype(np.float64) @ b[:, ks].T.astype(
                        np.float64)
                    part = (part + p).astype(np.float32)
            total = total + part
        out[rows] = total
    y = out[:, :960].reshape(B, L, 960)
    tails = out[:, 960:1020].reshape(B, L, 60)
    tin = np.concatenate([tail0[None], tails[:-1]])
    weight, src = overlap_taps()
    y[..., :120] = y[..., :120] + weight * tin[..., src]
    return y, tails[-1]


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_k1_split_tf32_emulation_matches_reference(name):
    B, L = 6, 3
    rng = np.random.RandomState(11)
    tail0 = rng.randn(L, 60).astype(np.float32) * 1024.0
    tails = {"pallas": tail0, "jnp": tail0, "emu": tail0}
    # two calls, the tail chained from the first into the second
    for _ in range(2):
        freq = rng.randn(B, L, 960).astype(np.float32) * 1000.0
        trans = PATTERNS[name](rng, B, L)
        y_pl, t_pl = pallas_imdct.fused_imdct_overlap(
            jnp.asarray(freq), jnp.asarray(trans),
            jnp.asarray(tails["pallas"]), interpret=True)
        y_j, t_j = tpu_synth._imdct_overlap_jnp(
            jnp.asarray(freq), jnp.asarray(trans), jnp.asarray(tails["jnp"]))
        y_e, t_e = _emulate_k1(freq, trans, tails["emu"])
        assert y_e.dtype == np.float32 and y_e.shape == (B, L, 960)
        for y_ref, t_ref in ((y_pl, t_pl), (y_j, t_j)):
            assert np.abs(y_e - np.asarray(y_ref)).max() < BOUND, name
            assert np.abs(t_e - np.asarray(t_ref)).max() < BOUND, name
        tails = {"pallas": np.asarray(t_pl), "jnp": np.asarray(t_j),
                 "emu": t_e}
