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
