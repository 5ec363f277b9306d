"""K2's CPU model (tests/k2_model.py: phase A's per-segment comb schedule,
phase B's 30-per-lane de-emphasis with a 32-lane scan, in the kernel's
order) against the port's plain twin and the JAX package's
tpu_synth._comb_filter / _deemphasis.

Bounds, per batch of each chain: the comb output z and hist' equal to the
twin's (the comb is bit-exact); PCM <= 1 s16 LSB from the twin and from the
JAX package (the de-emphasis sums in another order than the twin's blocked
matmul); demem' within k2_model.DEMEM_REL of the largest |demem'|, the
bound the twin and the JAX package also keep; phase A's steps per lane as
synth.comb_steps counts them. Each side carries its own hist and demem
from batch to batch.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k2_model
from iamf_tpu.codecs.opus import tpu_synth
from iamf_tpu_torch.codecs.opus import synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_k2(window, y, pk, hist, demem):
    B, L, n = y.shape
    buf = np.concatenate([np.zeros((B, L, n), np.float32), pk], axis=-1)
    p, _ = tpu_synth._unpack(jnp.asarray(buf), n)
    c1, c2, l1, l2 = tpu_synth._comb_coeffs(p)

    def flat(a):
        return a.transpose(1, 0, 2, *range(3, a.ndim)).reshape(
            (L, B * n) + a.shape[3:])

    sig = jnp.asarray(y.transpose(1, 0, 2).reshape(L, B * n))
    z = tpu_synth._comb_filter(sig, jnp.asarray(hist), flat(c1), flat(c2),
                               flat(l1), flat(l2), synth.MINPERIOD - 2)
    hist2 = jnp.concatenate([jnp.asarray(hist), z], axis=1)[:, -synth.HIST:]
    out, demem2 = tpu_synth._deemphasis(z, jnp.asarray(demem))
    s16 = np.rint(np.clip(np.asarray(out), -32768.0, 32767.0))
    pcm = (s16 * np.float32(1 / 32768)).reshape(L, B, n).transpose(1, 0, 2)
    return pcm, np.asarray(hist2), np.asarray(demem2)


@pytest.mark.parametrize("case", sorted(k2_model.CASES))
def test_model_matches_twin_and_jax(case):
    batches, hist0, demem0 = k2_model.inputs(case)
    L = batches[0][0].shape[1]
    window = synth.window120().astype(np.float32)
    w_t = torch.from_numpy(window)
    carry = {k: (hist0.copy(), demem0.copy()) for k in ("m", "t", "j")}
    for y, pk in batches:
        B = y.shape[0]
        buf = torch.from_numpy(np.concatenate(
            [np.zeros_like(y), pk], axis=-1))
        hist, demem = carry["m"]
        pcm_m, hist_m, demem_m, z_m, steps = k2_model.k2(
            window, y, pk, hist, demem)
        hist, demem = carry["t"]
        pcm_t, hist_t, demem_t = synth.comb_deemph_plain(
            w_t, torch.from_numpy(y), buf, torch.from_numpy(hist),
            torch.from_numpy(demem))
        p = synth.unpack(buf, 960)
        flat = [a.transpose(0, 1).reshape((L, B * 960) + tuple(a.shape[3:]))
                for a in synth.comb_coeffs(w_t, p)]
        z_t = synth.comb_filter(torch.from_numpy(y).transpose(0, 1).reshape(
            L, B * 960), torch.from_numpy(hist), *flat)
        pcm_j, hist_j, demem_j = _jax_k2(window, y, pk, *carry["j"])
        hist_t, demem_t = hist_t.numpy(), demem_t.numpy()

        assert np.array_equal(z_m, z_t.numpy())
        assert np.array_equal(hist_m, hist_t)
        assert np.abs(pcm_m - pcm_t.numpy()).max() * 32768 <= 1.0
        assert np.abs(pcm_m - pcm_j).max() * 32768 <= 1.0
        tol = k2_model.DEMEM_REL * max(1.0, float(np.abs(demem_t).max()))
        assert np.abs(demem_m - demem_t).max() <= tol
        assert np.abs(demem_t - demem_j).max() <= tol
        assert np.array_equal(steps, synth.comb_steps(pk))
        carry = {"m": (hist_m, demem_m), "t": (hist_t, demem_t),
                 "j": (hist_j, demem_j)}
    chunks = synth.comb_chunks(np.concatenate([pk for _, pk in batches]))
    if case.startswith("lags_15"):
        # one warp runs every segment with a nonzero gain; one whose gains
        # are all zero is one step
        assert set(np.unique(chunks)) <= set(range(13, 19)) | {120, 720}
        assert (chunks == 13).any()
    for f in k2_model.ZERO_FRAMES.get(case, ()):
        assert np.array_equal(chunks[f], np.tile([120, 120, 720], (L, 1)))


def test_chunks_follow_the_segments():
    """The chunk of each segment is its least lag with a nonzero gain,
    less 2, and is not capped at 32 for long lags."""
    pk = np.zeros((1, 4, 13), np.float32)
    g = np.float32([0.3, 0.2, 0.1])
    # lane 0: old 400 (gain 0) -> current 200 -> new 900
    pk[0, 0, 1:4] = (400, 200, 900)
    pk[0, 0, 7:10], pk[0, 0, 10:13] = g, g
    # lane 1: every set equal, period 50: [0,120) and [120,240) read 50 only
    pk[0, 1, 1:4] = 50
    pk[0, 1, 4:13] = np.tile(g, 3)
    # lane 2: the post-filter off
    pk[0, 2, 1:4] = 15
    # lane 3: current 15 with gain 0 fading into new 300
    pk[0, 3, 1:4] = (15, 15, 300)
    pk[0, 3, 10:13] = g
    want = [[198, 198, 898], [48, 48, 48], [120, 120, 720], [120, 298, 298]]
    assert synth.comb_chunks(pk)[0].tolist() == want
    assert synth.comb_steps(pk).tolist() == [3, 3 + 3 + 15, 3, 1 + 1 + 3]


def test_kernel_power_tables_match_model():
    """The kernel's literal tables are the model's fl(0.85^t) and
    fl(0.85^(30·2^s))."""
    src = open(os.path.join(ROOT, "iamf_tpu_torch", "csrc",
                            "comb_deemph.cu")).read()

    def table(name):
        body = re.search(rf"float {name}\[\w+\] = \{{([^}}]*)\}}", src).group(1)
        return np.float32([float.fromhex(v.strip().rstrip("f"))
                           for v in body.split(",")])

    assert np.array_equal(table("PW"), k2_model.PW)
    assert np.array_equal(table("PS"), k2_model.PS)
