"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. Marked ``cuda``: they skip where no CUDA device is visible (a CUDA
kernel has no CPU mode; the CPU tests cover the twins' arithmetic). Run
them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Bounds: K1 0.25 at s16 scale (split-TF32 tensor-core product against
the twin's fp32 torch.matmul); K2 1 s16 LSB (sequential vs blocked
de-emphasis); K3 1 LSB; the Opus sample decode 1 LSB against the golden.
"""

import os

import numpy as np
import pytest
import torch

from iamf_tpu_torch.codecs.opus import imdct, synth
from iamf_tpu_torch.dsp import limiter

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


K1_PATTERNS = {
    "all-long": lambda rng, B, L: np.zeros((B, L), bool),
    "all-short": lambda rng, B, L: np.ones((B, L), bool),
    "mixed": lambda rng, B, L: rng.rand(B, L) < 0.4,
}


@pytest.mark.parametrize("layout", ["packed973", "contiguous960"])
@pytest.mark.parametrize("pattern", sorted(K1_PATTERNS))
@pytest.mark.parametrize("B,L", [(1, 12), (8, 12), (128, 12), (1, 1)])
def test_k1_matches_plain(dev, B, L, pattern, layout):
    rng = np.random.RandomState(B * 100 + L)
    width = 973 if layout == "packed973" else 960
    mats_d, mats_c = imdct.FusedMats().to(dev), imdct.FusedMats()
    tail_d = tail_c = torch.from_numpy(
        rng.randn(L, 60).astype(np.float32) * 1024)
    tail_d = tail_d.to(dev)
    # two calls, the tail chained from the first into the second
    for _ in range(2):
        buf = torch.from_numpy(
            rng.randn(B, L, width).astype(np.float32) * 1000)
        trans = torch.from_numpy(K1_PATTERNS[pattern](rng, B, L))
        # the packed [B, L, 973] buffer is read in place (row stride 973)
        freq_d = buf.to(dev)[..., :960]
        launches = imdct.K1.launches
        y, tail_d = imdct.imdct_overlap(mats_d, freq_d, trans.to(dev), tail_d)
        assert imdct.K1.launches == launches + 1
        y_p, tail_c = imdct.imdct_overlap(mats_c, buf[..., :960], trans,
                                          tail_c)
        assert y.shape == (B, L, 960) and tail_d.shape == (L, 60)
        assert (y.cpu() - y_p).abs().max() < 0.25
        assert (tail_d.cpu() - tail_c).abs().max() < 0.25


def test_k2_matches_plain(dev):
    rng = np.random.RandomState(1)
    B, L = 3, 12
    buf = np.zeros((B, L, 973), np.float32)
    buf[..., 961:964] = rng.randint(15, 1025, size=(B, L, 3))
    buf[..., 964:973] = rng.rand(B, L, 9) * 0.3
    y = rng.randn(B, L, 960).astype(np.float32) * 3000
    hist = rng.randn(L, synth.HIST).astype(np.float32) * 3000
    demem = rng.randn(L).astype(np.float32) * 100
    w = torch.from_numpy(synth.window120().copy())
    args = [torch.from_numpy(a) for a in (y, buf, hist, demem)]
    pcm, h2, m2 = synth.comb_deemph(w.to(dev), *(a.to(dev) for a in args))
    pcm_p, h2_p, m2_p = synth.comb_deemph(w, *args)
    assert ((pcm.cpu() - pcm_p) * 32768).abs().max() <= 1
    assert torch.equal(h2.cpu(), h2_p)  # the comb itself is bit-exact


def test_k3_matches_plain(dev):
    rng = np.random.RandomState(2)
    C, T = 12, 960
    cfg = limiter.LimiterConfig(channels=C)
    x = (rng.randn(C, 8 * T) * 0.3).astype(np.float32)
    x[:, 3 * T:5 * T] *= 4.0  # over threshold: attack and release
    xs = torch.from_numpy(x)
    s_d, s_p = limiter.init_state(cfg, dev), limiter.init_state(cfg, "cpu")
    for half in (xs[:, :4 * T], xs[:, 4 * T:]):
        s_d, q_d = limiter.limit_quantize(cfg, s_d, half.to(dev), 16, T)
        s_p, q_p = limiter.limit_quantize(cfg, s_p, half, 16, T)
        d = (q_d.cpu().to(torch.int32) - q_p.to(torch.int32)).abs().max()
        assert int(d) <= 1
    assert torch.equal(s_d["env"].cpu(), s_p["env"])


def test_opus_sample_matches_golden(dev):
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

    data = open(os.path.join(ROOT, "iamf_tpu", "data",
                             "sample_opus_714.iamf"), "rb").read()
    want = np.load(os.path.join(ROOT, "iamf_tpu_torch", "data",
                                "sample_opus_714_ssJ.npz"))["pcm"]
    kernels = (imdct.K1, synth.K2, limiter.K3)
    for k in kernels:
        k.reset()
    got = BatchedStreamDecoder(data, sound_system=9, batch_frames=8,
                               device=dev).decode_all()
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert all(k.launches > 0 and k.plain_on_cuda == 0 for k in kernels)
