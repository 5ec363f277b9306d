"""The 44.1 kHz (rate-mismatch) output path of the PyTorch port vs the JAX
package, on the CPU: K10's plain twin against DeviceResampler, the float
emission of decode_frames, and BatchedStreamDecoder end to end (resample,
normalization, the tail's limiter or plain quantization).

Bounds: the twin against DeviceResampler.resample_stream <= 1e-6 (both
run the same float32 contraction per output, in another order); a numpy
model of K10's periodic indexing against the twin <= 1e-6 (the same taps,
summed in float64); decoded PCM <= 1 s16 LSB.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectors
from iamf_tpu.constants import ChannelLayout
from iamf_tpu.core import batch_decoder as jbd
from iamf_tpu.core import pipeline as jpipe
from iamf_tpu.dsp.resample import DeviceResampler
from iamf_tpu_torch import convert
from iamf_tpu_torch.core import pipeline as ppipe
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from iamf_tpu_torch.dsp import resample

T = 960


@pytest.mark.parametrize("rate,n_in", [(44100, 20000), (16000, 9000),
                                       (32000, 20000), (96000, 40000)])
def test_twin_matches_device_resampler(rate, n_in):
    """Several output chunks, a ragged end and the latency drain; the
    input is loud enough that some outputs clip at +-1."""
    rng = np.random.RandomState(rate % 997)
    x = (rng.randn(3, n_in) * 0.4).astype(np.float32)
    x[:, n_in // 3:n_in // 3 + 50] *= 4.0
    want = np.asarray(DeviceResampler(3, rate, 48000).resample_stream(x))
    plan = resample.ResamplePlan(rate, 48000, device="cpu")
    got = resample.resample_stream(plan, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, plan.n_out(n_in))
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(got).max() == 1.0  # the clip ran
    if rate == 96000:
        assert plan.N == 128


def _loud441(n_frames, nch):
    pcm = vectors.sine_pcm(n_frames * T, nch, 44100, amp=0.4, seed=3)
    burst = vectors.sine_pcm(2 * T, nch, 44100, amp=1.45, seed=4)
    pcm[3 * T:5 * T] = np.clip(burst, -32768, 32767)
    return pcm


CASES = {
    "stereo_441": (lambda: vectors.build_pcm_layout_stream(
        ChannelLayout.STEREO, n_frames=8, rate=44100)[0],
        dict(sound_system=0, batch_frames=3)),
    "stereo_441_no_limiter": (lambda: vectors.build_pcm_layout_stream(
        ChannelLayout.STEREO, n_frames=8, rate=44100)[0],
        dict(sound_system=0, batch_frames=3, limiter=False)),
    "pcm51_441_norm": (lambda: vectors.build_pcm_51_stream(
        n_frames=6, rate=44100)[0],
        dict(sound_system=0, batch_frames=4, normalization_db=-10.0)),
    "pcm51_441_norm_no_limiter": (lambda: vectors.build_pcm_51_stream(
        n_frames=6, rate=44100)[0],
        dict(sound_system=0, batch_frames=4, normalization_db=-10.0,
             limiter=False)),
    # a +4 dB burst: the tail's limiter attacks and releases
    "stereo_441_loud": (lambda: vectors.build_pcm_layout_stream(
        ChannelLayout.STEREO, n_frames=8, rate=44100,
        pcm_override=_loud441(8, 2))[0],
        dict(sound_system=0, batch_frames=3)),
    # binaural M2B at 44.1 kHz: K8 before the resample tail
    "m2b_51_441": (lambda: vectors.build_pcm_51_stream(
        n_frames=6, rate=44100, hrm=1)[0],
        dict(binaural=True, batch_frames=4)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_decoder_matches_jax(name):
    make, kw = CASES[name]
    data = make()
    jd = jbd.BatchedStreamDecoder(data, **kw)
    want = np.asarray(jd.decode_all())
    dec = BatchedStreamDecoder(data, device="cpu", **kw)
    assert dec.needs_resample and dec.stream_rate == 44100
    assert dec.cfg.emit_float and dec.cfg.limiter is None
    assert dec.cfg == convert.pipeline_config(jd.cfg)
    got = dec.decode_all()
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, f"{d.max()} LSB"
    if name.endswith("loud"):
        assert 28000 <= np.abs(want).max() < 29300  # the limiter held it


def test_emit_float_matches_jax():
    """decode_frames with emit_float returns the float mix [B*T, out]."""
    B = 3
    data = vectors.build_pcm_51_stream(n_frames=5, rate=44100)[0]
    jd = jbd.BatchedStreamDecoder(data, sound_system=1, batch_frames=B)
    cfg_p = convert.pipeline_config(jd.cfg)
    params_j = jpipe.put_stream_params(jd.cfg, jd.params, 3 * B)
    params_p = convert.stream_params(params_j, "cpu")
    (e,) = jd.elems
    x = e.codec.decode_batch_raw(
        [jd.frames_per_substream[s] for s in e.substream_ids], T)[0][:B]
    _, yj = jpipe.decode_frames(jd.cfg, jpipe.init_carry(jd.cfg), params_j,
                                [jnp.asarray(x)])
    carry, yp = ppipe.decode_frames(cfg_p, ppipe.init_carry(cfg_p, "cpu"),
                                    params_p, [torch.from_numpy(x)[None]])
    yp = yp[0]  # the one stream
    yj = np.asarray(yj)
    assert yp.dtype == torch.float32 and yp.shape == yj.shape == (B * T, 6)
    assert np.abs(yp.numpy() - yj).max() <= 1e-6
    assert carry["pos"] == B


K10_RATES = [44100, 16000, 32000, 96000, 22050, 11025, 88200]


@pytest.mark.parametrize("rate", K10_RATES)
def test_plan_bank_and_tiles(rate):
    """The per-phase bank reproduces every row of W exactly
    (bank[(num*o) % den] == W[o]), and K10's tiles hold each output's row,
    shifted to its place in the tile's window and zero elsewhere."""
    plan = resample.ResamplePlan(rate, 48000, device="cpu")
    num, den, N = plan.num, plan.den, plan.N
    W, bank = plan.W.numpy(), plan.bank.numpy()
    o = np.arange(plan.out_chunk)
    assert bank.shape == (den, N)
    assert np.array_equal(bank[(num * o) % den], W)
    R, L = resample.K10_R, plan.tile_outputs
    rows, start = plan.rows.numpy(), plan.tile_start.numpy()
    assert L % den == 0 and L % R == 0 and rows.shape[0] * R == L
    assert plan.tile_inputs == num * L // den
    for k in range(L):
        u, i = divmod(k, R)
        d = num * k // den - start[u]
        row = np.zeros(rows.shape[1], np.float32)
        row[d:d + N] = bank[(num * k) % den]
        assert np.array_equal(rows[u, :, i], row)


def k10_model(plan, x):
    """K10's indexing in numpy: output j = L*M + R*u + i sums its tile's
    window at tile_inputs*M + start[u] + D against the tile's row i."""
    C, T = x.shape
    n = plan.n_out(T)
    R, L = resample.K10_R, plan.tile_outputs
    rows, start = plan.rows.numpy(), plan.tile_start.numpy()
    j = np.arange(n)
    M, k = divmod(j, L)
    u, i = divmod(k, R)
    w0 = plan.tile_inputs * M + start[u] + plan.lead
    idx = w0[:, None] + np.arange(rows.shape[1])
    xz = np.zeros((C, max(T, idx.max() + 1)))
    xz[:, :T] = x
    win = np.where(idx >= 0, xz[:, np.clip(idx, 0, None)], 0.0)  # [C, n, NE]
    y = np.einsum("cjf,jf->cj", win, rows[u, :, i].astype(np.float64))
    return np.clip(y, -1.0, 1.0)


@pytest.mark.parametrize("rate,n_in", [(44100, 20000), (44100, 500),
                                       (16000, 9000), (32000, 20000),
                                       (96000, 40000), (22050, 9000),
                                       (11025, 5000), (88200, 40000)])
def test_k10_model_matches_twin(rate, n_in):
    rng = np.random.RandomState(rate % 991 + n_in)
    x = (rng.randn(3, n_in) * 0.4).astype(np.float32)
    x[:, n_in // 3:n_in // 3 + 50] *= 4.0
    plan = resample.ResamplePlan(rate, 48000, device="cpu")
    want = resample.resample_plain(plan, torch.from_numpy(x)).numpy()
    got = k10_model(plan, x)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6
