"""The 44.1 kHz (rate-mismatch) output path of the PyTorch port vs the JAX
package, on the CPU: K10's plain twin against DeviceResampler, the float
emission of decode_frames, and BatchedStreamDecoder end to end (resample,
normalization, the tail's limiter or plain quantization).

Bounds: the twin against DeviceResampler.resample_stream <= 1e-6 (both
run the same float32 contraction per output, in another order); decoded
PCM <= 1 s16 LSB.
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
                                    params_p, [torch.from_numpy(x)])
    yj = np.asarray(yj)
    assert yp.dtype == torch.float32 and yp.shape == yj.shape == (B * T, 6)
    assert np.abs(yp.numpy() - yj).max() <= 1e-6
    assert carry["pos"] == B
