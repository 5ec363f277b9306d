"""The limiter's true-peak meter (IAMF_TRUEPEAK=1) on the CPU against the
JAX package: the taps, K9's plain twin (dsp/limiter.truepeak_plain) against
iamf_tpu.dsp.limiter.input_peaks across blocks with the history carried,
K9's literal tap table against truepeak_filters, and the batched decode
through both BatchedStreamDecoders on content whose inter-sample peaks
engage the limiter where its sample peaks would not.

Bounds: the meter within 2^-21 of the block's largest |x| (the twin sums
each phase's 12 products in order; the JAX einsum in its own order), the
history equal; the decode within 1 s16 LSB.
"""

import os
import re

import numpy as np
import pytest
import torch

from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as JaxDecoder
from iamf_tpu.dsp import limiter as jlim
from iamf_tpu_torch.constants import ChannelLayout
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from iamf_tpu_torch.dsp import limiter
from iamf_tpu_torch.tools import streams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_taps_match():
    assert np.array_equal(limiter.truepeak_filters(), jlim.truepeak_filters())
    assert (limiter.TP_PHASES, limiter.TP_TAPS, limiter.TP_HIST) == (
        jlim.TP_PHASES, jlim.TP_TAPS, jlim.TP_HIST)


def test_c_table_matches_jax():
    """The true-peak taps as a C initializer: the JAX package's string."""
    got = limiter.emit_truepeak_c_table()
    assert got == jlim.emit_truepeak_c_table()
    assert got.startswith("static const float TP_PHASES_TAB[4][12] = {")


def test_k9_literal_taps():
    """csrc/truepeak.cu's __constant__ table is truepeak_filters, bit for
    bit."""
    src = open(os.path.join(ROOT, "iamf_tpu_torch", "csrc",
                            "truepeak.cu")).read()
    body = re.search(r"H\[PHASES\]\[TAPS\] = \{(.*?)\n\};", src, re.S).group(1)
    vals = [float(v.rstrip("f"))
            for v in re.findall(r"-?\d\.\d+e[-+]\d+f", body)]
    got = np.array(vals, np.float32).reshape(limiter.TP_PHASES,
                                             limiter.TP_TAPS)
    assert got.view(np.int32).tolist() == \
        limiter.truepeak_filters().view(np.int32).tolist()


def test_k9_taps_mirror_and_zero():
    """K9 reads phases 2 and 3 as phases 1 and 0 mirrored and leaves out
    the two -0 taps: both hold bit for bit in truepeak_filters."""
    h = limiter.truepeak_filters().view(np.uint32)
    assert np.array_equal(h[2], h[1][::-1])
    assert np.array_equal(h[3], h[0][::-1])
    assert h[0, 0] == h[3, 11] == 0x80000000


@pytest.mark.parametrize("C,T", [(1, 7), (3, 500), (12, 2048)])
def test_input_peaks_match_jax(C, T):
    """Two blocks (the second shorter than the history when T = 7), the
    meter's history carried from the first into the second."""
    rng = np.random.RandomState(C * 100 + T)
    cj = jlim.LimiterConfig(channels=C, true_peak=True)
    cp = limiter.LimiterConfig(channels=C, true_peak=True)
    sj, sp = jlim.init_state(cj), limiter.init_state(cp, "cpu")
    assert tuple(sp["tp_hist"].shape) == (C, limiter.TP_HIST)
    for n in (T, max(T // 3, 5)):
        x = (rng.randn(C, n) * 0.5).astype(np.float32)
        pj, sj = jlim.input_peaks(cj, sj, x)
        pp, sp = limiter.input_peaks(cp, sp, torch.from_numpy(x))
        assert pp.shape == (n,)
        tol = np.abs(x).max() * 2.0 ** -21
        assert np.abs(pp.numpy() - np.asarray(pj)).max() <= tol
        assert np.array_equal(sp["tp_hist"].numpy(),
                              np.asarray(sj["tp_hist"]))
    # sample-peak mode: max_c |x|, the state as it was
    cs = limiter.LimiterConfig(channels=C)
    st = limiter.init_state(cs, "cpu")
    pk, st2 = limiter.input_peaks(cs, st, torch.from_numpy(x))
    assert st2 is st and "tp_hist" not in st
    assert np.array_equal(pk.numpy(), np.abs(x).max(axis=0))


def test_meter_sees_intersample_peaks():
    """On an fs/4 tone at 45 degrees the samples sit at 0.707 of the crest;
    the meter reads near the crest in every period (the 4x grid misses it
    by 2 %)."""
    t = np.arange(4096)
    x = np.sin(2 * np.pi * t / 4 + np.pi / 4).astype(np.float32)[None]
    peaks, _ = limiter.truepeak_plain(torch.from_numpy(x[None]),
                                      torch.zeros(1, 1, limiter.TP_HIST))
    assert np.abs(x).max() < 0.71
    assert peaks[0, 100:].reshape(-1, 4).amax(dim=1).min() > 0.95


def test_truepeak_decode_matches_jax(monkeypatch):
    """The batched decode with IAMF_TRUEPEAK=1 over 3 batches of 8 frames,
    both decoders on the CPU; the limiter engages (the decode differs from
    the sample-peak one), and the meter's history crosses batch edges."""
    stream, _ = streams.build_pcm_layout_stream(
        ChannelLayout.L510, n_frames=24,
        pcm_override=streams.isp_tone_pcm(24, 6))
    monkeypatch.setenv("IAMF_TRUEPEAK", "1")
    got = BatchedStreamDecoder(stream, sound_system=1, batch_frames=8,
                               device="cpu").decode_all()
    want = JaxDecoder(stream, sound_system=1, batch_frames=8).decode_all()
    monkeypatch.delenv("IAMF_TRUEPEAK")
    sample = BatchedStreamDecoder(stream, sound_system=1, batch_frames=8,
                                  device="cpu").decode_all()
    assert got.shape == want.shape == sample.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert np.abs(sample.astype(np.int32) - got.astype(np.int32)).max() > 500


def test_twin_stream_axis_equals_single_streams():
    """truepeak_plain on x [3, C, T] with histories [3, C, 11] gives each
    stream its S = 1 call's peaks (the maximum over that stream's channels
    only) and history, bit for bit."""
    rng = np.random.RandomState(21)
    x = torch.from_numpy((rng.randn(3, 4, 700) * [[[0.1]], [[0.5]], [[0.9]]]
                          ).astype(np.float32))
    hist = torch.from_numpy(rng.randn(3, 4, limiter.TP_HIST).astype(
        np.float32))
    pk3, h3 = limiter.truepeak_plain(x, hist)
    assert pk3.shape == (3, 700) and h3.shape == (3, 4, limiter.TP_HIST)
    for s in range(3):
        pk1, h1 = limiter.truepeak_plain(x[s:s + 1], hist[s:s + 1])
        assert torch.equal(pk3[s:s + 1], pk1)
        assert torch.equal(h3[s:s + 1], h1)
    assert float(pk3[0].max()) < float(pk3[2].max())
