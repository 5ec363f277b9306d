"""The binaural (HRTF) path of the PyTorch port vs the JAX package, on the
CPU: K8's plain twin against the JAX HRTF branch of decode_frames and
against a float64 direct convolution, and BatchedStreamDecoder(binaural=
True) against iamf_tpu's.

Bounds: decoded PCM <= 1 s16 LSB (the repo's batched-vs-serial bar); the
twin against np.convolve <= 1e-4 at unit scale (the JAX package's own
bound for its FFT convolution, tests/test_binaural.py); K8's numpy model
(tests/k8_model.py) against np.convolve and the twin <= 1e-5 (float32
FFTs of 1024 points: a few 1e-7 measured).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import k8_model
import vectors
from iamf_tpu.constants import ChannelLayout
from iamf_tpu.core import batch_decoder as jbd
from iamf_tpu.core import pipeline as jpipe
from iamf_tpu.dsp import render as rdr
from iamf_tpu.dsp.downmix import downmix_matrix
from iamf_tpu_torch import convert
from iamf_tpu_torch.core import pipeline as ppipe
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from iamf_tpu_torch.dsp import binaural

T = 960

STREAMS = {
    # channel-based 5.1, headphones_rendering_mode 1: M2B, 6-channel bed
    "m2b_51_hrm1": (lambda: vectors.build_pcm_51_stream(
        n_frames=7, hrm=1)[0], 3),
    # FOA, hrm 1: H2B through the 7.1.2 virtual bed (10 channels)
    "h2b_foa_hrm1": (lambda: vectors.build_ambisonics_pcm_stream(
        order=1, n_frames=6, target_layouts=(0,), hrm=1)[0], 4),
    # stereo M2B + FOA H2B in one mix, per-element banks and carries
    "two_elements_hrm1": (lambda: vectors.build_two_element_stream(
        n_frames=7, gain2_q78=-(3 << 8), hrm=1)[0], 3),
    # hrm 0: the M2M matrix to the binaural layout, no convolution
    "m2m_51_hrm0": (lambda: vectors.build_pcm_51_stream(n_frames=6)[0], 4),
}


def _lsb(a, b):
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decoder_matches_jax(name):
    make, bf = STREAMS[name]
    data = make()
    want = np.asarray(jbd.BatchedStreamDecoder(
        data, binaural=True, batch_frames=bf).decode_all())
    dec = BatchedStreamDecoder(data, binaural=True, batch_frames=bf,
                               device="cpu")
    got = dec.decode_all()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.shape[1] == 2 and got.shape[0] > bf * T  # >= 2 batches
    assert _lsb(got, want) <= 1
    taps = [es.hrtf_taps for es in dec.cfg.elements]
    assert all(taps) == (name != "m2m_51_hrm0") and any(taps) == all(taps)


def test_binaural_takes_no_downmix():
    """With a binaural layout the loudspeaker downmix target does not
    exist: a 5.1 element with hrm 0 renders through the M2M matrix to the
    binaural layout. An unguarded sound-system lookup would take the 5.1 ->
    stereo downmix instead, which differs."""
    data = vectors.build_pcm_51_stream(n_frames=6)[0]
    dec = BatchedStreamDecoder(data, binaural=True, batch_frames=4,
                               device="cpu")
    (e,) = dec.elems
    assert e.downmix is None and e.hrtf_bank is None
    want = rdr.m2m_matrix(rdr.LAYER_IDS[ChannelLayout.L510],
                          rdr.BINAURAL_ID).T
    assert np.array_equal(e.render_mat, want)
    stereo = downmix_matrix(ChannelLayout.L510, ChannelLayout.STEREO, 0, 0)
    assert stereo.shape == want.shape and not np.allclose(stereo, want)


def _direct(x, bank, n):
    """float64 oracle: per-speaker np.convolve summed, first n samples."""
    out = np.zeros((2, n))
    for e in range(2):
        for c in range(x.shape[0]):
            out[e] += np.convolve(x[c].astype(np.float64),
                                  bank[e, c].astype(np.float64))[:n]
    return out


@pytest.mark.parametrize("layout,B", [(ChannelLayout.L510, 3),
                                      (ChannelLayout.L714, 4),
                                      (ChannelLayout.L712, 8)])
def test_twin_matches_direct_convolution(layout, B):
    """Three batches through hrtf_conv (CPU: the plain twin) with the
    overlap carried, against the whole signal's direct convolution."""
    bank = binaural.hrir_bank(layout)
    C = bank.shape[1]
    hrir = binaural.hrir_for_batch(bank, B, T, "cpu")
    rng = np.random.RandomState(5)
    n = 3 * B * T
    x = (rng.randn(C, n) * 0.3).astype(np.float32)
    ov = torch.zeros(1, 2, bank.shape[2] - 1)
    outs = []
    for b in range(3):
        xb = torch.from_numpy(x[None, :, b * B * T:(b + 1) * B * T])
        y, ov = binaural.hrtf_conv(hrir, xb, ov)
        outs.append(y[0].numpy())
    got = np.concatenate(outs, axis=1)
    err = np.abs(got - _direct(x, bank, n)).max()
    assert err < 1e-4, err
    # the carry is the convolution's spill past the last batch
    tail = _direct(np.pad(x, ((0, 0), (0, 255))), bank, n + 255)[:, n:]
    assert np.abs(ov[0].numpy() - tail).max() < 1e-4


@pytest.mark.parametrize("name", ["m2b_51_hrm1", "two_elements_hrm1"])
def test_decode_frames_hrtf_matches_jax(name):
    """The HRTF branch of decode_frames, batch by batch: the JAX side runs
    the first batch alone; its state (a non-zero hrtf overlap carry, the
    limiter, the HRIR spectra) is carried across with convert, and from
    then on both chain their own carries across the batch edges."""
    make, B = STREAMS[name]
    jd = jbd.BatchedStreamDecoder(make(), binaural=True, batch_frames=B)
    plan = jbd._HostPlan(jd)
    plan.close()
    cfg_j = jd.cfg
    cfg_p = convert.pipeline_config(cfg_j)
    params_j = plan.stream_params
    params_p = convert.stream_params(params_j, "cpu", cfg_p)
    for i, h in params_p["hrir"].items():
        # the bank recovered from the JAX spectra is the decoder's bank
        assert np.abs(h.bank.numpy() - jd.elems[i].hrtf_bank).max() < 1e-6
    xs_all = [e.codec.decode_batch_raw(
        [jd.frames_per_substream[s] for s in e.substream_ids], T)[0]
        for e in jd.elems]
    nb = -(-jd.n_frames // B)
    carry_j = jpipe.init_carry(cfg_j)
    carry_p = None
    for bi in range(nb + 1):  # the last call is a zero flush
        xs = []
        for x in xs_all:
            x = x[bi * B:(bi + 1) * B]
            xs.append(np.concatenate(
                [x, np.zeros((B - len(x),) + x.shape[1:], x.dtype)]))
        if bi == 1:
            carry_p = convert.pipe_carry(carry_j, "cpu")
            for i, ov in carry_p["hrtf"].items():
                assert float(ov.abs().max()) > 1e-3  # a live overlap
                assert np.array_equal(ov[0].numpy(), carry_j["hrtf"][i])
        carry_j, pcm_j = jpipe.decode_frames(
            cfg_j, carry_j, params_j, [jnp.asarray(x) for x in xs])
        if carry_p is None:
            continue
        carry_p, pcm_p = ppipe.decode_frames(
            cfg_p, carry_p, params_p, [torch.from_numpy(x)[None] for x in xs])
        pcm_p = pcm_p[0]  # the one stream
        pcm_j = np.asarray(pcm_j)
        assert pcm_p.shape == pcm_j.shape == (B * T, 2)
        assert _lsb(pcm_p.numpy(), pcm_j) <= 1, f"batch {bi}"
        for i, ov in carry_p["hrtf"].items():
            err = np.abs(ov[0].numpy() - np.asarray(carry_j["hrtf"][i])).max()
            assert err < 1e-4, (bi, i, err)


def test_convert_binaural_state():
    """pipe_carry maps the JAX overlap carry one to one; stream_params
    keeps the JAX spectra and recovers the time-domain bank."""
    jd = jbd.BatchedStreamDecoder(STREAMS["two_elements_hrm1"][0](),
                                  binaural=True, batch_frames=3)
    plan = jbd._HostPlan(jd)
    plan.close()
    rng = np.random.RandomState(3)
    carry_j = dict(plan.carry["pipe"])
    carry_j["hrtf"] = {i: jnp.asarray(rng.randn(2, 255).astype(np.float32))
                       for i in carry_j["hrtf"]}
    carry_p = convert.pipe_carry(carry_j, "cpu")
    assert sorted(carry_p["hrtf"]) == [0, 1]
    for i, v in carry_j["hrtf"].items():
        assert np.array_equal(carry_p["hrtf"][i][0].numpy(), np.asarray(v))
    cfg_p = convert.pipeline_config(jd.cfg)
    params_p = convert.stream_params(plan.stream_params, "cpu", cfg_p)
    ours = ppipe.stream_params(cfg_p, jd.params, 3 * 3, "cpu",
                               [e.hrtf_bank for e in jd.elems])
    for i, h in params_p["hrir"].items():
        hri = np.asarray(plan.stream_params["hrtf_H"][i])
        assert np.array_equal(h.spec.real.numpy(), hri[0])
        assert np.array_equal(h.spec.imag.numpy(), hri[1])
        mine = ours["hrir"][i]
        assert (h.seg, h.n_fft, h.taps) == (mine.seg, mine.n_fft, mine.taps)
        assert np.abs(h.bank.numpy() - mine.bank.numpy()).max() < 1e-6
        assert np.abs(h.spec.numpy() - mine.spec.numpy()).max() < 1e-5


def _k8_chain(bank, x, ov, n, conv):
    """x [C, 3n] through `conv` in three blocks of n samples, the carry
    chained from ov: (y [2, 3n], the last carry)."""
    ys = []
    for b in range(3):
        y, ov = conv(x[:, b * n:(b + 1) * n], ov)
        ys.append(np.asarray(y))
    return np.concatenate(ys, 1), np.asarray(ov)


K8_BEDS = {2: ChannelLayout.STEREO, 6: ChannelLayout.L510,
           12: ChannelLayout.L714}


@pytest.mark.parametrize("N", [1, 100, 1025, 3 * 960])
@pytest.mark.parametrize("C", sorted(K8_BEDS))
def test_k8_model_matches_direct_and_twin(C, N):
    """K8's plan (numpy model) over three blocks of N samples with a live
    carry, against the float64 direct convolution of the whole signal
    (the carry added at its head) and, where the twin's segmented
    overlap-add takes the block (N >= taps - 1), against the twin."""
    bank = binaural.hrir_bank(K8_BEDS[C])
    rng = np.random.RandomState(C * 10000 + N)
    x = (rng.randn(C, 3 * N) * 0.3).astype(np.float32)
    ov = (rng.randn(2, 255) * 0.1).astype(np.float32)
    got, ov_m = _k8_chain(bank, x, ov, N,
                          lambda xb, o: k8_model.k8(bank, xb, o))
    full = _direct(np.pad(x, ((0, 0), (0, 255))), bank, 3 * N + 255)
    full[:, :255] += ov
    assert np.abs(got - full[:, :3 * N]).max() < 1e-5
    assert np.abs(ov_m - full[:, 3 * N:]).max() < 1e-5
    if N >= 255:
        hrir = binaural.hrir_for_batch(bank, 1, N, "cpu")
        want, ov_t = _k8_chain(
            bank, torch.from_numpy(x), torch.from_numpy(ov), N,
            lambda xb, o: tuple(t[0] for t in binaural.hrtf_conv_plain(
                hrir, xb[None], o[None])))
        assert np.abs(got - want).max() < 1e-5
        assert np.abs(ov_m - ov_t).max() < 1e-5


@pytest.mark.parametrize("taps", [64, 512, 513, 2048, 5632])
def test_k8_model_filter_lengths(taps):
    """The partitioned plan (parts of at most 512 taps, so any length
    goes through the same FFT path): one part up to 512, two from 513,
    eleven at 5632; against float64, with blocks shorter than the
    filter."""
    bank = binaural.hrir_bank(ChannelLayout.L510, taps=taps)
    parts, lp = binaural.k8_partition(taps)
    assert parts * lp >= taps > (parts - 1) * lp and lp <= binaural.K8_PART
    rng = np.random.RandomState(taps)
    N = 700
    x = (rng.randn(6, 3 * N) * 0.3).astype(np.float32)
    ov = (rng.randn(2, taps - 1) * 0.1).astype(np.float32)
    got, ov_m = _k8_chain(bank, x, ov, N,
                          lambda xb, o: k8_model.k8(bank, xb, o))
    full = _direct(np.pad(x, ((0, 0), (0, taps - 1))), bank,
                   3 * N + taps - 1)
    full[:, :taps - 1] += ov
    assert np.abs(got - full[:, :3 * N]).max() < 1e-5
    assert np.abs(ov_m - full[:, 3 * N:]).max() < 1e-5


def test_k8_tables():
    """k8_twiddles is W^(n1 k2) and W_32^k rounded from float64;
    k8_spectra's P and Q give back each pair's two channel spectra
    (P + Q = G_a / F, Q - P = i G_b / F), part by part."""
    tw = binaural.k8_twiddles()
    w = tw[:, 0] + 1j * tw[:, 1]
    n = np.arange(32)
    assert np.abs(w[:1024].reshape(32, 32) - np.exp(
        -2j * np.pi * np.outer(n, n) / 1024)).max() < 1e-7
    assert np.abs(w[1024:] - np.exp(-2j * np.pi * n[:16] / 32)).max() < 1e-7
    bank = binaural.hrir_bank(ChannelLayout.L712, taps=600)  # C = 10
    pq = binaural.k8_spectra(bank).astype(np.float64)
    assert pq.shape == (2, 5, 1024, 4)  # parts of 300 taps, 5 pairs
    P, Q = pq[..., 0] + 1j * pq[..., 1], pq[..., 2] + 1j * pq[..., 3]
    g = np.fft.fft((bank[0] + 1j * bank[1]).reshape(10, 2, 300), n=1024)
    F = 1024
    assert np.abs((P + Q) * F - g[0::2].transpose(1, 0, 2)).max() < 1e-5
    assert np.abs((Q - P) * F / 1j - g[1::2].transpose(1, 0, 2)).max() < 1e-5


def test_twin_stream_axis_equals_single_streams():
    """hrtf_conv_plain on beds x [3, C, N] with carries [3, 2, taps-1]
    (one bank for the bucket) gives each stream its S = 1 call's ears and
    carry, bit for bit."""
    bank = binaural.hrir_bank(ChannelLayout.L510)
    hrir = binaural.hrir_for_batch(bank, 2, T, "cpu")
    rng = np.random.RandomState(8)
    x = torch.from_numpy((rng.randn(3, 6, 2 * T) * 0.3).astype(np.float32))
    ov = torch.from_numpy((rng.randn(3, 2, 255) * 0.1).astype(np.float32))
    y3, ov3 = binaural.hrtf_conv(hrir, x, ov)
    assert y3.shape == (3, 2, 2 * T) and ov3.shape == (3, 2, 255)
    for s in range(3):
        y1, ov1 = binaural.hrtf_conv(hrir, x[s:s + 1], ov[s:s + 1])
        assert torch.equal(y3[s:s + 1], y1)
        assert torch.equal(ov3[s:s + 1], ov1)
