"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. Marked ``cuda``: they skip where no CUDA device is visible (a CUDA
kernel has no CPU mode; the CPU tests cover the twins' arithmetic). Run
them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Bounds: K1 0.25 at s16 scale (split-TF32 tensor-core product against
the twin's fp32 torch.matmul); K2 bit for bit against its CPU model
(tests/k2_model.py), and against the twin hist' equal and 1 s16 LSB
(scanned vs blocked de-emphasis); K3 0 LSB and a bit-equal state (the
walk keeps every rounding of the recurrence); the Opus sample decode 1 LSB
against the golden;
K8 1e-4 at unit scale against the twin and a float64 direct convolution
(its own fp32 overlap-save FFTs against the twin's; a few 1e-6 measured),
1e-5 against its numpy model (tests/k8_model.py); K10 1e-5 (the same 64-
to 128-tap fp32 dot products in another order); K7 1 LSB on the PCM and
0.25 at s16 scale on the unrounded carry against the twin and its numpy
model (tests/k7_model.py; fp32 FFT IMDCTs against the twin's fp32 matmul),
and bit for bit across the ways of cutting a batch into runs; K9 bit for bit
(each phase sums its taps in the twin's order), and K3 fed by it 0 LSB
with an equal state; the binaural, 44.1 kHz, AAC and true-peak decodes
1 LSB against the CPU run. The frame-serial pieces (dsp/limiter.Limiter,
dsp/binaural.HRTFRenderer) at 960- and 1024-sample frames: one K3 (and
K9) or K8 launch a frame against the twins, K3 0 LSB with an equal state,
K8 1e-4; the serial IAMFDecoder 1 LSB against its CPU run. The sharded
decoder on every mesh 1 LSB against the card's batched decode (the shards
over the visible cards), the pipelined one bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import k2_model
import k7_model
import k8_model
from iamf_tpu.constants import ChannelLayout
from iamf_tpu_torch.codecs.aac import synth as aac_synth
from iamf_tpu_torch.codecs.opus import imdct, synth
from iamf_tpu_torch.dsp import binaural, limiter, resample

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


@pytest.mark.parametrize("case", sorted(k2_model.CASES))
def test_k2_matches_plain(dev, case):
    """K2 chained over the case's batches (tests/k2_model.py: the sample's
    spectra and parameters, lags 15..20, all-zero-gain frames, a period
    change across a batch edge, B = 1, uniform random lags): bit for bit
    to the CPU model that follows its order (PCM, z, hist', demem', phase
    A's steps); hist' equal to the twin's, PCM <= 1 LSB and demem' within
    k2_model.DEMEM_REL of it."""
    batches, hist, demem = k2_model.inputs(case)
    window = synth.window120().astype(np.float32)
    w_d, w_c = torch.from_numpy(window).to(dev), torch.from_numpy(window)
    h_d, m_d = torch.from_numpy(hist).to(dev), torch.from_numpy(demem).to(dev)
    h_c, m_c = torch.from_numpy(hist), torch.from_numpy(demem)
    for y, pk in batches:
        B, L, _ = y.shape
        buf = torch.from_numpy(np.concatenate([np.zeros_like(y), pk], -1))
        pcm_m, hist_m, demem_m, z_m, steps_m = k2_model.k2(
            window, y, pk, h_d.cpu().numpy(), m_d.cpu().numpy())
        scratch = torch.empty(L * B * 960 + L, device=dev)
        launches = synth.K2.launches
        pcm, h_d, m_d = synth.comb_deemph_cuda(
            w_d, torch.from_numpy(y).to(dev), buf.to(dev), h_d, m_d, scratch)
        assert synth.K2.launches == launches + 1
        pcm_p, h_c, m_c = synth.comb_deemph(w_c, torch.from_numpy(y), buf,
                                            h_c, m_c)
        z = scratch[:L * B * 960].view(L, B * 960).cpu().numpy()
        assert np.array_equal(z, z_m)
        assert np.array_equal(scratch[L * B * 960:].view(torch.int32).cpu()
                              .numpy(), steps_m)
        assert np.array_equal(pcm.cpu().numpy(), pcm_m)
        assert np.array_equal(h_d.cpu().numpy(), hist_m)
        assert np.array_equal(m_d.cpu().numpy(), demem_m)
        assert torch.equal(h_d.cpu(), h_c)  # the comb itself is bit-exact
        assert ((pcm.cpu() - pcm_p) * 32768).abs().max() <= 1
        tol = k2_model.DEMEM_REL * max(1.0, float(m_c.abs().max()))
        assert (m_d.cpu() - m_c).abs().max() <= tol


def one_stream(fn, *args):
    """fn on one stream: each tensor argument, and each tensor of a state
    dict, gains the stream axis; each tensor of the result loses it."""

    def add(a):
        if isinstance(a, dict):
            return {k: v[None] for k, v in a.items()}
        return a[None] if isinstance(a, torch.Tensor) else a

    def drop(a):
        if isinstance(a, dict):
            return {k: v[0] for k, v in a.items()}
        return a[0] if isinstance(a, torch.Tensor) else a

    return tuple(map(drop, fn(*map(add, args))))


def _k3_chain(dev, cfg, st, xs):
    """K3 and its twin chained over the batches xs from the CPU state st:
    after each batch the int output and the whole state are equal bit for
    bit. Returns the twin's last state."""
    s_d = {k: v.to(dev) for k, v in st.items()}
    for x in xs:
        launches = limiter.K3.launches
        s_d, q_d = one_stream(limiter.limit_quantize, cfg, s_d, x.to(dev),
                              16, 960)
        assert limiter.K3.launches == launches + 1
        st, q_p = one_stream(limiter.limit_quantize, cfg, st, x, 16, 960)
        assert torch.equal(q_d.cpu(), q_p)
        assert torch.equal(s_d["env"].cpu().view(torch.int32),
                           st["env"].view(torch.int32))
        assert s_d.keys() == st.keys()
        for k in st:
            assert torch.equal(s_d[k].cpu(), st[k]), k
    return st


def test_k3_matches_plain(dev):
    rng = np.random.RandomState(2)
    C, T = 12, 960
    cfg = limiter.LimiterConfig(channels=C)
    x = (rng.randn(C, 8 * T) * 0.3).astype(np.float32)
    x[:, 3 * T:5 * T] *= 4.0  # over threshold: attack and release
    xs = torch.from_numpy(x)
    _k3_chain(dev, cfg, limiter.init_state(cfg, "cpu"),
              [xs[:, :4 * T], xs[:, 4 * T:]])


def _noise(rng, C, N, scale):
    return torch.from_numpy((rng.randn(C, N) * scale).astype(np.float32))


def _mid_release(cfg, rng):
    """A twin state 1000 samples after a burst: releasing, no retrigger."""
    x = _noise(rng, cfg.channels, 3000, 0.1)
    x[:, 500:1000] *= 10.0
    st, _ = one_stream(limiter.limit_plain, cfg,
                       limiter.init_state(cfg, "cpu"), x, 960)
    tab = limiter.walk_tables(cfg)
    assert tab.T[tab.A] <= float(st["env"][3]) < tab.T[tab.M]
    return st


# name: (C, the batch lengths, level of the Gaussian input, start
# mid-release)
K3_CASES = {
    "engaged_c2_n122880": (2, [122880], 0.5, False),
    "idle_c12_n122880": (12, [122880], 0.1, False),
    "n1": (2, [1, 1, 1], 0.5, True),
    "n31": (2, [31, 31, 31], 0.5, True),
    "n1025": (2, [1025, 1025], 0.5, True),
    "three_batches_c12": (12, [7680, 7680, 7680], 0.3, False),
    "mid_release_quiet_then_loud": (2, [3840, 3840, 960], 0.1, True),
}


@pytest.mark.parametrize("name", sorted(K3_CASES))
def test_k3_cases(dev, name):
    """0 LSB and a bit-equal state against the twin: a whole batch engaged
    (retriggering every few samples), a whole batch idle, batches shorter
    and longer than a walk tile, a state carried across three batches, and
    states entering mid-release."""
    C, lens, level, mid = K3_CASES[name]
    rng = np.random.RandomState(len(name))
    cfg = limiter.LimiterConfig(channels=C)
    st = _mid_release(cfg, rng) if mid else limiter.init_state(cfg, "cpu")
    xs = [_noise(rng, C, n, level) for n in lens]
    if name.startswith("mid_release"):
        xs[-1] *= 10.0  # the last batch retriggers
    st = _k3_chain(dev, cfg, st, xs)
    assert (float(st["env"][3]) == -1.0) == name.startswith("idle")


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


K8_BEDS = {2: ChannelLayout.STEREO, 6: ChannelLayout.L510,
           10: ChannelLayout.L712, 12: ChannelLayout.L714}


@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("C", sorted(K8_BEDS))
def test_k8_matches_plain(dev, C, B):
    rng = np.random.RandomState(C * 1000 + B)
    T = 960
    bank = binaural.hrir_bank(K8_BEDS[C])
    hrir_d = binaural.hrir_for_batch(bank, B, T, dev)
    hrir_c = binaural.hrir_for_batch(bank, B, T, "cpu")
    ov_c = torch.from_numpy(rng.randn(2, 255).astype(np.float32) * 0.1)
    ov_d = ov_c.to(dev)
    for _ in range(2):  # the overlap chained from one call into the next
        x = torch.from_numpy((rng.randn(C, B * T) * 0.3).astype(np.float32))
        launches = binaural.K8.launches
        y_d, ov_d = one_stream(binaural.hrtf_conv, hrir_d, x.to(dev), ov_d)
        assert binaural.K8.launches == launches + 1
        y_c, ov_c = one_stream(binaural.hrtf_conv, hrir_c, x, ov_c)
        assert y_d.shape == (2, B * T) and ov_d.shape == (2, 255)
        assert (y_d.cpu() - y_c).abs().max() < 1e-4
        assert (ov_d.cpu() - ov_c).abs().max() < 1e-4


@pytest.mark.parametrize("N", [1, 100, 1025])
def test_k8_short_blocks_match_direct(dev, N):
    """Blocks shorter than the filter (the new carry then also holds the
    old one's unconsumed part) against a float64 direct convolution."""
    rng = np.random.RandomState(N)
    bank = binaural.hrir_bank(ChannelLayout.L510)
    hrir = binaural.hrir_for_batch(bank, 1, 960, dev)
    x = (rng.randn(6, 3 * N) * 0.3).astype(np.float32)
    ov = torch.zeros(2, 255, device=dev)
    ys = []
    for b in range(3):
        y, ov = one_stream(
            binaural.hrtf_conv_cuda, hrir,
            torch.from_numpy(x[:, b * N:(b + 1) * N]).to(dev), ov)
        ys.append(y.cpu().numpy())
    full = np.zeros((2, 3 * N + 255))
    for e in range(2):
        for c in range(6):
            full[e] += np.convolve(x[c].astype(np.float64),
                                   bank[e, c].astype(np.float64))
    assert np.abs(np.concatenate(ys, 1) - full[:, :3 * N]).max() < 1e-4
    assert np.abs(ov.cpu().numpy() - full[:, 3 * N:]).max() < 1e-4


@pytest.mark.parametrize("taps", [64, 512, 513, 2048, 5632])
def test_k8_filter_lengths(dev, taps):
    """Every filter length goes through the one FFT path: one part up to
    512 taps (K8_PART), two from 513, four at 2048, eleven at 5632 (the
    first design's limit); blocks longer and shorter than the filter,
    with a live carry, against float64 and the numpy model of the plan."""
    bank = binaural.hrir_bank(ChannelLayout.L510, taps=taps)
    hrir = binaural.hrir_for_batch(bank, 1, 960, dev)
    rng = np.random.RandomState(taps)
    lens = [960, 100, 3000]
    x = (rng.randn(6, sum(lens)) * 0.3).astype(np.float32)
    ov0 = (rng.randn(2, taps - 1) * 0.1).astype(np.float32)
    ov, ov_m = torch.from_numpy(ov0).to(dev), ov0
    ys, ys_m, t = [], [], 0
    for n in lens:
        xb = x[:, t:t + n]
        y, ov = one_stream(binaural.hrtf_conv_cuda, hrir,
                           torch.from_numpy(xb).to(dev), ov)
        y_m, ov_m = k8_model.k8(bank, xb, ov_m)
        assert np.abs(y.cpu().numpy() - y_m).max() < 1e-5
        ys.append(y.cpu().numpy())
        t += n
    full = np.zeros((2, t + taps - 1))
    for e in range(2):
        for c in range(6):
            full[e] += np.convolve(x[c].astype(np.float64),
                                   bank[e, c].astype(np.float64))
    full[:, :taps - 1] += ov0
    assert np.abs(np.concatenate(ys, 1) - full[:, :t]).max() < 1e-4
    assert np.abs(ov.cpu().numpy() - full[:, t:]).max() < 1e-4
    assert np.abs(ov.cpu().numpy() - ov_m).max() < 1e-5


@pytest.mark.parametrize("C", [1, 12])
@pytest.mark.parametrize("rate,n_in", [(44100, 100000), (16000, 30000),
                                       (32000, 50000), (96000, 100000),
                                       (44100, 500), (22050, 50000),
                                       (11025, 30000), (88200, 100000)])
def test_k10_matches_plain(dev, rate, n_in, C):
    rng = np.random.RandomState(rate % 1009 + C)
    x = (rng.randn(C, n_in) * 0.4).astype(np.float32)
    x[:, n_in // 2:n_in // 2 + 40] *= 4.0  # some outputs clip
    plan_d = resample.ResamplePlan(rate, 48000, device=dev)
    plan_c = resample.ResamplePlan(rate, 48000, device="cpu")
    launches = resample.K10.launches
    y_d = resample.resample_stream(plan_d, torch.from_numpy(x).to(dev))
    assert resample.K10.launches == launches + 1
    y_c = resample.resample_stream(plan_c, torch.from_numpy(x))
    assert y_d.shape == y_c.shape == (C, plan_c.n_out(n_in))
    assert (y_d.cpu() - y_c).abs().max() <= 1e-5


OUTPUT_PATHS = {
    "m2b_714_hrm1": lambda v: (v.build_pcm_layout_stream(
        ChannelLayout.L714, n_frames=12, hrm=1)[0],
        dict(binaural=True, batch_frames=4)),
    "h2b_foa_hrm1": lambda v: (v.build_ambisonics_pcm_stream(
        order=1, n_frames=9, target_layouts=(0,), hrm=1)[0],
        dict(binaural=True, batch_frames=4)),
    "pcm714_441_ssJ": lambda v: (v.build_pcm_layout_stream(
        ChannelLayout.L714, n_frames=12, rate=44100)[0],
        dict(sound_system=9, batch_frames=4)),
    "pcm51_441_norm": lambda v: (v.build_pcm_51_stream(
        n_frames=9, rate=44100)[0],
        dict(sound_system=1, batch_frames=4, normalization_db=-10.0)),
}


@pytest.mark.parametrize("name", sorted(OUTPUT_PATHS))
def test_output_paths_match_cpu(dev, name):
    import vectors
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

    data, kw = OUTPUT_PATHS[name](vectors)
    kernels = (binaural.K8, resample.K10, limiter.K3)
    for k in kernels:
        k.reset()
    got = BatchedStreamDecoder(data, device=dev, **kw).decode_all()
    want = BatchedStreamDecoder(data, device="cpu", **kw).decode_all()
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    k = binaural.K8 if "hrm1" in name else resample.K10
    assert k.launches > 0 and limiter.K3.launches > 0
    assert all(k.plain_on_cuda == 0 for k in kernels)


# (window_sequence, window_shape, previous shape) of each row
K7_PATTERNS = {
    "all-long": lambda rng, B, L: np.zeros((B, L, 3), np.int32),
    "all-short": lambda rng, B, L: np.tile(np.array([2, 1, 0], np.int32),
                                           (B, L, 1)),
    "every-case": lambda rng, B, L: np.array(
        [[(q, h, p) for q in range(4) for h in range(2)
          for p in range(2)][i] for i in rng.randint(16, size=B * L)],
        np.int32).reshape(B, L, 3),
}


@pytest.mark.parametrize("pattern", sorted(K7_PATTERNS))
@pytest.mark.parametrize("B,L", [(1, 12), (8, 12), (128, 12), (3, 1)])
def test_k7_matches_plain(dev, B, L, pattern):
    """K7 against its twin and its numpy model over two consecutive calls
    with the carry chained from a live one."""
    rng = np.random.RandomState(B * 10 + L)
    tabs_d, tabs_c = aac_synth.Tables().to(dev), aac_synth.Tables()
    carry_c = torch.from_numpy(
        (rng.randn(L, 1024) * 3000).astype(np.float32))
    carry_d, carry_m = carry_c.to(dev), carry_c.numpy()
    for _ in range(2):
        spec = (rng.randn(B, L, 1024) * 3000).astype(np.float32)
        meta = K7_PATTERNS[pattern](rng, B, L)
        launches = aac_synth.K7.launches
        y, carry_d = aac_synth.synthesize(
            tabs_d, torch.from_numpy(spec).to(dev),
            torch.from_numpy(meta).to(dev), carry_d)
        assert aac_synth.K7.launches == launches + 1
        y_p, carry_c = aac_synth.synthesize(
            tabs_c, torch.from_numpy(spec), torch.from_numpy(meta), carry_c)
        y_m, carry_m = k7_model.synthesize(spec, meta, carry_m)
        assert y.shape == (B, L, 1024) and carry_d.shape == (L, 1024)
        assert ((y.cpu() - y_p) * 32768).abs().max() <= 1
        assert np.abs(y.cpu().numpy() - y_m).max() * 32768 <= 1
        assert (carry_d.cpu() - carry_c).abs().max() < 0.25
        assert np.abs(carry_d.cpu().numpy() - carry_m).max() < 0.25


@pytest.mark.parametrize("run", [1, 3, 7])
def test_k7_runs_agree(dev, run):
    """K7's output does not depend on how the batch is cut into runs (each
    run recomputes the frame before it): B = 16, L = 12, every case, bit
    for bit against run = 2, and against its numpy model."""
    rng = np.random.RandomState(run)
    tabs = aac_synth.Tables().to(dev)
    spec = (rng.randn(16, 12, 1024) * 3000).astype(np.float32)
    meta = K7_PATTERNS["every-case"](rng, 16, 12)
    carry = (rng.randn(12, 1024) * 3000).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (spec, meta, carry)]
    y0, c0 = aac_synth.synthesize_cuda(tabs, *args, run=2)
    y, c = aac_synth.synthesize_cuda(tabs, *args, run=run)
    assert torch.equal(y, y0) and torch.equal(c, c0)
    y_m, c_m = k7_model.synthesize(spec, meta, carry, run)
    assert np.abs(y.cpu().numpy() - y_m).max() * 32768 <= 1
    assert np.abs(c.cpu().numpy() - c_m).max() < 0.25


@pytest.mark.parametrize("C,N", [(2, 7), (2, 1000), (12, 122880),
                                 (2, 122880), (12, 4100), (1, 4097),
                                 (5, 999)])
def test_k9_matches_plain(dev, C, N):
    """K9's peaks and history bit for bit against the twin over two
    batches from a nonzero history; then K3 fed by K9 against the twin's
    true-peak limiter, 0 LSB and an equal state (tp_hist included)."""
    rng = np.random.RandomState(C * 7 + N)
    hist_c = _noise(rng, C, limiter.TP_HIST, 0.5)
    hist_d = hist_c.to(dev)
    xs = [_noise(rng, C, N, 0.5) for _ in range(2)]
    for x in xs:
        launches = limiter.K9.launches
        pk_d, hist_d = one_stream(limiter.truepeak_cuda, x.to(dev), hist_d)
        assert limiter.K9.launches == launches + 1
        pk_c, hist_c = one_stream(limiter.truepeak_plain, x, hist_c)
        assert torch.equal(pk_d.cpu(), pk_c)
        assert torch.equal(hist_d.cpu(), hist_c)
    cfg = limiter.LimiterConfig(channels=C, true_peak=True)
    st = limiter.init_state(cfg, "cpu")
    st["tp_hist"] = _noise(rng, C, limiter.TP_HIST, 0.5)
    _k3_chain(dev, cfg, st, xs)


CODEC_PATHS = {
    "aac714_ssJ": lambda s: (s.build_aac_layout_stream(
        ChannelLayout.L714, n_frames=20, seed=4)[0],
        dict(sound_system=9, batch_frames=8), (aac_synth.K7, limiter.K3)),
    "aac51_loud_binaural": lambda s: (s.build_aac_layout_stream(
        ChannelLayout.L510, n_frames=20, seed=5, gain_offset=8, hrm=1)[0],
        dict(binaural=True, batch_frames=8), (aac_synth.K7, binaural.K8)),
    "truepeak_51": lambda s: (s.build_pcm_layout_stream(
        ChannelLayout.L510, n_frames=24,
        pcm_override=s.isp_tone_pcm(24, 6))[0],
        dict(sound_system=1, batch_frames=8), (limiter.K9, limiter.K3)),
}


@pytest.mark.parametrize("name", sorted(CODEC_PATHS))
def test_codec_paths_match_cpu(dev, name, monkeypatch):
    """AAC (K7) and IAMF_TRUEPEAK=1 (K9 feeding K3) decodes on the card
    against the CPU run, over three batches."""
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
    from iamf_tpu_torch.tools import streams

    data, kw, must = CODEC_PATHS[name](streams)
    if name.startswith("truepeak"):
        monkeypatch.setenv("IAMF_TRUEPEAK", "1")
    kernels = (aac_synth.K7, limiter.K9, limiter.K3, binaural.K8)
    for k in kernels:
        k.reset()
    got = BatchedStreamDecoder(data, device=dev, **kw).decode_all()
    want = BatchedStreamDecoder(data, device="cpu", **kw).decode_all()
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert all(k.launches > 0 for k in must)
    assert all(k.plain_on_cuda == 0 for k in kernels)


def _stack(states):
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


@pytest.mark.parametrize("true_peak", [False, True])
@pytest.mark.parametrize("C", [2, 12])
def test_stream_axis_k3_k9(dev, C, true_peak):
    """K3 (fed by K9 in true-peak mode) on x [3, C, N] in one launch: each
    stream equal to an S = 1 call on the card and to the twin, 0 LSB and a
    bit-equal state, over two batches; the streams start idle, engaged and
    mid-release. K9 at S = 3 bit for bit against three S = 1 calls."""
    rng = np.random.RandomState(C + 100 * true_peak)
    cfg = limiter.LimiterConfig(channels=C, true_peak=true_peak)
    N = 4 * 960
    states = [limiter.init_state(cfg, "cpu"), limiter.init_state(cfg, "cpu"),
              _mid_release(limiter.LimiterConfig(channels=C), rng)]
    if true_peak:
        states[2]["tp_hist"] = _noise(rng, C, limiter.TP_HIST, 0.5)
    st_c = _stack(states)
    st_d = {k: v.to(dev) for k, v in st_c.items()}
    singles = [{k: v.to(dev) for k, v in st.items()} for st in states]
    for level in (0.5, 0.1):
        x = torch.stack([_noise(rng, C, N, lv) for lv in (level, 0.05,
                                                          level)])
        xd = x.to(dev)
        if true_peak:
            launches = limiter.K9.launches
            pk, h = limiter.truepeak_cuda(xd, st_d["tp_hist"])
            assert limiter.K9.launches == launches + 1
            for s in range(3):
                pk1, h1 = limiter.truepeak_cuda(xd[s:s + 1],
                                                st_d["tp_hist"][s:s + 1])
                assert torch.equal(pk[s:s + 1], pk1)
                assert torch.equal(h[s:s + 1], h1)
        launches = limiter.K3.launches
        st_d, q_d = limiter.limit_quantize(cfg, st_d, xd, 16, 960)
        assert limiter.K3.launches == launches + 1
        st_c, q_c = limiter.limit_quantize(cfg, st_c, x, 16, 960)
        assert torch.equal(q_d.cpu(), q_c)
        for k in st_c:
            assert torch.equal(st_d[k].cpu(), st_c[k]), k
        for s in range(3):
            singles[s], q1 = one_stream(limiter.limit_quantize, cfg,
                                        singles[s], xd[s], 16, 960)
            assert torch.equal(q_d[s], q1)
            for k in st_c:
                assert torch.equal(st_d[k][s], singles[s][k]), (s, k)


@pytest.mark.parametrize("C", [6, 12])
def test_stream_axis_k8(dev, C):
    """K8 on beds [3, C, B*T] in one launch, one bank: each stream equal to
    an S = 1 call on the card and within K8's bound of the twin."""
    rng = np.random.RandomState(C)
    B, T = 16, 960
    bank = binaural.hrir_bank(K8_BEDS[C])
    hrir_d = binaural.hrir_for_batch(bank, B, T, dev)
    hrir_c = binaural.hrir_for_batch(bank, B, T, "cpu")
    x = torch.from_numpy((rng.randn(3, C, B * T) * 0.3).astype(np.float32))
    ov = torch.from_numpy((rng.randn(3, 2, 255) * 0.1).astype(np.float32))
    launches = binaural.K8.launches
    y, o = binaural.hrtf_conv(hrir_d, x.to(dev), ov.to(dev))
    assert binaural.K8.launches == launches + 1
    y_c, o_c = binaural.hrtf_conv(hrir_c, x, ov)
    assert (y.cpu() - y_c).abs().max() < 1e-4
    assert (o.cpu() - o_c).abs().max() < 1e-4
    for s in range(3):
        y1, o1 = binaural.hrtf_conv(hrir_d, x[s:s + 1].to(dev),
                                    ov[s:s + 1].to(dev))
        assert torch.equal(y[s:s + 1], y1) and torch.equal(o[s:s + 1], o1)


def test_server_on_card(dev):
    """A PCM 7.1.4 fleet of unequal lengths and the Opus sample with a cut
    of it, served on the card: each stream within 1 LSB of its own card
    decode (fetch=False; cuBLAS may pick another product for the render
    with more frames in its batch), and one launch of each kernel per call
    of a bucket."""
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
    from iamf_tpu_torch.core.serving import MultiStreamServer
    from iamf_tpu_torch.tools import streams

    data = open(os.path.join(ROOT, "iamf_tpu", "data",
                             "sample_opus_714.iamf"), "rb").read()
    desc, units = streams.split_into_units(data)
    fleet = [streams.build_pcm_layout_stream(ChannelLayout.L714, n_frames=n,
                                             amp=0.9, seed=n)[0]
             for n in (20, 13)] + [data, desc + b"".join(units[:12])]
    kw = dict(sound_system=9, batch_frames=8)
    kernels = (imdct.K1, synth.K2, limiter.K3)
    for k in kernels:
        k.reset()
    srv = MultiStreamServer(fleet, device=dev, **kw)
    outs = srv.decode_all()
    assert srv.n_buckets == 2
    fleet_launches = [k.launches for k in kernels]
    for stream, got in zip(fleet, outs):
        own = BatchedStreamDecoder(stream, device=dev,
                                   **kw).decode_all(fetch=False)
        assert len(got) == len(own)
        for a, b in zip(got, own):
            assert (a.int() - b.int()).abs().max() <= 1
    # a bucket makes one call per kept batch of its longest member: the
    # PCM bucket 3 (20 frames at B = 8), the Opus bucket 3 (16 frames and
    # the head-trim call)
    assert fleet_launches == [3, 3, 6]
    assert all(k.plain_on_cuda == 0 for k in kernels)


SHARDED = {
    # name: (stream, sound system, mesh keywords, kernels of the path)
    "pcm714_loud_1d": (lambda s, sample: s.build_pcm_layout_stream(
        ChannelLayout.L714, n_frames=24, amp=0.95)[0], 9,
        dict(n_devices=4), ("K3",)),
    "sample_1d": (lambda s, sample: sample, 9, dict(n_devices=4),
                  ("K1", "K2", "K3")),
    "sample_elements": (lambda s, sample: sample, 9,
                        dict(n_devices=4, element_axis=2),
                        ("K1", "K2", "K3")),
    "two_element_elements": (lambda s, sample: s.build_two_element_stream(
        n_frames=16, gain2_q78=-(3 << 8))[0], 0,
        dict(n_devices=4, element_axis=2), ("K3",)),
    "sample_substreams": (lambda s, sample: sample, 9,
                          dict(n_devices=4, substream_axis=2),
                          ("K1", "K2", "K3")),
    "sample_lane_padding": (lambda s, sample: sample, 9,
                            dict(n_devices=5, substream_axis=5),
                            ("K1", "K2", "K3")),
    "aac714_1d": (lambda s, sample: s.build_aac_layout_stream(
        ChannelLayout.L714, n_frames=24)[0], 9, dict(n_devices=4),
        ("K7", "K3")),
}


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_on_card(dev, name):
    """ShardedStreamDecoder on the card (the shards over the visible cards,
    several a card when there are fewer): within 1 LSB of the card's
    batched decode (cuBLAS may pick another render product for another
    frame count), the path's kernels launched, no twin on the card. The
    1-D sample runs K1, K2 and K3 once a shard."""
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
    from iamf_tpu_torch.parallel.sharded_decoder import \
        ShardedStreamDecoder
    from iamf_tpu_torch.tools import streams

    sample = open(os.path.join(ROOT, "iamf_tpu", "data",
                               "sample_opus_714.iamf"), "rb").read()
    build, ss, mesh_kw, must = SHARDED[name]
    data = build(streams, sample)
    kernels = {"K1": imdct.K1, "K2": synth.K2, "K3": limiter.K3,
               "K7": aac_synth.K7}
    for k in kernels.values():
        k.reset()
    got = ShardedStreamDecoder(data, sound_system=ss, device=dev,
                               **mesh_kw).decode_all()
    launches = {n: k.launches for n, k in kernels.items()}
    want = BatchedStreamDecoder(data, sound_system=ss, batch_frames=8,
                                device=dev).decode_all()
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert all(launches[n] > 0 for n in must), launches
    assert all(k.plain_on_cuda == 0 for k in kernels.values())
    if name == "sample_1d":
        assert launches == {"K1": 4, "K2": 4, "K3": 4, "K7": 0}


def test_sharded_true_peak_on_card(dev, monkeypatch):
    """IAMF_TRUEPEAK=1 on the sharded path: K9 meters each shard inside
    K3's chain (tp_hist handed along), equal to the card's batched
    decode."""
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
    from iamf_tpu_torch.parallel.sharded_decoder import \
        ShardedStreamDecoder
    from iamf_tpu_torch.tools import streams

    monkeypatch.setenv("IAMF_TRUEPEAK", "1")
    data = streams.build_pcm_layout_stream(
        ChannelLayout.L510, n_frames=24,
        pcm_override=streams.isp_tone_pcm(24, 6))[0]
    limiter.K9.reset()
    got = ShardedStreamDecoder(data, n_devices=4, sound_system=1,
                               device=dev).decode_all()
    # a K9 launch a K3 call: the 4 shards' chain and the drain (24 frames
    # fill the mesh, so one more call on delay_size zeros)
    assert limiter.K9.launches == 5 and limiter.K9.plain_on_cuda == 0
    want = BatchedStreamDecoder(data, sound_system=1, batch_frames=8,
                                device=dev).decode_all()
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_pipelined_on_card(dev):
    """PipelinedStreamDecoder with both stages on the card (two entries of
    one card; two cards where visible): bit-equal to the batched decode on
    the Opus sample and on loud PCM."""
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
    from iamf_tpu_torch.parallel.pp_decoder import PipelinedStreamDecoder
    from iamf_tpu_torch.tools import streams

    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [cards[0], cards[-1]]
    sample = open(os.path.join(ROOT, "iamf_tpu", "data",
                               "sample_opus_714.iamf"), "rb").read()
    loud = streams.build_pcm_layout_stream(ChannelLayout.L510, n_frames=12,
                                           amp=0.95)[0]
    for data, ss in ((sample, 9), (loud, 1)):
        for k in (imdct.K1, synth.K2, limiter.K3):
            k.reset()
        got = PipelinedStreamDecoder(data, devices=devices, sound_system=ss,
                                     batch_frames=4).decode_all()
        want = BatchedStreamDecoder(data, sound_system=ss, batch_frames=4,
                                    device=cards[0]).decode_all()
        assert np.array_equal(got, want)
        assert limiter.K3.launches > 0 and limiter.K3.plain_on_cuda == 0


@pytest.mark.parametrize("true_peak", [False, True])
@pytest.mark.parametrize("frame", [960, 1024])
def test_serial_limiter_per_frame(dev, frame, true_peak):
    """The serial Limiter on the card, frame by frame through the
    first-call swallow, a burst and the drain's delay_size zeros: one K3
    launch a frame (and one K9 in true-peak mode), none for an empty
    frame; 0 LSB and an equal state against the CPU twin."""
    rng = np.random.RandomState(frame)
    C = 6
    cfg = limiter.LimiterConfig(channels=C, true_peak=true_peak)
    ld, lc = limiter.Limiter(cfg, device=dev), limiter.Limiter(cfg, "cpu")
    x = _noise(rng, C, 6 * frame, 0.3)
    x[:, 2 * frame:3 * frame] *= 4.0
    blocks = [x[:, i:i + frame] for i in range(0, 6 * frame, frame)]
    blocks += [x[:, :0], torch.zeros(C, cfg.delay_size)]
    for b in blocks:
        k3, k9 = limiter.K3.launches, limiter.K9.launches
        got = ld.process(b.to(dev), 16).cpu()
        n = 1 if b.shape[1] else 0
        assert limiter.K3.launches == k3 + n
        assert limiter.K9.launches == k9 + (n if true_peak else 0)
        want = lc.process(b, 16)
        assert torch.equal(got, want)
        assert ld.delay == lc.delay
    for k, v in lc.state.items():
        assert torch.equal(ld.state[k].cpu(), v), k
    assert limiter.K3.plain_on_cuda == limiter.K9.plain_on_cuda == 0


@pytest.mark.parametrize("frame", [960, 1024])
@pytest.mark.parametrize("C", [10, 12])
def test_serial_hrtf_renderer_per_frame(dev, C, frame):
    """The serial HRTFRenderer on the card: one K8 launch a frame, each
    frame and the carried overlap within 1e-4 of the CPU twin."""
    rng = np.random.RandomState(C + frame)
    rd = binaural.HRTFRenderer(K8_BEDS[C], frame, device=dev)
    rc = binaural.HRTFRenderer(K8_BEDS[C], frame, device="cpu")
    for _ in range(4):
        x = _noise(rng, C, frame, 0.3)
        launches = binaural.K8.launches
        y = rd.render(x.to(dev))
        assert binaural.K8.launches == launches + 1
        assert (y.cpu() - rc.render(x)).abs().max() < 1e-4
    assert (rd.overlap.cpu() - rc.overlap).abs().max() < 1e-4
    assert binaural.K8.plain_on_cuda == 0


SERIAL_PATHS = {
    "pcm714_ssJ": lambda s: (s.build_pcm_layout_stream(
        ChannelLayout.L714, n_frames=12, amp=0.9)[0], dict(ss=9)),
    "m2b714": lambda s: (s.build_pcm_layout_stream(
        ChannelLayout.L714, n_frames=12, amp=0.5, hrm=1)[0],
        dict(binaural=True)),
    "aac714_ssJ": lambda s: (s.build_aac_layout_stream(
        ChannelLayout.L714, n_frames=12)[0], dict(ss=9)),
    "scalable_ss1": lambda s: (s.build_scalable_pcm_stream(
        n_frames=10, demix_modes=[0, 1, 2, 1, 0] * 2,
        recon_gains=[(200, 180), (120, 90)])[0], dict(ss=1)),
}


@pytest.mark.parametrize("name", sorted(SERIAL_PATHS))
def test_serial_decoder_on_card(dev, name, monkeypatch):
    """IAMFDecoder on the card against its CPU run: 1 LSB, the same
    shape; K3 launched once for each frame that reaches the limiter (the
    frames and the drain), K8 once for each binaural frame."""
    from iamf_tpu_torch.api import IAMFDecoder
    from iamf_tpu_torch.tools import streams
    from test_torch_api import serial_decode

    data, kw = SERIAL_PATHS[name](streams)
    reach = {"limiter": 0, "hrtf": 0}
    lim_process = limiter.Limiter.process
    hrtf_render = binaural.HRTFRenderer.render

    def counted_process(self, x, *a):
        reach["limiter"] += x.shape[1] > 0
        return lim_process(self, x, *a)

    def counted_render(self, x):
        reach["hrtf"] += 1
        return hrtf_render(self, x)

    monkeypatch.setattr(limiter.Limiter, "process", counted_process)
    monkeypatch.setattr(binaural.HRTFRenderer, "render", counted_render)
    for k in (limiter.K3, binaural.K8):
        k.reset()
    got = serial_decode(IAMFDecoder(device=dev), data, **kw)
    k3, k8 = limiter.K3.launches, binaural.K8.launches
    frames = dict(reach)
    want = serial_decode(IAMFDecoder(device="cpu"), data, **kw)
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert (k3, k8) == (frames["limiter"], frames["hrtf"])
    assert k3 >= 11 and (k8 >= 12) == name.startswith("m2b")
    assert limiter.K3.plain_on_cuda == binaural.K8.plain_on_cuda == 0


# ---- K11-K13: the CELT device entropy stages on the Opus sample -----------

@pytest.fixture(scope="module")
def celt():
    """The native taps of the Opus sample: its frames, all their leaves,
    and the 32 mono frames' packed tensors (on the CPU twin's leaf
    vectors)."""
    from iamf_tpu_torch.codecs.opus import band_pack, device_bands, \
        device_leaf
    from iamf_tpu_torch.tools import celt_taps

    frames = celt_taps.tap_stream(open(os.path.join(
        ROOT, "iamf_tpu", "data", "sample_opus_714.iamf"), "rb").read())
    leaves = celt_taps.all_leaves(frames)
    vecs = device_leaf.reconstruct(*leaves[:6], device="cpu").numpy()
    bts, lts, seeds, off = [], [], [], 0
    for f in frames:
        L = len(f.leaves[0])
        if f.tap_C == 1:
            pf = band_pack.pack_frame(f.recs)
            bt, lt = device_bands.pack_tensors(pf, list(vecs[off:off + L]))
            bts.append(bt)
            lts.append(lt)
            seeds.append(pf.seed0)
        off += L
    return frames, leaves, bts, lts, seeds


def _i32(t):
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


@pytest.mark.parametrize("align,n_max", [(True, 96), (False, 96),
                                         (True, 24), (False, 24)])
def test_k11_matches_plain(dev, celt, align, n_max):
    """K11 bit for bit against its twin on the sample's leaves of n <=
    n_max, and the aligned rows against the native walk."""
    from iamf_tpu_torch import convert
    from iamf_tpu_torch.codecs.opus import device_cwrsi as dc

    n, k, idx = celt[1][:3]
    sel = n <= n_max
    lb = convert.leaf_batch(*(a[sel] for a in celt[1][:6]), "cpu")
    args = [lb[key] for key in ("n", "k", "idx")]
    dc.K11.reset()
    got = dc.cwrsi_batch(*(a.to(dev) for a in args), align, n_max)
    assert dc.K11.launches == 1 and dc.K11.plain_on_cuda == 0
    want = dc.cwrsi_plain(*args, align, n_max)
    assert torch.equal(got.cpu(), want)
    if align:
        assert np.array_equal(got.cpu().numpy(), dc.host_reference(
            n[sel], k[sel], idx[sel])[:, :n_max])


def _k11_corpus(name):
    """(n, k, idx) numpy: celt_taps' random leaves (4,096, seed 11) and
    edges; the random leaves' first 1, 31 and 33; 2,112 leaves all of
    n = 96, k in [1, 128], the index uniform in [0, V(96, k))."""
    from iamf_tpu_torch.tools import celt_taps

    if name == "edges":
        return celt_taps.edge_leaves()
    if name != "all96":
        n, k, idx = celt_taps.random_leaves(np.random.default_rng(11), 4096)
        cut = {"random": 4096, "one": 1, "31": 31, "33": 33}[name]
        return n[:cut], k[:cut], idx[:cut]
    rng = np.random.default_rng(96)
    k = rng.integers(1, 129, size=2112)
    idx = np.array([rng.integers(0, celt_taps.v_count(96, int(b)))
                    for b in k], np.uint32)
    return np.full(2112, 96, np.int32), k.astype(np.int32), idx


@pytest.mark.parametrize("align,n_max", [(True, 96), (False, 96),
                                         (True, 24), (False, 24)])
@pytest.mark.parametrize("name", ["random", "edges", "one", "31", "33",
                                  "all96"])
def test_k11_corpora(dev, name, align, n_max):
    """K11 bit for bit against its twin in one launch on every leaf of a
    corpus (at n_max 24 too, the leaves above it included: both clamp),
    and the aligned rows at n_max 96 against the native walk."""
    from iamf_tpu_torch.codecs.opus import device_cwrsi as dc

    n, k, idx = _k11_corpus(name)
    args = [torch.from_numpy(a) for a in (n, k, idx)]
    dc.K11.reset()
    got = dc.cwrsi_batch(*(a.to(dev) for a in args), align, n_max)
    torch.cuda.synchronize()
    assert dc.K11.launches == 1 and dc.K11.plain_on_cuda == 0
    assert torch.equal(got.cpu(), dc.cwrsi_plain(*args, align, n_max))
    if align and n_max == 96:
        assert np.array_equal(got.cpu().numpy(),
                              dc.host_reference(n, k, idx))


def test_k11_leaf_counts_around_the_grid(dev):
    """K11 bit for bit against its twin, one launch a call, on leaf counts
    around its grid's limits: min(ceil(L / WARPS), SMs * BLOCKS_SM)
    blocks, block b taking leaves b + grid m, WARPS * 32 a round. Below,
    at and past the grid's full width; one round of every block full and
    one leaf past it. The leaves are the random corpus's, repeated."""
    import re

    from iamf_tpu_torch.codecs.opus import device_cwrsi as dc

    src = open(os.path.join(ROOT, "iamf_tpu_torch", "csrc",
                            "celt_cwrsi.cu")).read()
    warps, blocks_sm = (int(re.search(rf"constexpr int {c} = (\d+);",
                                      src).group(1))
                        for c in ("WARPS", "BLOCKS_SM"))
    full = torch.cuda.get_device_properties(dev).multi_processor_count \
        * blocks_sm
    corpus = _k11_corpus("random")
    for L in (warps * (full - 1), warps * (full - 1) + 1, warps * full,
              warps * full + 1, full * warps * 32, full * warps * 32 + 1):
        args = [torch.from_numpy(np.resize(a, L)) for a in corpus]
        dc.K11.reset()
        got = dc.cwrsi_batch(*(a.to(dev) for a in args), True, 96)
        assert dc.K11.launches == 1, L
        assert torch.equal(got.cpu(), dc.cwrsi_plain(*args, True, 96)), L


def test_k11_every_n_max(dev):
    """K11 bit for bit against its twin at every n_max in [2, 96], both
    layouts, one launch a call: on the random corpus's first 512 leaves,
    the edges and 300 leaves outside the walk's range (n in [-3, 110), k
    in [-3, 140), any index; kernel and twin treat them alike)."""
    from iamf_tpu_torch.codecs.opus import device_cwrsi as dc

    rng = np.random.default_rng(5)
    outside = (rng.integers(-3, 110, 300).astype(np.int32),
               rng.integers(-3, 140, 300).astype(np.int32),
               rng.integers(0, 1 << 32, 300, dtype=np.uint64).astype(
                   np.uint32))
    parts = (_k11_corpus("random"), _k11_corpus("edges"), outside)
    args = [torch.from_numpy(np.concatenate([p[j][:512] for p in parts]))
            for j in range(3)]
    on_dev = [a.to(dev) for a in args]
    for n_max in range(2, 97):
        for align in (True, False):
            dc.K11.reset()
            got = dc.cwrsi_batch(*on_dev, align, n_max)
            assert dc.K11.launches == 1
            assert torch.equal(got.cpu(), dc.cwrsi_plain(*args, align, n_max)), \
                (n_max, align)


def test_k12_matches_plain(dev, celt):
    """K12's normalize-and-rotate within rel 1e-6 of each row's peak of
    its twin (the normalization alone bit for bit), its rotation alone
    likewise, and the LCG entries bit for bit."""
    from iamf_tpu_torch.codecs.opus import device_cwrsi as dc
    from iamf_tpu_torch.codecs.opus import device_leaf as dl

    n, k, idx, gain, spread, blocks, _ = celt[1]
    cfg, bank = dl.rotation_plan(n, k, spread, blocks)
    y = dc.cwrsi_plain(*(torch.from_numpy(a) for a in (n, k, idx)))
    g = torch.from_numpy(gain)
    c, b = torch.from_numpy(cfg), torch.from_numpy(bank)
    want = dl.normalize_rotate_plain(y, g, c, b)
    got = dl.normalize_rotate(y.to(dev), g.to(dev), c.to(dev), b.to(dev))
    rel = ((got.cpu() - want).abs().amax(1) / want.abs().amax(1)).max()
    assert float(rel) <= 1e-6
    assert torch.equal(dl.normalize_pulses(y.to(dev), g.to(dev)).cpu(),
                       dl.normalize_rotate_plain(y, g))
    sel = torch.from_numpy(np.flatnonzero(cfg >= 0))
    r = dl.apply_rotations(want[sel].to(dev), c[sel].to(dev), b.to(dev))
    rw = dl.apply_rotations(want[sel], c[sel], b)
    assert float(((r.cpu() - rw).abs().amax(1) / rw.abs().amax(1)).max()) \
        <= 1e-6
    rng = np.random.default_rng(3)
    draws = torch.from_numpy(rng.choice([0, 0, 4, 8, 176, 700], 3000
                                        ).astype(np.int32))
    for seed in (0, 0xDEADBEEF):
        e_d = dl.lcg_leaf_entry_seeds(seed, draws.to(dev))
        e_p = dl.lcg_leaf_entry_seeds(seed, draws)
        assert torch.equal(_i32(e_d).cpu(), _i32(e_p))
        assert torch.equal(_i32(dl.lcg_noise_fill(e_d, None, 176)).cpu(),
                           _i32(dl.lcg_noise_fill(e_p, None, 176)))


def test_k13_batch_equals_frames(dev, celt):
    """K13 over the sample's 32 mono frames in one launch: each frame bit
    for bit equal to its own F = 1 call, within rel 2e-5 of the twin's
    spectrum with equal seeds and collapse masks, and on the native
    taps."""
    from iamf_tpu_torch import convert
    from iamf_tpu_torch.codecs.opus import device_bands as db

    frames, _, bts, lts, seeds = celt
    db.K13.reset()
    spec, seed, coll = db.run_frame(bts, lts, seeds, device=dev)
    assert db.K13.launches == 1 and db.K13.plain_on_cuda == 0
    for j in range(len(bts)):
        s1, k1, c1 = db.run_frame(bts[j], lts[j], seeds[j], device=dev)
        assert torch.equal(s1, spec[j])
        assert int(_i32(k1)) == int(_i32(seed[j]))
        assert torch.equal(_i32(c1), _i32(coll[j]))
    bt, lt = convert.packed_frame(bts, lts, "cpu")
    sp, kp, cp = db.run_frames_plain(
        bt, lt, torch.from_numpy(np.array(seeds, np.uint32)))
    rel = ((spec.cpu() - sp).abs().amax(1) / sp.abs().amax(1)).max()
    assert float(rel) < 2e-5
    assert torch.equal(_i32(seed).cpu(), _i32(kp))
    assert torch.equal(_i32(coll).cpu(), _i32(cp))
    mono = [f for f in frames if f.tap_C == 1]
    assert np.array_equal(seed.cpu().numpy(),
                          np.array([f.seed_out for f in mono], np.uint32))
    want = np.stack([f.X[0] for f in mono])
    got = spec.cpu().numpy()
    assert (np.abs(got - want).max(1) / np.abs(want).max(1)).max() < 2e-5


@pytest.mark.parametrize("F", [1, 33])
def test_k13_cluster_counts(dev, celt, F):
    """K13 (a cluster of four CTAs a frame) at F frames, 33 being more
    clusters than the card runs at once: each frame bit for bit its own
    F = 1 call, seeds and collapse masks equal, one launch."""
    from iamf_tpu_torch import convert
    from iamf_tpu_torch.codecs.opus import device_bands as db

    _, _, bts, lts, seeds = celt
    pick = [j % len(bts) for j in range(F)]
    bt, lt = convert.packed_frame([bts[j] for j in pick],
                                  [lts[j] for j in pick], dev)
    s0 = torch.from_numpy(np.array([seeds[j] for j in pick], np.uint32))
    db.K13.reset()
    spec, seed, coll = db.run_frames_cuda(bt, lt, s0.to(dev))
    assert db.K13.launches == 1 and db.K13.plain_on_cuda == 0
    for j, src in enumerate(pick):
        s1, k1, c1 = db.run_frame(bts[src], lts[src], seeds[src], device=dev)
        assert torch.equal(s1, spec[j])
        assert int(_i32(k1)) == int(_i32(seed[j]))
        assert torch.equal(_i32(c1), _i32(coll[j]))


@pytest.mark.parametrize("kind", ["noise", "pvq", "fold"])
def test_k13_synthetic_frames(dev, kind):
    """K13 on 40 synthetic frames (tests/test_torch_celt_kernels.py: LCG
    draws far along a band, n = 1 and n above the band's width, b_leaf up
    to 16, offsets outside [0, N), windows past the norm buffer, k = -1,
    inactive slots between active ones, absent and last bands) against
    its twin: rel 2e-5 of each frame's peak, seeds and collapse masks
    equal, one launch; frame 0 alone bit for bit its place in the batch."""
    from test_torch_celt_kernels import synthetic_frames

    from iamf_tpu_torch import convert
    from iamf_tpu_torch.codecs.opus import device_bands as db

    bts, lts, seeds = synthetic_frames(kind, 40)
    bt, lt = convert.packed_frame(bts, lts, "cpu")
    s0 = torch.from_numpy(np.array(seeds, np.uint32))
    db.K13.reset()
    spec, seed, coll = db.run_frames_cuda(
        {k: v.to(dev) for k, v in bt.items()},
        {k: v.to(dev) for k, v in lt.items()}, s0.to(dev))
    assert db.K13.launches == 1 and db.K13.plain_on_cuda == 0
    sp, kp, cp = db.run_frames_plain(bt, lt, s0)
    scale = sp.abs().amax(1)
    assert bool((scale > 0).all())
    assert float(((spec.cpu() - sp).abs().amax(1) / scale).max()) < 2e-5
    assert torch.equal(_i32(seed).cpu(), _i32(kp))
    assert torch.equal(_i32(coll).cpu(), _i32(cp))
    s1, k1, c1 = db.run_frame(bts[0], lts[0], seeds[0], device=dev)
    assert torch.equal(s1, spec[0])
    assert int(_i32(k1)) == int(_i32(seed[0]))
    assert torch.equal(_i32(c1), _i32(coll[0]))


def _k12_case(case, celt):
    """(y or None, X or None, gain, cfg or None, bank or None) on the CPU
    for a K12 card case: the sample's leaves cut or repeated so that one
    configuration holds many leaves (and more than a block's list holds:
    7,000 copies of its rows), one leaf, or none rotates."""
    from iamf_tpu_torch.codecs.opus import device_cwrsi as dc
    from iamf_tpu_torch.codecs.opus import device_leaf as dl

    n, k, idx, gain, spread, blocks, _ = celt[1]
    cfg, bank = dl.rotation_plan(n, k, spread, blocks)
    y = dc.cwrsi_plain(*(torch.from_numpy(a) for a in (n, k, idx)))
    g = torch.from_numpy(gain)
    counts = np.bincount(cfg[cfg >= 0])
    if case == "many":  # the fullest configuration, 7,000 times over
        c = int(np.argmax(counts))
        rows = np.flatnonzero(cfg == c)
        sel = np.concatenate([np.resize(rows, 7000), np.flatnonzero(cfg < 0)
                              [:500]])
        return y[sel], None, g[sel], torch.from_numpy(cfg[sel]), \
            torch.from_numpy(bank)
    if case == "one":  # configurations of a single leaf among others
        c = int(np.flatnonzero(counts == 1)[0])
        sel = np.concatenate([np.flatnonzero(cfg == c),
                              np.flatnonzero(cfg < 0)[:100]])
        return y[sel], None, g[sel], torch.from_numpy(cfg[sel]), \
            torch.from_numpy(bank)
    if case == "none":  # cfg given, no leaf rotates
        sel = np.flatnonzero(cfg < 0)[:1000]
        return y[sel], None, g[sel], torch.from_numpy(cfg[sel]), \
            torch.from_numpy(bank)
    if case == "narrow":  # normalize only, W < 96
        sel = np.flatnonzero(n <= 24)
        return y[sel][:, :24].contiguous(), None, g[sel], None, None
    assert case == "apply"  # apply_rotations: X given
    X = dl.normalize_rotate_plain(y, g)
    return None, X, None, torch.from_numpy(cfg), torch.from_numpy(bank)


@pytest.mark.parametrize("case", ["many", "one", "none", "narrow", "apply"])
def test_k12_cases(dev, celt, case):
    """K12 (a block a configuration, then a warp a leaf) against its twin:
    rel 1e-6 of each row's peak, the rows that do not rotate bit for bit,
    one launch a call."""
    from iamf_tpu_torch.codecs.opus import device_leaf as dl

    y, X, g, cfg, bank = _k12_case(case, celt)
    on = [t.to(dev) if t is not None else None for t in (y, X, g, cfg, bank)]
    dl.K12.reset()
    if X is None:
        got = dl.normalize_rotate(on[0], on[2], on[3], on[4]).cpu()
        want = dl.normalize_rotate_plain(y, g, cfg, bank)
    else:
        got = dl.apply_rotations(on[1], on[3], on[4]).cpu()
        want = dl.apply_rotations(X, cfg, bank)
    assert dl.K12.launches == 1 and dl.K12.plain_on_cuda == 0
    scale = want.abs().amax(1).clamp(min=1e-30)
    assert float(((got - want).abs().amax(1) / scale).max()) <= 1e-6
    still = torch.ones(len(want), dtype=torch.bool) if cfg is None \
        else cfg < 0
    assert torch.equal(got[still], want[still])
