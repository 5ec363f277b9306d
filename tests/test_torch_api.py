"""The port's frame-serial decoder (iamf_tpu_torch.api.IAMFDecoder, on the
CPU) against the JAX package's (iamf_tpu.api.IAMFDecoder) on the same
bytes, and the serial pieces under it against their JAX counterparts.

Bound for a decode: the same shape and dtype, <= 1 step of the output
integer (an s16 LSB at 16 bits, one int32 step at 24): the two packages
evaluate the demix, the render matrices and the HRTF FFTs with different
libraries, which may move a float by an ULP and a sample across a rounding
boundary. Each assert message records the max difference.

Content comes from the tests/vectors.py builders; the AAC-LC and FLAC
content from the port's own builders (iamf_tpu_torch/tools/streams.py),
which need no encoder.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import vectors
from iamf_tpu import api as japi
from iamf_tpu.constants import AnimationType, ChannelLayout
from iamf_tpu.dsp import binaural as jbin
from iamf_tpu.dsp import downmix as jdmx
from iamf_tpu.dsp import limiter as jlim
from iamf_tpu.dsp import quantize as jq
from iamf_tpu.dsp import resample as jres
from iamf_tpu.utils.wav import read_wav
from iamf_tpu_torch import api as papi
from iamf_tpu_torch import convert
from iamf_tpu_torch.dsp import binaural as pbin
from iamf_tpu_torch.dsp import downmix as pdmx
from iamf_tpu_torch.dsp import limiter as plim
from iamf_tpu_torch.dsp import quantize as pq
from iamf_tpu_torch.dsp import resample as pres
from iamf_tpu_torch.tools import streams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "iamf_tpu", "data", "sample_opus_714.iamf")
L = ChannelLayout


def _gains(n, step):
    return [{"animation": AnimationType.LINEAR, "start": -step * (i % 4),
             "end": -step * ((i + 1) % 4)} for i in range(n)]


def _opus_units(n):
    desc, units = vectors.split_into_units(open(SAMPLE, "rb").read())
    return desc + b"".join(units[:n])


def serial_decode(dec, stream, ss=0, binaural=False, setters=(),
                  attrs=()):
    """The player's bitstream loop (iamf_tpu/tools/player.py
    decode_bitstream): configure, decode unit by unit (a new sequence
    header reconfigures), flush. Returns the int PCM [samples, channels]."""
    for k, v in attrs:
        setattr(dec, k, v)
    if binaural:
        dec.set_binaural()
    else:
        dec.set_sound_system(ss)
    for k, v in setters:
        getattr(dec, f"set_{k}")(v)
    pos = dec.configure(stream)
    chunks = []
    while pos < len(stream):
        try:
            consumed, pcm = dec.decode(stream[pos:])
        except (japi.InvalidState, papi.InvalidState):
            pos += dec.configure(stream[pos:])
            continue
        if consumed == 0 and pcm is None:
            break
        pos += consumed
        if pcm is not None and len(pcm):
            chunks.append(pcm)
    _, pcm = dec.decode(None)
    if pcm is not None and len(pcm):
        chunks.append(pcm)
    return np.concatenate(chunks, axis=0)


def assert_close(got, want, what, bound=1):
    assert got.shape == want.shape and got.dtype == want.dtype, (
        f"{what}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    d = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max()) \
        if got.size else 0
    assert d <= bound, f"{what}: max|diff| {d} > {bound}"
    return d


# name -> (stream maker, decode options)
CASES = {
    "stereo_ss0_16bit": (lambda: vectors.build_pcm_stereo_stream(
        n_frames=6)[0], dict(ss=0)),
    "stereo_ss0_24bit": (lambda: vectors.build_pcm_stereo_stream(
        n_frames=6, sample_size=24)[0], dict(ss=0, setters=[("bit_depth",
                                                             24)])),
    "stereo_mix_gains_animated": (lambda: vectors.build_pcm_layout_stream(
        L.STEREO, n_frames=8, mix_gain_segments=_gains(8, 256),
        out_gain_segments=_gains(8, 128))[0], dict(ss=0)),
    "stereo_mix_gain_constant": (lambda: vectors.build_pcm_stereo_stream(
        n_frames=5, mix_gain_q78=-6 * 256)[0], dict(ss=0)),
    "stereo_upmix_ss1": (lambda: vectors.build_pcm_stereo_stream(
        n_frames=5)[0], dict(ss=1)),
    "pcm51_downmix_ss0": (lambda: vectors.build_pcm_51_stream(
        n_frames=8, demix_modes=[0, 1, 2, 1, 0, 1, 2, 2])[0], dict(ss=0)),
    "pcm714_downmix_ss2": (lambda: vectors.build_pcm_layout_stream(
        L.L714, n_frames=6, demix_modes=[0, 1, 2, 0, 1, 2],
        layout_specs=[vectors.builder.LayoutSpec(sound_system=2)])[0],
        dict(ss=2)),
    "pcm51_loud_limiter": (lambda: vectors.build_pcm_51_stream(
        n_frames=8, amp=0.95)[0], dict(ss=1, setters=[
            ("peak_limiter_threshold", -3.0)])),
    "pcm51_loud_limiter_off": (lambda: vectors.build_pcm_51_stream(
        n_frames=5, amp=0.95)[0], dict(ss=1, setters=[
            ("peak_limiter_enable", False)])),
    "pcm51_normalization": (lambda: vectors.build_pcm_51_stream(
        n_frames=5)[0], dict(ss=1, setters=[
            ("normalization_loudness", -18.0)])),
    "mono_ss0": (lambda: vectors.build_pcm_mono_stream(n_frames=5)[0],
                 dict(ss=0)),
    "foa_ss1": (lambda: vectors.build_ambisonics_pcm_stream(
        order=1, n_frames=5)[0], dict(ss=1)),
    "toa_ss9": (lambda: vectors.build_ambisonics_pcm_stream(
        order=3, n_frames=4)[0], dict(ss=9)),
    "soa_projection_ss1": (lambda: vectors.build_ambisonics_pcm_stream(
        order=2, n_frames=4, projection=True)[0], dict(ss=1)),
    "foa_lfe_synthesis_ss1": (lambda: vectors.build_ambisonics_pcm_stream(
        order=1, n_frames=5)[0], dict(ss=1, setters=[
            ("hoa_lfe_synthesis", True)])),
    "scalable_layer_ss0": (lambda: vectors.build_scalable_pcm_stream(
        n_frames=6)[0], dict(ss=0)),
    "scalable_demix_recon_ss1": (lambda: vectors.build_scalable_pcm_stream(
        n_frames=10, demix_modes=[0, 1, 2, 1, 3, 1, 2, 0, 1, 1],
        recon_gains=[(200, 180), (255, 255), (120, 90)])[0], dict(ss=1)),
    "scalable_output_gain_ss1": (lambda: vectors.build_scalable_pcm_stream(
        n_frames=6, layer2_output_gain=(0b001100, -3 * 256))[0],
        dict(ss=1)),
    "m2b_714": (lambda: vectors.build_pcm_layout_stream(
        L.L714, n_frames=5, hrm=1)[0], dict(binaural=True)),
    "h2b_foa": (lambda: vectors.build_ambisonics_pcm_stream(
        order=1, n_frames=5, hrm=1)[0], dict(binaural=True)),
    "two_elements_binaural": (lambda: vectors.build_two_element_stream(
        n_frames=5, gain2_q78=-(3 << 8), hrm=1)[0], dict(binaural=True)),
    "two_elements_ss0": (lambda: vectors.build_two_element_stream(
        n_frames=5, gain2_q78=-(3 << 8))[0], dict(ss=0)),
    "resample_441_ss1": (lambda: vectors.build_pcm_51_stream(
        n_frames=6, rate=44100)[0], dict(ss=1)),
    "resample_441_normalization": (lambda: vectors.build_pcm_51_stream(
        n_frames=6, rate=44100)[0], dict(ss=1, setters=[
            ("normalization_loudness", -10.0)])),
    "resample_441_no_limiter": (lambda: vectors.build_pcm_layout_stream(
        L.STEREO, n_frames=5, rate=44100)[0], dict(ss=0, setters=[
            ("peak_limiter_enable", False)])),
    "reconfigure_mid_stream": (lambda: vectors.build_pcm_layout_stream(
        L.STEREO, n_frames=4)[0] + vectors.build_pcm_51_stream(
        n_frames=4)[0], dict(ss=1)),
    "samsung_tv_stride12": (lambda: vectors.build_pcm_51_stream(
        n_frames=4)[0], dict(ss=1, attrs=[("samsung_tv", True)])),
    "opus_sample_8_units_ssJ": (lambda: _opus_units(8), dict(ss=9)),
    "aac_lc_51_ss1": (lambda: streams.build_aac_layout_stream(
        L.L510, n_frames=6)[0], dict(ss=1)),
    "aac_lc_stereo_binaural": (lambda: streams.build_aac_layout_stream(
        L.STEREO, n_frames=5, hrm=1)[0], dict(binaural=True)),
    "flac_51_ss0": (lambda: streams.build_flac_layout_stream(
        L.L510, n_frames=5)[0], dict(ss=0)),
}


@functools.lru_cache(maxsize=None)
def _stream(name):
    return CASES[name][0]()


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_matches_jax(name):
    data = _stream(name)
    kw = CASES[name][1]
    want = serial_decode(japi.IAMFDecoder(), data, **kw)
    got = serial_decode(papi.IAMFDecoder(device="cpu"), data, **kw)
    assert len(want) > 0
    assert_close(got, want, name)
    if name == "stereo_ss0_24bit":
        assert got.dtype == np.int32 and np.abs(got).max() > 1 << 16
    if name == "samsung_tv_stride12":
        assert got.shape[1] == 12 and not got[:, 6:].any()


def test_truepeak_matches_jax(monkeypatch):
    """IAMF_TRUEPEAK=1: the meter feeds the serial limiter in both."""
    monkeypatch.setenv("IAMF_TRUEPEAK", "1")
    data = streams.build_pcm_layout_stream(
        L.L510, n_frames=6, pcm_override=streams.isp_tone_pcm(6, 6))[0]
    want = serial_decode(japi.IAMFDecoder(), data, ss=1)
    dec = papi.IAMFDecoder(device="cpu")
    got = serial_decode(dec, data, ss=1)
    assert dec.limiter.cfg.true_peak and "tp_hist" in dec.limiter.state
    assert_close(got, want, "true peak")
    monkeypatch.delenv("IAMF_TRUEPEAK")
    plain = serial_decode(papi.IAMFDecoder(device="cpu"), data, ss=1)
    assert not np.array_equal(plain, got)  # the meter changed the gain


def _reuse_decode(dec, data, switch_at, targets):
    """Decode `data`, re-targeting the output layout after every
    `switch_at` frames through configure(None) with stream reuse (the
    player's -test_soundsystem loop)."""
    dec.set_sound_system(targets[0])
    pos = dec.configure(data)
    chunks, frames, k = [], 0, 1
    while pos < len(data):
        if frames and frames % switch_at == 0 and k < len(targets):
            t = targets[k]
            k += 1
            if t == "b":
                dec.set_binaural()
            else:
                dec.set_sound_system(t)
            dec.configure(None)
        consumed, pcm = dec.decode(data[pos:])
        if consumed == 0 and pcm is None:
            break
        pos += consumed
        if pcm is not None and len(pcm):
            chunks.append(pcm)
            frames += 1
    _, pcm = dec.decode(None)
    if pcm is not None and len(pcm):
        chunks.append(pcm)
    return chunks


@pytest.mark.parametrize("content", ["scalable", "opus_sample"])
def test_configure_none_stream_reuse(content):
    if content == "scalable":
        data = vectors.build_scalable_pcm_stream(
            n_frames=9, demix_modes=[0, 1, 2] * 3,
            recon_gains=[(200, 180), (120, 90)])[0]
        targets = [1, 0, 1]
    else:
        data = _opus_units(9)
        targets = [9, 1, "b"]
    want = _reuse_decode(japi.IAMFDecoder(), data, 3, targets)
    got = _reuse_decode(papi.IAMFDecoder(device="cpu"), data, 3, targets)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, f"{content} chunk {i}")


def test_metadata_and_pts():
    data = vectors.build_scalable_pcm_stream(
        n_frames=6, demix_modes=[0, 1, 2, 1, 0, 1])[0]
    decs = [japi.IAMFDecoder(), papi.IAMFDecoder(device="cpu")]
    for dec in decs:
        dec.set_pts(-1234, 90000)
        serial_decode(dec, data, ss=1)
    jm, pm = (dataclasses.asdict(d.get_last_metadata()) for d in decs)
    assert repr(pm) == repr(jm)
    assert pm["dmixp_mode"] >= 0 and pm["num_parameters"] == 1
    assert decs[1].pts == decs[0].pts and decs[1].pts_time_base == 90000
    # the Opus sample trims its pre-skip: the PTS moves by it
    decs = [japi.IAMFDecoder(), papi.IAMFDecoder(device="cpu")]
    for dec in decs:
        serial_decode(dec, _opus_units(3), ss=9)
    assert decs[1].pts == decs[0].pts != 0
    for f in ("layout_sound_system_channels_count",):
        assert all(getattr(papi.IAMFDecoder, f)(s)
                   == getattr(japi.IAMFDecoder, f)(s) for s in range(-1, 14))
    assert (papi.IAMFDecoder.get_codec_capability()
            == japi.IAMFDecoder.get_codec_capability())


def test_write_stream_logs(tmp_path):
    """The SR-style stage taps (rec_/ren_/mix_) of both decoders: the same
    files, with equal samples."""
    data = vectors.build_two_element_stream(n_frames=5,
                                            gain2_q78=-(3 << 8))[0]
    written = {}
    for tag, dec in (("jax", japi.IAMFDecoder()),
                     ("port", papi.IAMFDecoder(device="cpu"))):
        dec.stream_log = True
        serial_decode(dec, data, ss=1)
        written[tag] = dec.write_stream_logs(str(tmp_path / tag))
    names = sorted(os.path.basename(p) for p in written["jax"])
    assert names == sorted(os.path.basename(p) for p in written["port"])
    assert "mix.wav" in names and len(names) == 5
    for n in names:
        a = read_wav(str(tmp_path / "jax" / n))
        b = read_wav(str(tmp_path / "port" / n))
        assert a[1:] == b[1:]
        assert_close(b[0], a[0], n, bound=0)


def test_no_data_and_errors():
    dec = papi.IAMFDecoder(device="cpu")
    with pytest.raises(papi.IAMFError):
        dec.decode(b"\x00")
    with pytest.raises(papi.IAMFError):
        dec.configure(None)
    with pytest.raises(papi.IAMFError):
        dec.configure(b"\x00" * 8)


# --- the serial pieces against their JAX counterparts ----------------------

def _loud(C, T, seed):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((C, T)) * 0.3).astype(np.float32)
    x[:, T // 3:T // 2] *= 4.0  # a burst over the threshold
    return x


@pytest.mark.parametrize("frame", [960, 1024])
def test_limiter_matches_jax(frame):
    """Frames through both serial limiters: the first-call swallow, an
    empty call, an engaged burst, the drain's delay_size zeros. The JAX
    limiter's jitted scan rounds a few products of the gain step
    differently from the op-by-op order the port keeps (see
    test_torch_limiter.check_walk): <= 1 LSB, the same envelope time and
    delay line, the gains within 4 ULP."""
    cfg_j = jlim.LimiterConfig(channels=3, threshold_db=-2.0)
    cfg_p = plim.LimiterConfig(channels=3, threshold_db=-2.0)
    jl, pl = jlim.Limiter(cfg_j), plim.Limiter(cfg_p, device="cpu")
    x = _loud(3, 5 * frame, 3)
    blocks = [x[:, :100], x[:, 100:100], x[:, 100:frame]] + [
        x[:, i:i + frame] for i in range(frame, 5 * frame, frame)] + [
        np.zeros((3, cfg_j.delay_size), np.float32)]
    for i, b in enumerate(blocks):
        got = pl.process(torch.from_numpy(b), 16).numpy()
        if not b.shape[1]:
            # nothing in, nothing out, the swallow untouched (the JAX
            # limiter's scan takes no empty block)
            assert got.shape == (0, 3) and pl.delay == jl.delay
            continue
        want = np.asarray(jq.quantize_interleave(jl.process(b), 16))
        assert_close(got, want, f"block {i}")
        assert pl.delay == jl.delay and pl.inited == jl.inited
    st = pl.state
    env = np.array([jl.state[k] for k in ("current_gain", "target_start_gain",
                                          "target_end_gain", "current_tc")],
                   np.float32)
    ulp = np.abs(st["env"][0].numpy().view(np.int32).astype(np.int64)
                 - env.view(np.int32)).max()
    assert ulp <= 4 and st["env"][0, 3] == env[3], (ulp, env)
    assert np.array_equal(st["delay_data"][0].numpy(),
                          np.asarray(jl.state["delay_data"]))
    assert int(st["entry_index"][0, 0]) == int(jl.state["entry_index"])
    pl.reset()
    assert pl.delay == 0 and not pl.inited


def test_limiter_continues_from_jax_state():
    """convert.serial_limiter_state: start the port's limiter mid-stream
    from the JAX limiter's state and match the JAX continuation (<= 1
    LSB, as test_limiter_matches_jax)."""
    cfg_j = jlim.LimiterConfig(channels=2)
    jl = jlim.Limiter(cfg_j)
    x = _loud(2, 6 * 960, 5)
    for i in range(3):
        jl.process(x[:, i * 960:(i + 1) * 960])
    pl = plim.Limiter(plim.LimiterConfig(channels=2), device="cpu")
    pl.state = convert.serial_limiter_state(jl, "cpu")
    pl.padsize, pl.inited = jl.padsize, jl.inited
    for i in range(3, 6):
        b = x[:, i * 960:(i + 1) * 960]
        want = np.asarray(jq.quantize_interleave(jl.process(b), 16))
        assert_close(pl.process(torch.from_numpy(b), 16).numpy(), want,
                     f"frame {i}")


@pytest.mark.parametrize("layout,frame", [(L.L714, 960), (L.L510, 1024),
                                          (L.STEREO, 480)])
def test_hrtf_renderer_matches_jax(layout, frame):
    jr = jbin.HRTFRenderer(layout, frame)
    pr = pbin.HRTFRenderer(layout, frame, device="cpu")
    C = jbin.hrir_bank(layout).shape[1]
    x = _loud(C, 4 * frame, 8)
    for i in range(4):
        b = x[:, i * frame:(i + 1) * frame]
        want = jr.render(b)
        got = pr.render(torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(pr.overlap[0].numpy(),
                               np.asarray(jr.overlap), rtol=0, atol=2e-6)
    pr.reset()
    assert not pr.overlap.any() and pr.overlap.shape == (1, 2, 255)


def test_hrtf_renderer_continues_from_jax_overlap():
    """convert.hrtf_overlap: start the port's renderer from the JAX
    renderer's overlap and match the JAX continuation."""
    jr = jbin.HRTFRenderer(L.L510, 960)
    x = _loud(6, 4 * 960, 9)
    for i in range(2):
        jr.render(x[:, i * 960:(i + 1) * 960])
    pr = pbin.HRTFRenderer(L.L510, 960, device="cpu")
    pr.overlap = convert.hrtf_overlap(jr, "cpu")
    for i in range(2, 4):
        b = x[:, i * 960:(i + 1) * 960]
        np.testing.assert_allclose(pr.render(torch.from_numpy(b)).numpy(),
                                   jr.render(b), rtol=0, atol=2e-6)


@pytest.mark.parametrize("src,dst,mode,w", [
    (L.L510, L.STEREO, 1, 0), (L.L714, L.L512, 2, 5), (L.L714, L.MONO, 4, 10),
    (L.L712, L.L312, 1, -1)])
def test_downmix_apply_matches_jax(src, dst, mode, w):
    from iamf_tpu.constants import LAYOUT_CHANNELS_RENDER

    x = _loud(len(LAYOUT_CHANNELS_RENDER[src]), 960, 4)
    want = np.asarray(jdmx.downmix_apply(x, src, dst, mode, w))
    got = pdmx.downmix_apply(torch.from_numpy(x), src, dst, mode, w).numpy()
    assert got.shape == want.shape
    d = np.abs(got.view(np.int32).astype(np.int64)
               - want.view(np.int32).astype(np.int64)).max()
    assert d <= 1, f"{d} ULP"


@pytest.mark.parametrize("rate", [44100, 32000, 96000])
def test_resampler_process_drain_match_jax(rate):
    jr = jres.Resampler(3, rate, 48000)
    pr = pres.Resampler(3, rate, 48000)
    x = _loud(3, 4 * 900 + 17, 6) * 0.5
    for a, b in ((0, 900), (900, 1700), (1700, 1700), (1700, x.shape[1])):
        assert np.array_equal(pr.process(x[:, a:b]), jr.process(x[:, a:b]))
        assert (pr.last_sample, pr.samp_frac_num) == (
            jr.last_sample, jr.samp_frac_num)
        assert pr.output_latency == jr.output_latency
    assert np.array_equal(pr.drain(), jr.drain())
    assert np.array_equal(pr.mem, jr.mem)


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_quantize_stride_matches_jax(bits):
    x = _loud(6, 300, 2)
    want = np.asarray(jq.quantize_interleave(x, bits, 12))
    got = pq.quantize_interleave(torch.from_numpy(x), bits, 12).numpy()
    assert got.shape == (300, 12) and got.dtype == want.dtype
    assert np.array_equal(got, want)
    back = pq.dequantize_planar(torch.from_numpy(got), bits).numpy()
    assert np.array_equal(back, np.asarray(jq.dequantize_planar(want, bits)))
