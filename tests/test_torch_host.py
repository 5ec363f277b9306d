"""The PyTorch port's JAX-free copies of host layers vs their originals.

core/stream.py, core/presentation.py, core/timeline.py and dsp/demix.py's
host state machines are copies of the JAX package's (whose modules import
JAX at module level); codecs/opus/decoder.py copies the spectrum export;
dsp/binaural.py copies the HRIR model and the segment plan, dsp/resample.py
the speexdsp filter design, its streaming state and DeviceResampler's
precompute; utils/wav.py, mp4/atoms.py and tools/vlogger.py are
byte-identical copies (their imports are relative, so they resolve inside
the port). Driven
through both packages' BatchedStreamDecoder construction, or called with
the same arguments, they must give equal arrays and equal configurations.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

import vectors
from iamf_tpu.constants import AnimationType, ChannelLayout
from iamf_tpu.core import presentation as jpres
from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as JaxDecoder
from iamf_tpu.dsp import binaural as jbin
from iamf_tpu.dsp import resample as jres
from iamf_tpu_torch import convert
from iamf_tpu_torch.core import presentation as ppres
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from iamf_tpu_torch.dsp import binaural as pbin
from iamf_tpu_torch.dsp import resample as pres

SAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "iamf_tpu", "data", "sample_opus_714.iamf")


def _gain_segments(n, step):
    return [{"animation": AnimationType.LINEAR, "start": -step * (i % 4),
             "end": -step * ((i + 1) % 4)} for i in range(n)]


STREAMS = {
    "opus_sample_ssJ": (lambda: open(SAMPLE, "rb").read(), 9),
    # binaural: M2B + H2B elements with HRIR banks
    "two_elements_binaural": (
        lambda: vectors.build_two_element_stream(n_frames=6, hrm=1)[0],
        dict(binaural=True)),
    # 44.1 kHz: float emission, the normalization gain kept for the tail
    "resample51_441_norm_ss1": (
        lambda: vectors.build_pcm_51_stream(n_frames=6, rate=44100)[0],
        dict(sound_system=1, normalization_db=-10.0)),
    # demix parameter blocks + animated element and output mix gains,
    # downmixed 7.1.4 -> 5.1.2
    "pcm714_param_blocks_ss2": (
        lambda: vectors.build_pcm_layout_stream(
            ChannelLayout.L714, n_frames=10, demix_modes=[0, 1, 2],
            mix_gain_segments=_gain_segments(10, 256),
            out_gain_segments=_gain_segments(10, 128),
            layout_specs=[vectors.builder.LayoutSpec(sound_system=2)])[0],
        2),
    # scalable layers: demix mode walk and recon-gain EMA
    "scalable_recon_ss1": (
        lambda: vectors.build_scalable_pcm_stream(
            n_frames=10, demix_modes=[0, 1, 2, 1],
            recon_gains=[(200, 180), (255, 255), (120, 90)])[0], 1),
}


def _asdict(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


def _stream_fields(stream):
    out = {}
    for k, v in vars(stream).items():
        if isinstance(v, list):
            v = [_asdict(x) for x in v]
        out[k] = _asdict(v)
    return out


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_host_copies_match(name):
    make, ss = STREAMS[name]
    data = make()
    kw = ss if isinstance(ss, dict) else dict(sound_system=ss)
    jd = JaxDecoder(data, batch_frames=8, **kw)
    pd = BatchedStreamDecoder(data, batch_frames=8, device="cpu", **kw)
    # presentation selection
    assert (pd.mix_presentation.mix_presentation_id
            == jd.mix_presentation.mix_presentation_id)
    for mod, dec in ((jpres, jd), (ppres, pd)):
        assert (mod.best_mix_presentation(dec.db, dec.layout)
                .mix_presentation_id
                == jd.mix_presentation.mix_presentation_id)
    assert (ppres.best_loudness(pd.mix_presentation, pd.layout)
            == jpres.best_loudness(jd.mix_presentation, jd.layout))
    # per-element Stream state
    assert len(pd.elems) == len(jd.elems)
    for pe, je in zip(pd.elems, jd.elems):
        assert _stream_fields(pe.stream) == _stream_fields(je.stream)
        assert np.array_equal(pe.render_mat, je.render_mat)
        assert (pe.hrtf_bank is None) == (je.hrtf_bank is None)
        if pe.hrtf_bank is not None:
            assert np.array_equal(pe.hrtf_bank, je.hrtf_bank)
    # the replayed timeline
    assert pd.trims == jd.trims and (pd.lead, pd.tail) == (jd.lead, jd.tail)
    assert (pd.needs_resample, pd._norm_gain) == (jd.needs_resample,
                                                  jd._norm_gain)
    tp, tj = pd.params, jd.params
    assert np.array_equal(tp.out_gain, tj.out_gain)
    assert tp.out_gain_per_sample == tj.out_gain_per_sample
    for ep, ej in zip(tp.elements, tj.elements):
        for f in ("factors", "rg", "mats", "mat_idx", "gain"):
            a, b = getattr(ep, f), getattr(ej, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert ep.rg_index == ej.rg_index
        assert ep.gain_per_sample == ej.gain_per_sample
    # and the pipeline configuration built from it
    assert pd.cfg == convert.pipeline_config(jd.cfg)
    if name.startswith("pcm"):
        assert tp.elements[0].gain_per_sample and tp.out_gain_per_sample
        assert len(tp.elements[0].mats) > 1
    if name.startswith("scalable"):
        assert tp.elements[0].rg_index
    if name.endswith("binaural"):
        assert all(es.hrtf_taps == 256 for es in pd.cfg.elements)
    if "441" in name:
        assert pd.cfg.emit_float and pd._norm_gain != 1.0


LAYOUTS = [ChannelLayout.STEREO, ChannelLayout.L510, ChannelLayout.L712,
           ChannelLayout.L714]


def test_binaural_host_copies_match(tmp_path):
    for layout in LAYOUTS:
        assert np.array_equal(pbin.hrir_bank(layout), jbin.hrir_bank(layout))
    for az, el, taps in ((30.0, 0.0, 256), (-110.0, 35.0, 128),
                         (90.0, -15.0, 512)):
        assert np.array_equal(pbin.spherical_head_hrir(az, el, taps),
                              jbin.spherical_head_hrir(az, el, taps))
    for n in (1, 7, 1215, 7935, 123135):
        assert pbin.fft_conv_len(n) == jbin.fft_conv_len(n)
    for B, T, taps in ((128, 960, 256), (3, 960, 256), (12, 480, 64),
                       (7, 1024, 256)):
        assert pbin.batch_seg_plan(B, T, taps) == jbin.batch_seg_plan(
            B, T, taps)
    assert pbin.batch_seg_plan(128, 960, 256) == (7680, 8000, 16)
    rng = np.random.RandomState(9)
    p = tmp_path / "set.npz"
    np.savez(p, az30_el0=rng.randn(2, 64).astype(np.float32),
             **{"az-30_el0": rng.randn(2, 48).astype(np.float32)})
    assert np.array_equal(
        pbin.load_hrir_bank(str(p), ChannelLayout.STEREO),
        jbin.load_hrir_bank(str(p), ChannelLayout.STEREO))


# the geometry the ported K10 is given per rate pair: N, num/den,
# in_chunk/out_chunk, carry_len
RATES = {44100: (64, 147, 160, 8085, 8800, 8116),
         16000: (64, 1, 3, 8192, 24576, 8223),
         32000: (64, 2, 3, 8192, 12288, 8223),
         96000: (128, 2, 1, 8192, 4096, 8255)}


@pytest.mark.parametrize("rate", sorted(RATES))
def test_resample_host_copies_match(rate):
    ours = pres.Resampler(2, rate, 48000)
    ref = jres.Resampler(2, rate, 48000)
    for f in ("num", "den", "filt_len", "oversample", "cutoff", "direct",
              "input_latency"):
        assert getattr(ours, f) == getattr(ref, f), f
    for f in ("bank", "table"):
        assert hasattr(ours, f) == hasattr(ref, f)
        if hasattr(ref, f):
            assert np.array_equal(getattr(ours, f), getattr(ref, f)), f
    plan = pres.ResamplePlan(rate, 48000, device="cpu")
    dr = jres.DeviceResampler(2, rate, 48000)
    geo = (plan.N, plan.num, plan.den, plan.in_chunk, plan.out_chunk,
           plan.carry_len)
    assert geo == (dr.N, dr.num, dr.den, dr.in_chunk, dr.out_chunk,
                   dr.carry_len) == RATES[rate]
    assert np.array_equal(plan.W.numpy(), dr.W)
    # K10's per-phase bank gives back the JAX package's rows
    o = np.arange(plan.out_chunk)
    assert np.array_equal(plan.bank.numpy()[(plan.num * o) % plan.den], dr.W)
    assert np.array_equal(plan.win_start.numpy(), dr.win_start)
    assert plan.input_latency == dr.host_params.input_latency
    for T in (1, 960, 44100 * 30):
        assert plan.n_out(T) == dr.n_out(T)


@pytest.mark.parametrize("path", ["utils/wav.py", "mp4/atoms.py",
                                  "tools/vlogger.py", "utils/__init__.py"])
def test_serial_host_modules_identical(path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert filecmp.cmp(os.path.join(root, "iamf_tpu", path),
                       os.path.join(root, "iamf_tpu_torch", path),
                       shallow=False)


def test_stage_timer_and_loggers(capsys):
    """utils/logging.py (a byte-identical copy, test_torch_celt_device.py
    holds it to the original): StageTimer's report as tests/test_aux.py
    checks the JAX one, and the levelled loggers print what the level mask
    lets through to stderr."""
    from iamf_tpu_torch.utils import logging as plog

    t = plog.StageTimer()
    t.add("decode", 0.5)
    t.add("render", 0.2)
    rep = t.report(10.0)
    assert "decode" in rep and "TOTAL" in rep and "x20" in rep
    plog.set_level("ew")
    try:
        plog.loge("K13", "shown")
        plog.logd("K13", "hidden")
        err = capsys.readouterr().err
        assert "[E][K13] shown" in err and "hidden" not in err
    finally:
        plog.set_level(os.environ.get("IAMF_DEBUG", "ew"))
