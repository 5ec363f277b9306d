"""The PyTorch port's JAX-free copies of host layers vs their originals.

core/stream.py, core/presentation.py, core/timeline.py and dsp/demix.py's
host state machines are copies of the JAX package's (whose modules import
JAX at module level); codecs/opus/decoder.py copies the spectrum export.
Driven through both packages' BatchedStreamDecoder construction, they must
give equal arrays and equal configurations.
"""

import dataclasses
import os

import numpy as np
import pytest

import vectors
from iamf_tpu.constants import AnimationType, ChannelLayout
from iamf_tpu.core import presentation as jpres
from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as JaxDecoder
from iamf_tpu_torch import convert
from iamf_tpu_torch.core import presentation as ppres
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

SAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "iamf_tpu", "data", "sample_opus_714.iamf")


def _gain_segments(n, step):
    return [{"animation": AnimationType.LINEAR, "start": -step * (i % 4),
             "end": -step * ((i + 1) % 4)} for i in range(n)]


STREAMS = {
    "opus_sample_ssJ": (lambda: open(SAMPLE, "rb").read(), 9),
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
    jd = JaxDecoder(data, sound_system=ss, batch_frames=8)
    pd = BatchedStreamDecoder(data, sound_system=ss, batch_frames=8,
                              device="cpu")
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
    # the replayed timeline
    assert pd.trims == jd.trims and (pd.lead, pd.tail) == (jd.lead, jd.tail)
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
