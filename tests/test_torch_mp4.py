"""IAMF in MP4 on the port: its muxer, demuxer and BatchedStreamDecoder
.from_mp4 against the JAX package's, on the same bytes.

The port carries byte-identical copies of iamf_tpu/mp4/{demux,iamf_track}.py
and iamf_tpu/tools/mp4builder.py, and copies of tests/vectors.py's
split_into_units / build_mp4 / build_fmp4 in tools/streams.py. Bounds: the
muxed files byte-equal; the demuxed structure equal; the decodes within 1
LSB of the JAX decoder's (0 on PCM, as tests/test_mp4.py demands of the
JAX path against the serial one), and the MP4-wrapped Opus sample within
1 LSB of the stored golden.
"""

import dataclasses
import filecmp
import functools
import os

import numpy as np
import pytest

import vectors
from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as JaxDecoder
from iamf_tpu.mp4.demux import MP4Demuxer as JaxDemuxer
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from iamf_tpu_torch.mp4.demux import MP4Demuxer
from iamf_tpu_torch.mp4.iamf_track import MP4IAMFParser
from iamf_tpu_torch.tools import streams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "iamf_tpu", "data", "sample_opus_714.iamf")
GOLDEN = os.path.join(ROOT, "iamf_tpu_torch", "data",
                      "sample_opus_714_ssJ.npz")


@functools.lru_cache(maxsize=None)
def _pcm51(n_frames):
    return vectors.build_pcm_51_stream(n_frames=n_frames)[0]


def _lsb(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()) \
        if a.size else 0


@pytest.mark.parametrize("path", ["mp4/demux.py", "mp4/iamf_track.py",
                                  "tools/mp4builder.py"])
def test_module_copies_identical(path):
    assert filecmp.cmp(os.path.join(ROOT, "iamf_tpu", path),
                       os.path.join(ROOT, "iamf_tpu_torch", path),
                       shallow=False)


# name: (port builder, JAX builder, keyword arguments)
MUXES = {
    "mp4": ("build_mp4", {}),
    "mp4_roll_media_time": ("build_mp4", dict(media_time=312,
                                              roll_distance=-4)),
    "fmp4": ("build_fmp4", dict(fragments=3)),
    "fmp4_base_data_offset": ("build_fmp4", dict(fragments=3,
                                                 base_data_offset=True)),
}


@pytest.mark.parametrize("name", sorted(MUXES))
def test_muxer_byte_equal(name):
    fn, kw = MUXES[name]
    stream = _pcm51(8)
    assert getattr(streams, fn)(stream, **kw) == getattr(vectors, fn)(
        stream, **kw)
    desc, units = streams.split_into_units(stream)
    assert (desc, units) == vectors.split_into_units(stream)


@pytest.mark.parametrize("name", sorted(MUXES))
def test_demux_structure_matches_jax(name, tmp_path):
    fn, kw = MUXES[name]
    path = str(tmp_path / "t.mp4")
    with open(path, "wb") as f:
        f.write(getattr(streams, fn)(_pcm51(8), **kw))
    got, want = MP4Demuxer(path), JaxDemuxer(path)
    assert got.fragmented == want.fragmented == name.startswith("fmp4")
    assert got.n_samples == want.n_samples == 8
    assert (dataclasses.astuple(got.iamf_track)
            == dataclasses.astuple(want.iamf_track))
    for i in range(got.n_samples):
        assert got.sample(i) == want.sample(i)
        assert got.sample_desc_index(i) == want.sample_desc_index(i)
    if "roll" in name:
        assert got.iamf_track.roll_distance == -4
        assert got.iamf_track.elst_media_time == 312
    parser = MP4IAMFParser(path)
    assert parser.timescale == 48000
    assert [p for p, nd in parser.packets()] == streams.split_into_units(
        _pcm51(8))[1]


# name: (mux, frames, batch_frames, start_sec), tests/test_mp4.py's cases
FROM_MP4 = {
    "mp4_pcm51_b3": ("build_mp4", 8, 3, 0.0),
    "fmp4_pcm51_b4": ("build_fmp4", 8, 4, 0.0),
    "mp4_seek_0.05_b4": ("build_mp4", 10, 4, 0.05),
}


@pytest.mark.parametrize("name", sorted(FROM_MP4))
def test_from_mp4_matches_jax(name, tmp_path):
    fn, n, B, start = FROM_MP4[name]
    path = str(tmp_path / "t.mp4")
    with open(path, "wb") as f:
        f.write(getattr(streams, fn)(_pcm51(n), fragments=3)
                if fn == "build_fmp4" else getattr(streams, fn)(_pcm51(n)))
    got = BatchedStreamDecoder.from_mp4(path, start_sec=start, sound_system=1,
                                        batch_frames=B, device="cpu")
    want = JaxDecoder.from_mp4(path, start_sec=start, sound_system=1,
                               batch_frames=B)
    assert got.n_frames == want.n_frames == n - (2 if start else 0)
    assert _lsb(got.decode_all(), want.decode_all()) == 0


def test_opus_sample_in_mp4_matches_golden(tmp_path):
    """The libopus sample wrapped by the port's muxer decodes as the raw
    sample does: within 1 LSB of the JAX decoder's stored decode."""
    path = str(tmp_path / "s.mp4")
    with open(path, "wb") as f:
        f.write(streams.build_mp4(open(SAMPLE, "rb").read()))
    got = BatchedStreamDecoder.from_mp4(path, sound_system=9, batch_frames=8,
                                        device="cpu").decode_all()
    assert _lsb(got, np.load(GOLDEN)["pcm"]) <= 1
