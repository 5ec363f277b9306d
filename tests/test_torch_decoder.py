"""The port's decode slice as a whole on the CPU: BatchedStreamDecoder of
iamf_tpu_torch vs iamf_tpu's, and the stored golden the GPU run is held to.

Bound: same shape, <= 1 LSB (the IMDCT's folded constants and the
de-emphasis order may move a sample by one LSB).
"""

import functools
import os

import numpy as np
import pytest

import test_torch_opus_modes as opus_modes
import vectors
from iamf_tpu.constants import ChannelLayout
from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as JaxDecoder
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "iamf_tpu", "data", "sample_opus_714.iamf")
GOLDEN = os.path.join(ROOT, "iamf_tpu_torch", "data",
                      "sample_opus_714_ssJ.npz")


@functools.lru_cache(maxsize=None)
def _stream(name):
    if name == "opus_sample":
        return open(SAMPLE, "rb").read()
    return vectors.build_pcm_layout_stream(
        ChannelLayout.L714, n_frames=20, amp=0.5)[0]


@functools.lru_cache(maxsize=None)
def _jax_decode(name):
    return JaxDecoder(_stream(name), sound_system=9,
                      batch_frames=8).decode_all()


def test_golden_is_current():
    """The golden chip_smoke.py holds the GPU decode to is exactly the JAX
    package's current decode of the sample (sound system J, batch 8)."""
    golden = np.load(GOLDEN)["pcm"]
    want = _jax_decode("opus_sample")
    assert golden.dtype == want.dtype and np.array_equal(golden, want)


@pytest.mark.parametrize("name", ["opus_sample", "pcm714"])
def test_decode_all_matches_jax(name):
    want = _jax_decode(name)
    got = BatchedStreamDecoder(_stream(name), sound_system=9, batch_frames=8,
                               device="cpu").decode_all()
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, f"{d.max()} LSB"


@pytest.mark.parametrize("truepeak,limiter", [("1", True), ("1", False),
                                               (None, True)])
def test_truepeak_switch(monkeypatch, truepeak, limiter):
    """IAMF_TRUEPEAK=1 asks the device limiter to meter true peaks, as it
    does the JAX decoder's (iamf_tpu/core/batch_decoder.py:539): both
    decoders read it at construction and agree within 1 LSB. Without the
    limiter, or with the switch unset, the decode runs as before."""
    if truepeak is None:
        monkeypatch.delenv("IAMF_TRUEPEAK", raising=False)
    else:
        monkeypatch.setenv("IAMF_TRUEPEAK", truepeak)

    got = BatchedStreamDecoder(_stream("pcm714"), sound_system=9,
                               batch_frames=8, limiter=limiter,
                               device="cpu").decode_all()
    if truepeak and limiter:
        want = JaxDecoder(_stream("pcm714"), sound_system=9,
                          batch_frames=8).decode_all()
    else:
        want = (_jax_decode("pcm714") if limiter else JaxDecoder(
            _stream("pcm714"), sound_system=9, batch_frames=8,
            limiter=False).decode_all())
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("split", [("silk", 960, 1), ("hybrid", 960, 1),
                                   ("celt", 480, 2), ("host", 960, 1)])
def test_unported_opus_operating_points_raise(split):
    """Once refused, every split of an Opus element now decodes: the
    sample re-TOCed to SILK-only (host float decode), hybrid-960, CELT-480
    two frames a unit and mixed hybrid/CELT (host), each within the bounds
    of tests/test_torch_opus_modes.py of the JAX decoder, with its stats
    path and opus_cfg."""
    name = {("silk", 960, 1): "silk960", ("hybrid", 960, 1): "hybrid960",
            ("celt", 480, 2): "celt480x2", ("host", 960, 1): "mixed"}[split]
    want, stats = opus_modes.jax_decode(name, 8)
    dec = BatchedStreamDecoder(opus_modes.stream(name), sound_system=9,
                               batch_frames=8, device="cpu")
    got = dec.decode_all()
    path, cfg = opus_modes.EXPECT[name]
    opus_modes.assert_lsb(got, want, loud=cfg is not None)
    assert dec.stats == stats and stats["elements"][0]["path"] == path
    if cfg is not None:
        assert cfg[:2] == split[1:] and cfg[2] == (split[0] == "hybrid")
