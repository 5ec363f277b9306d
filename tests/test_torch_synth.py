"""CELT synthesis of the PyTorch port vs the JAX package
(tpu_synth.synthesize_packed): K1 + K2's plain twins on the CPU.

Bound: <= 1 s16 LSB on the PCM. Both sides start from the same carry
(carried across with iamf_tpu_torch.convert) and chain it over two
batches, so the TDAC tail, comb history and de-emphasis memory cross a
batch edge.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iamf_tpu.codecs.opus import tpu_synth
from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as JaxDecoder
from iamf_tpu_torch import convert
from iamf_tpu_torch.codecs.opus import synth
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from test_torch_opus_modes import synth_both, synth_buffers

SAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "iamf_tpu", "data", "sample_opus_714.iamf")


def _synth_both(bufs, lanes):
    carry_j = tpu_synth.init_carry(lanes)
    carry_p = convert.synth_carry(carry_j, "cpu")
    mod = synth.CeltSynth()
    for buf in bufs:
        pcm_j, carry_j = tpu_synth.synthesize_packed(
            jnp.asarray(buf), carry_j, chunk=13)
        pcm_p, carry_p = synth.synthesize_packed(
            mod, torch.from_numpy(buf.copy()), carry_p)
        assert pcm_p.shape == tuple(pcm_j.shape)
        d = np.abs(np.asarray(pcm_j) - pcm_p.numpy()) * 32768.0
        assert d.max() <= 1.0, f"{d.max()} LSB"
        # the carries agree to well under an LSB at s16 scale
        assert np.abs(np.asarray(carry_j.hist)
                      - carry_p.hist.numpy()).max() < 1.0
        assert np.abs(np.asarray(carry_j.tail)
                      - carry_p.tail.numpy()).max() < 0.25


def _sample_buffers():
    data = open(SAMPLE, "rb").read()
    jd = JaxDecoder(data, sound_system=9, batch_frames=8)
    pd = BatchedStreamDecoder(data, sound_system=9, batch_frames=8,
                              device="cpu")
    je, pe = jd.elems[0], pd.elems[0]
    jp = [jd.frames_per_substream[s] for s in je.substream_ids]
    pp = [pd.frames_per_substream[s] for s in pe.substream_ids]
    bufs = []
    for start in (0, 8):
        want = jd._opus_entropy(je, jp, start, 8, 8)[0]
        got = pd._opus_entropy(pe, pp, start, 8, 8)
        # the port's JAX-free copy of the spectrum export is exact
        assert np.array_equal(got, want)
        bufs.append(got)
    return bufs, sum(ch for _, ch in pe.codec._decoders)


def _random_buffers():
    """Random spectra, transients and legal comb parameters with period
    and gain changes between frames (periods 15..1024)."""
    rng = np.random.RandomState(5)
    B, L = 4, 2
    taps = np.asarray(tpu_synth._tables()[1]).reshape(3, 3)
    bufs = []
    per = rng.randint(15, 1025, size=L)
    g = np.zeros((L, 3), np.float32)
    for _ in range(2):
        buf = np.zeros((B, L, 973), np.float32)
        buf[..., :960] = rng.randn(B, L, 960) * 100.0
        buf[..., 960] = rng.rand(B, L) < 0.3
        for b in range(B):
            new_per = np.where(rng.rand(L) < 0.5, per,
                               rng.randint(15, 1025, size=L))
            new_g = (np.float32(0.09375) * rng.randint(0, 9, size=L))[
                :, None] * taps[rng.randint(0, 3, size=L)]
            buf[b, :, 961] = per
            buf[b, :, 962] = per
            buf[b, :, 963] = new_per
            buf[b, :, 964:967] = g
            buf[b, :, 967:970] = g
            buf[b, :, 970:973] = new_g
            per, g = new_per, new_g
        bufs.append(buf)
    return bufs, L


@pytest.mark.parametrize("source", ["sample_spectra", "random_comb"])
def test_synthesis_matches_jax(source):
    bufs, lanes = (_sample_buffers() if source == "sample_spectra"
                   else _random_buffers())
    _synth_both(bufs, lanes)


def test_unported_operating_points_raise():
    """Once refused, 480-sample rows now synthesize: the CELT-480 constants
    take them and match the JAX package (the other frame sizes and hybrid:
    tests/test_torch_opus_modes.py); constants of another n refuse them."""
    bufs = synth_buffers(4, 2, 480, False, seed=11)
    synth_both(bufs, 480, False)
    with pytest.raises(ValueError, match="n=960"):
        synth.synthesize_packed(synth.CeltSynth(), torch.from_numpy(bufs[0]),
                                synth.init_carry(2, "cpu"))


def test_celt_constants_built_once_per_device():
    """Decoders on one device share the read-only CELT constants."""
    cpu = torch.device("cpu")
    a, b = synth.celt_synth(cpu), synth.celt_synth(cpu)
    assert a is b and a.mats.w_long_hi.device == cpu
    assert torch.equal(a.mats.atl, synth.CeltSynth().mats.atl)
