"""The general Opus operating points of the port against the JAX package on
the CPU: CELT frames of 120/240/480/960 samples, k frames a temporal unit,
hybrid SILK and the SILK/mixed host path.

Content and bounds: tests/opus_modes.py. The synthesis twins are held as
tests/test_torch_synth.py holds them (<= 1 LSB, TDAC tail < 0.25, comb
history < 1) on seeded random rows, the spectrum export bit for bit, and
the decodes with equal shapes, stats paths and opus_cfg. The port is held
to the JAX *batched* decoder, whose s16 clip it shares.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iamf_tpu.codecs.opus import tpu_synth
from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as JaxDecoder
from iamf_tpu_torch import convert
from iamf_tpu_torch.codecs.opus import synth
from iamf_tpu_torch.codecs.opus.decoder import FreshThreads
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from opus_modes import EXPECT, VARIANTS, assert_lsb, stream, synth_buffers


def jax_decoder(data: bytes, **kw):
    """The JAX BatchedStreamDecoder, its Opus spectrum export run on new
    threads as the port runs a hybrid one (a new thread a substream for its
    parallel split, one new thread for its serial one): the shared native
    hybrid band walk folds from thread-local scratch it has not written, so
    on reused threads its output depends on what they decoded before
    (ROADMAP.md §3); from new threads' zeroed scratch it is deterministic."""
    dec = JaxDecoder(data, **kw)
    for e in dec.elems:
        codec = e.codec
        if getattr(codec, "_decoders", None) and hasattr(
                codec, "decode_spectrum_batch"):
            codec._pool = FreshThreads()
            codec.decode_spectrum_batch = functools.partial(
                _on_new_thread, codec.decode_spectrum_batch)
    return dec


def _on_new_thread(fn, *a, **kw):
    return FreshThreads().map(lambda _: fn(*a, **kw), [0])[0]


@functools.lru_cache(maxsize=None)
def jax_decode(name: str, batch_frames: int):
    dec = jax_decoder(stream(name), sound_system=0 if name.startswith(
        "stereo") else 9, batch_frames=batch_frames)
    return dec.decode_all(), dec.stats


# --- synthesis twins ---------------------------------------------------------

def synth_both(bufs, n, hybrid):
    L = bufs[0].shape[1]
    carry_j = tpu_synth.init_carry(L)
    carry_p = convert.synth_carry(carry_j, "cpu")
    mod = synth.CeltSynth(n)
    for buf in bufs:
        pcm_j, carry_j = tpu_synth.synthesize_packed(
            jnp.asarray(buf), carry_j, chunk=13, n=n, hybrid=hybrid)
        pcm_p, carry_p = synth.synthesize_packed(
            mod, torch.from_numpy(buf.copy()), carry_p, n, hybrid)
        assert pcm_p.shape == tuple(pcm_j.shape)
        d = np.abs(np.asarray(pcm_j) - pcm_p.numpy()) * 32768.0
        assert d.max() <= 1.0, f"{d.max()} LSB"
        assert np.abs(np.asarray(carry_j.hist)
                      - carry_p.hist.numpy()).max() < 1.0
        assert np.abs(np.asarray(carry_j.tail)
                      - carry_p.tail.numpy()).max() < 0.25
        assert np.abs(np.asarray(carry_j.demem)
                      - carry_p.demem.numpy()).max() < 1.0


@pytest.mark.parametrize("n,hybrid", [(120, False), (240, False),
                                      (480, False), (960, False),
                                      (480, True), (960, True)])
def test_synthesis_matches_jax(n, hybrid):
    synth_both(synth_buffers(6, 3, n, hybrid, seed=n + hybrid), n, hybrid)


@pytest.mark.parametrize("B,n,hybrid", [
    (1, 480, False),   # 480 samples a lane: one short de-emphasis block
    (3, 240, True),    # 720, hybrid
    (5, 120, False),   # 600
    (5, 240, False),   # 1200: a full block and a padded one
    (3, 480, True),    # 1440, hybrid
    (9, 120, False),   # 1080
])
def test_short_calls_match_jax(B, n, hybrid):
    """Calls of fewer than 960 samples a lane, and calls that are not a
    multiple of 960 (the de-emphasis pads its last block)."""
    synth_both(synth_buffers(B, 3, n, hybrid, calls=3, seed=B * n), n,
               hybrid)


def test_neutral_rows_are_silent():
    for n, hybrid in ((120, False), (480, True), (960, True)):
        rows = synth.neutral_rows((2, 3), n, hybrid)
        assert rows.shape == (2, 3, synth.packed_width(n, hybrid))
        pcm, carry = synth.synthesize_packed(
            synth.CeltSynth(n), torch.from_numpy(rows),
            synth.init_carry(3, "cpu"), n, hybrid)
        assert not pcm.any() and not carry.hist.any()


def test_width_is_never_read_for_n():
    """CELT-960 and hybrid-480 rows are both 973 wide: the frame size comes
    from the constants, and a mismatch raises."""
    assert synth.packed_width(960, False) == synth.packed_width(480, True)
    buf = torch.from_numpy(synth.neutral_rows((1, 2), 480, True))
    with pytest.raises(ValueError, match="n=960"):
        synth.synthesize_packed(synth.CeltSynth(960), buf,
                                synth.init_carry(2, "cpu"), 960, True)


# --- the host entropy stage --------------------------------------------------

@pytest.mark.parametrize("name", [v for v in VARIANTS
                                  if EXPECT[v][1] is not None])
def test_decode_spectrum_batch_matches_jax(name):
    """The port's spectrum export equals the JAX method's buffers and
    parameters bit for bit, over two consecutive batches (the codec state
    chains), the packed rows included."""
    data = stream(name)
    jd = jax_decoder(data, sound_system=9, batch_frames=8)
    pd = BatchedStreamDecoder(data, sound_system=9, batch_frames=8,
                              device="cpu")
    je, pe = jd.elems[0], pd.elems[0]
    assert pe.opus_cfg == je.opus_cfg == EXPECT[name][1]
    jp = [jd.frames_per_substream[s] for s in je.substream_ids]
    pp = [pd.frames_per_substream[s] for s in pe.substream_ids]
    for start, count in ((0, 8), (8, 5)):
        want = jd._opus_entropy(je, jp, start, count, 8)[0]
        got = pd._opus_entropy(pe, pp, start, count, 8)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# --- the batched decoder ----------------------------------------------------

@pytest.mark.parametrize("batch_frames", [8, 3])
@pytest.mark.parametrize("name", VARIANTS)
def test_batched_decode_matches_jax(name, batch_frames):
    want, stats = jax_decode(name, batch_frames)
    dec = BatchedStreamDecoder(stream(name), sound_system=9,
                               batch_frames=batch_frames, device="cpu")
    got = dec.decode_all()
    assert_lsb(got, want, loud=EXPECT[name][1] is not None)
    assert dec.stats == stats
    path, cfg = EXPECT[name]
    assert stats["elements"][0]["path"] == path
    assert stats["elements"][0].get("opus_cfg") == cfg


@pytest.mark.parametrize("batch_frames", [3, 1])
@pytest.mark.parametrize("n", [480, 240])
def test_short_iamf_frames_match_jax(n, batch_frames):
    name = f"stereo{n}"
    want, stats = jax_decode(name, batch_frames)
    dec = BatchedStreamDecoder(stream(name), sound_system=0,
                               batch_frames=batch_frames, device="cpu")
    assert_lsb(dec.decode_all(), want, loud=True)
    assert dec.stats == stats
    assert stats["elements"][0]["opus_cfg"] == (n, 1, False)
