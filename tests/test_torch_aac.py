"""The port's AAC-LC path on the CPU against the JAX package: K7's plain
twin (codecs/aac/synth.py) against iamf_tpu.codecs.aac.tpu_synth, the
hand-written content (tools/streams.py) through both packages' AACDecoder,
and whole AAC and FLAC decodes through both BatchedStreamDecoders.

Bounds: PCM within 1 s16 LSB (the repo's batched-vs-serial bar); before
rounding, the windowed frames within 2^-17 of their largest magnitude (the
same fp32 products summed in another order: ~2e-7 relative measured);
K7's numpy model (tests/k7_model.py, its FFTs in float64) within 1e-3
at s16 scale of the twin's frames.
"""

import collections

import numpy as np
import pytest
import torch

import k7_model
from iamf_tpu.codecs.aac import decoder as jaac
from iamf_tpu.codecs.aac import tpu_synth
from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as JaxDecoder
from iamf_tpu_torch.codecs.aac import decoder as paac
from iamf_tpu_torch.codecs.aac import synth
from iamf_tpu_torch.constants import ChannelLayout
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from iamf_tpu_torch.tools import streams

CASES = [(q, h, p) for q in range(4) for h in range(2) for p in range(2)]


def _spectra(rng, B, L):
    """Random spectra at s16 scale (PCM peaks of a few thousand)."""
    return (rng.randn(B, L, synth.FRAME) * 3000.0).astype(np.float32)


def _jax(spec, meta, carry):
    p = tpu_synth.SynthParams(spec=spec, win_seq=meta[..., 0],
                              shape=meta[..., 1], prev_shape=meta[..., 2])
    pcm, carry = tpu_synth.synthesize(p, carry)
    return (np.asarray(pcm), np.asarray(carry),
            np.asarray(tpu_synth._windowed_frames(p)))


@pytest.mark.parametrize("case", CASES)
def test_k7_twin_matches_jax(case):
    """Every (window_sequence, window_shape, previous shape), B = 3, L = 2,
    two consecutive calls with the carry chained from a live one."""
    B, L = 3, 2
    rng = np.random.RandomState(sum(c << (2 * i) for i, c in
                                    enumerate(case)))
    tabs = synth.Tables()
    meta = np.broadcast_to(np.array(case, np.int32), (B, L, 3)).copy()
    carry_j = carry_p = (rng.randn(L, synth.FRAME) * 3000).astype(np.float32)
    carry_p = torch.from_numpy(carry_p)
    for _ in range(2):
        spec = _spectra(rng, B, L)
        want, carry_j, frames_j = _jax(spec, meta, carry_j)
        got, carry_p = synth.synthesize(tabs, torch.from_numpy(spec),
                                        torch.from_numpy(meta), carry_p)
        frames_p = synth.windowed_frames(tabs, torch.from_numpy(spec),
                                         torch.from_numpy(meta)).numpy()
        assert got.shape == (B, L, synth.FRAME)
        assert np.abs(got.numpy() - want).max() * 32768 <= 1
        tol = np.abs(frames_j).max() * 2.0 ** -17
        assert np.abs(frames_p - frames_j).max() <= tol
        assert np.abs(carry_p.numpy() - carry_j).max() <= tol


def test_k7_model_matches_twin():
    """K7's plan (tests/k7_model.py: FFT IMDCTs with the kernel's index
    maps, each bin's samples unfolded to the positions a lane owns, the
    short rows' windows and overlaps indexed as the kernel indexes them)
    against the twin, every case in one batch of 8 frames x 6 lanes, with
    a live carry."""
    B, L = 8, 6
    rng = np.random.RandomState(7)
    meta = np.array([CASES[(3 * r) % 16] for r in range(B * L)],
                    np.int32).reshape(B, L, 3)
    spec = _spectra(rng, B, L)
    carry = (rng.randn(L, synth.FRAME) * 3000).astype(np.float32)
    tabs = synth.Tables()
    frames = synth.windowed_frames(tabs, torch.from_numpy(spec),
                                   torch.from_numpy(meta)).numpy()
    model = k7_model.windowed_frames(spec.reshape(-1, synth.FRAME),
                                     meta.reshape(-1, 3))
    assert np.abs(model - frames.reshape(B * L, -1)).max() < 1e-3
    pcm, c = synth.synthesize(tabs, torch.from_numpy(spec),
                              torch.from_numpy(meta), torch.from_numpy(carry))
    pcm_m, c_m = k7_model.synthesize(spec, meta, carry)
    assert np.abs(pcm_m - pcm.numpy()).max() * 32768 <= 1
    assert np.abs(c_m - c.numpy()).max() < 1e-3


@pytest.mark.parametrize("n_out,seed", [(2048, 1), (2048, 2), (256, 1),
                                        (256, 2)])
def test_k7_fft_imdct_matches_basis(n_out, seed):
    """K7's IMDCT (tests/k7_model.py: an n/4-point inverse FFT in radix-8
    passes with the stored float32 twiddles of synth.k7_twiddles, each
    bin's two samples unfolded to both halves) against the dense float64
    product with the reference's basis, long (2048) and short (256), within
    2^-20 of the largest output (the float32 twiddles: ~5e-8 measured)."""
    b = synth.tables()["b_long" if n_out == 2048 else "b_short"]
    x = (np.random.RandomState(seed).randn(3, n_out // 2) * 3000).astype(
        np.float32)
    want = x.astype(np.float64) @ b.astype(np.float64)
    first, second = k7_model.halves(x, n_out)
    got = np.concatenate([first, second], axis=-1)
    assert np.abs(got - want).max() <= np.abs(want).max() * 2.0 ** -20


@pytest.mark.parametrize("B,run,calls", [(8, 3, 1), (1, 1, 3)])
def test_k7_model_runs_match_twin(B, run, calls):
    """K7's cut of a batch into runs that each recompute the frame before
    them: B = 8 in runs of 3 (the last run short), and B = 1 over three
    calls with the carry chained; every case of a row, L = 5."""
    L = 5
    rng = np.random.RandomState(B * 10 + run)
    tabs = synth.Tables()
    carry_m = (rng.randn(L, synth.FRAME) * 3000).astype(np.float32)
    carry_p = torch.from_numpy(carry_m)
    for _ in range(calls):
        meta = np.array([CASES[i] for i in rng.randint(16, size=B * L)],
                        np.int32).reshape(B, L, 3)
        spec = _spectra(rng, B, L)
        pcm_m, carry_m = k7_model.synthesize(spec, meta, carry_m, run)
        pcm, carry_p = synth.synthesize(tabs, torch.from_numpy(spec),
                                        torch.from_numpy(meta), carry_p)
        assert np.abs(pcm_m - pcm.numpy()).max() * 32768 <= 1
        assert np.abs(carry_m - carry_p.numpy()).max() < 1e-3


@pytest.mark.parametrize("B,L", [(128, 12), (8, 12), (1, 1), (3000, 16)])
def test_k7_run_fills_card(B, L):
    """k7_run: the fewest frames a warp that keep the grid within the
    warps the card holds (an H100 SXM's 1056, and smaller cards')."""
    for fill in (1056, 264, 7):
        run = synth.k7_run(B, L, fill)
        warps = L * -(-B // run)
        assert run >= 1 and (warps <= fill or run >= B)
        assert run == 1 or L * -(-B // (run - 1)) > fill


@pytest.mark.parametrize("seq", [streams.ONLY_LONG, streams.LONG_START,
                                 streams.EIGHT_SHORT, streams.LONG_STOP])
def test_window_sequences_decode_match(seq):
    """Raw data blocks of each window sequence (both shapes, a CPE and an
    SCE) through both packages' AACDecoder: the PCM frame by frame, and
    the batched spectra with the sequence and shapes as written."""
    tab = streams.aac_tables()
    rng = np.random.RandomState(20 + seq)
    shapes = [0, 1, 1, 0]
    frames = [[streams.aac_block(rng, tab, 2, seq, sh, max_sfb=49),
               streams.aac_block(rng, tab, 1, seq, sh, max_sfb=49)]
              for sh in shapes]
    conf = streams.aac_decoder_config(streams.AAC_ASC)
    dj, dp = (m.AACDecoder(conf, 2, 1, 1024) for m in (jaac, paac))
    for f in frames:
        want = dj.decode(f)
        assert np.array_equal(dp.decode(f), want)
        assert 0.01 < np.abs(want).max() < 1.0
    dj, dp = (m.AACDecoder(conf, 2, 1, 1024) for m in (jaac, paac))
    want = dj.decode_spectrum_batch(frames)
    got = dp.decode_spectrum_batch(frames)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert (got["win_seq"] == seq).all()
    assert (got["shape"] == np.array(shapes)[:, None]).all()
    assert (got["prev_shape"] == np.array([0] + shapes[:-1])[:, None]).all()


def test_aac_stream_content():
    """The builder's window schedules are legal (LONG_START, EIGHT_SHORT
    x 1-3, LONG_STOP between ONLY_LONG runs), a 30 s 7.1.4 stream covers
    every (sequence, shape, previous shape), and its PCM sits near -12
    dBFS."""
    stream, packets = streams.build_aac_layout_stream(
        ChannelLayout.L714, n_frames=1407, seed=5)
    conf = streams.aac_decoder_config(streams.AAC_ASC)
    dec = paac.AACDecoder(conf, len(packets), 5, 1024)
    spec = dec.decode_spectrum_batch(
        [[p[f] for p in packets] for f in range(1407)])
    seq = spec["win_seq"]
    nxt = {streams.ONLY_LONG: {streams.ONLY_LONG, streams.LONG_START},
           streams.LONG_START: {streams.EIGHT_SHORT},
           streams.EIGHT_SHORT: {streams.EIGHT_SHORT, streams.LONG_STOP},
           streams.LONG_STOP: {streams.ONLY_LONG}}
    for a, b in zip(seq[:-1].ravel(), seq[1:].ravel()):
        assert b in nxt[a]
    seen = collections.Counter(zip(seq.ravel(), spec["shape"].ravel(),
                                   spec["prev_shape"].ravel()))
    assert set(seen) == set(CASES)
    pcm = np.concatenate([dec.decode([p[f] for p in packets])
                          for f in range(1000, 1012)], axis=1)
    assert 0.1 < np.abs(pcm).max() < 0.5


def _decode_both(stream, **kw):
    got = BatchedStreamDecoder(stream, device="cpu", **kw).decode_all()
    want = JaxDecoder(stream, **kw).decode_all()
    assert got.shape == want.shape and got.dtype == want.dtype
    return got, want


@pytest.mark.parametrize("name,layout,kw,gain,hrm", [
    ("7.1.4 -> J", ChannelLayout.L714, dict(sound_system=9), 0, 0),
    ("5.1 -> 5.1, limiter engaged", ChannelLayout.L510,
     dict(sound_system=1), 8, 0),
    ("5.1 binaural, HRTF convolution", ChannelLayout.L510,
     dict(binaural=True), 0, 1),
])
def test_aac_decode_matches_jax(name, layout, kw, gain, hrm):
    """A multichannel AAC stream with EIGHT_SHORT runs through both
    decoders on the CPU over 4 batches of 8 frames (the [L, 1024] carry
    crosses three batch edges), to loudspeakers and to two ears through
    the HRIR convolution (M2B)."""
    stream, _ = streams.build_aac_layout_stream(
        layout, n_frames=30, seed=3, gain_offset=gain, hrm=hrm)
    got, want = _decode_both(stream, batch_frames=8, **kw)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, f"{name}: {d.max()} LSB"
    peak = np.abs(want.astype(np.int32)).max()
    assert (peak > 28000) == bool(gain), f"{name}: peak {peak}"


def test_aac_other_frame_sizes_refused():
    """Only 1024-sample AAC-LC frames reach the device filterbank; an AAC
    element with another frame size is refused by name."""
    stream, _ = streams.build_aac_layout_stream(ChannelLayout.STEREO,
                                                n_frames=2)
    bad = stream.replace(b"mp4a\x80\x08", b"mp4a\xc0\x07")  # 1024 -> 960
    assert bad != stream
    with pytest.raises(NotImplementedError, match="1024-sample"):
        BatchedStreamDecoder(bad, sound_system=0, device="cpu")


@pytest.mark.parametrize("layout,ss", [(ChannelLayout.L510, 1),
                                       (ChannelLayout.STEREO, 0)])
def test_flac_decode_matches_jax(layout, ss):
    """An IAMF stream of hand-built FLAC VERBATIM frames through both
    decoders, over three batches."""
    stream, src = streams.build_flac_layout_stream(layout, n_frames=20)
    got, want = _decode_both(stream, sound_system=ss, batch_frames=8)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert np.abs(want).max() > 10000
