"""Mid-stream reconfigure segments, decode_all(fetch=False) and stats on
the port's BatchedStreamDecoder, against the JAX package's batched decoder
on the same bytes.

A non-redundant Sequence Header after the first starts a segment; the
decoder chains a follow-on decoder over the rest and drops a non-final
segment's last delay_size samples (the reference re-inits the limiter
without flushing its delay line). The cases are tests/
test_reconfigure_batched.py's, held to the JAX batched decoder instead of
the serial player (which that test holds bit-exact), plus a codec change
built from the libopus sample. Bounds: 0 LSB on PCM, as the JAX test
demands; 1 LSB where an Opus segment is decoded (the port's CELT synthesis
against the JAX one), 0 on the PCM segment after it. Segments are held to
parity with fetch=True only: the JAX decoder's segmented fetch=False cuts
other samples (ROADMAP.md §3), and the port's returns each segment's own
batches.
"""

import functools
import os

import numpy as np
import pytest

import vectors
from iamf_tpu.constants import ChannelLayout
from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as JaxDecoder
from iamf_tpu.obu import parser
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "iamf_tpu", "data", "sample_opus_714.iamf")


def _lsb(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _both(stream, **kw):
    """(port decoder on the CPU, its decode_all(), JAX decode_all())."""
    dec = BatchedStreamDecoder(stream, device="cpu", **kw)
    return dec, dec.decode_all(), JaxDecoder(stream, **kw).decode_all()


@functools.lru_cache(maxsize=None)
def _layout_change():
    a, _ = vectors.build_pcm_layout_stream(ChannelLayout.STEREO, n_frames=6,
                                           amp=0.6)
    b, _ = vectors.build_pcm_51_stream(n_frames=6, amp=0.8)
    return a + b


@pytest.mark.parametrize("limiter", [False, True])
def test_reconfigure_layout_change(limiter):
    """Stereo PCM, then 5.1 PCM (new codec config, element and mix
    presentation)."""
    dec, got, want = _both(_layout_change(), sound_system=1, batch_frames=4,
                           limiter=limiter)
    assert dec._next_data is not None
    assert _lsb(got, want) == 0


def test_reconfigure_three_segments():
    """Two reconfigure points: the chain recurses, and each decoder's stats
    hold its own follow-on's, as the JAX decoder's do."""
    a, _ = vectors.build_pcm_layout_stream(ChannelLayout.STEREO, n_frames=4,
                                           amp=0.5)
    b, _ = vectors.build_pcm_51_stream(n_frames=4, amp=0.7)
    c, _ = vectors.build_pcm_layout_stream(ChannelLayout.STEREO, n_frames=4,
                                           amp=0.9)
    dec = BatchedStreamDecoder(a + b + c, sound_system=1, batch_frames=4,
                               device="cpu")
    jd = JaxDecoder(a + b + c, sound_system=1, batch_frames=4)
    assert _lsb(dec.decode_all(), jd.decode_all()) == 0
    assert dec.stats == jd.stats
    (seg,) = dec.stats["segments"]
    assert len(seg["segments"]) == 1
    assert dec.stats["elements"] == [{"element_id": 1,
                                      "path": "raw_device"}]


def test_redundant_seq_header_does_not_segment():
    """A redundant mid-stream Sequence Header is skipped (parse_OBUs :2918
    checks !obu.redundant)."""
    a, _ = vectors.build_pcm_51_stream(n_frames=6, amp=0.8)
    obu = parser.split_obu(a, 0)
    assert obu.type == 31
    hdr = bytearray(a[:obu.size])
    hdr[0] |= 0x04  # the redundant bit
    recs = parser.split_records(a)
    cut = int(recs[np.flatnonzero(recs[:, 7] >= 0)[3], 2])
    stream = a[:cut] + bytes(hdr) + a[cut:]
    dec, got, want = _both(stream, sound_system=1, batch_frames=4)
    assert dec._next_data is None and "segments" not in dec.stats
    plain = BatchedStreamDecoder(a, sound_system=1, batch_frames=4,
                                 device="cpu").decode_all()
    assert _lsb(got, want) == 0
    assert _lsb(got, plain) == 0


def test_reconfigure_codec_change():
    """The libopus sample (Opus 7.1.4, head trim, limiter), then 5.1 PCM:
    the codec config changes mid-stream. Opus segment within 1 LSB, the
    PCM segment after the boundary 0."""
    a = open(SAMPLE, "rb").read()
    b, _ = vectors.build_pcm_51_stream(n_frames=6, amp=0.8)
    dec, got, want = _both(a + b, sound_system=9, batch_frames=8)
    assert _lsb(got, want) <= 1
    n_b = 6 * 960
    assert _lsb(got[-n_b:], want[-n_b:]) == 0
    jd = JaxDecoder(a + b, sound_system=9, batch_frames=8)
    jd.decode_all()
    assert dec.stats == jd.stats
    assert dec.stats["elements"][0]["path"] == "opus_device_celt"
    assert dec.stats["segments"][0]["elements"][0]["path"] == "raw_device"


@pytest.mark.parametrize("name", ["pcm714_head_trim", "pcm51_no_limiter",
                                  "opus_sample"])
def test_fetch_false_matches_fetch_true(name):
    """fetch=False keeps the batches on the device, as the pipeline emits
    them: the kept calls' rows, whose look-ahead head fetch=True drops. An
    unsegmented stream's fetch=True PCM is those rows from the limiter's
    delay on (or from the lead without a limiter)."""
    limiter = name != "pcm51_no_limiter"
    if name == "opus_sample":
        stream = open(SAMPLE, "rb").read()
    elif name == "pcm714_head_trim":
        stream = vectors.build_pcm_layout_stream(ChannelLayout.L714,
                                                 n_frames=11, amp=0.5)[0]
    else:
        stream = vectors.build_pcm_51_stream(n_frames=9, amp=0.9)[0]
    kw = dict(sound_system=9, batch_frames=4, limiter=limiter)
    dec = BatchedStreamDecoder(stream, device="cpu", **kw)
    batches = dec.decode_all(fetch=False)
    # a decoder decodes once: the host codecs keep their state
    full = BatchedStreamDecoder(stream, device="cpu", **kw).decode_all()
    B, T = dec.batch_frames, dec.frame_size
    assert len(batches) == -(-dec.n_frames // B)
    assert all(b.shape == (B * T, full.shape[1]) for b in batches)
    rows = np.concatenate([b.numpy() for b in batches])
    skip = dec.cfg.limiter.delay_size if limiter else dec.lead
    m = min(len(rows) - skip, len(full))
    assert m > len(full) - B * T
    assert np.array_equal(rows[skip:skip + m], full[:m])
    want = JaxDecoder(stream, **kw).decode_all(fetch=False)
    assert len(want) == len(batches)
    assert max(_lsb(g, w) for g, w in zip(batches, want)) <= (
        1 if name == "opus_sample" else 0)


def test_fetch_false_segments():
    """A reconfigured stream's fetch=False is each segment's own batch
    list, one after the other (untrimmed); a resampled stream refuses
    fetch=False."""
    stream = _layout_change()
    got = BatchedStreamDecoder(stream, sound_system=1, batch_frames=4,
                               device="cpu").decode_all(fetch=False)
    first = BatchedStreamDecoder(stream, sound_system=1, batch_frames=4,
                                 device="cpu")
    second = BatchedStreamDecoder(first._next_data, sound_system=1,
                                  batch_frames=4, device="cpu")
    want = first._decode_segment(False) + second._decode_segment(False)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w.numpy())
    r441 = vectors.build_pcm_51_stream(n_frames=3, rate=44100)[0]
    with pytest.raises(ValueError, match="needs fetch=True"):
        BatchedStreamDecoder(r441, sound_system=1, batch_frames=4,
                             device="cpu").decode_all(fetch=False)
