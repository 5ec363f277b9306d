"""The port's device Opus stream (codecs/opus/decoder.DeviceOpusStream) on
the CPU against the JAX package's TPUOpusStream and the port's host float
decode, and the Opus threading switches of the port's
decode_spectrum_batch (IAMF_OPUS_SERIAL, IAMF_OPUS_THREADS).

Content: the Opus sample (7 substreams, 12 lanes, 16 temporal units of 960
samples) and its re-TOCed variants (tests/opus_modes.py), fed to a stream
in blocks of units. Bounds: on the sample <= 1 s16 LSB against both (the
bar of the JAX package's libopus-oracle tests; the host decode is float,
the stream's output s16-granular); on the variants the loud bar of
opus_modes.assert_lsb. The JAX stream runs a hybrid export on new threads,
as the port does (tests/test_torch_opus_modes.jax_decoder).
"""

import functools
import os
import threading

import numpy as np
import pytest
import torch

from iamf_tpu.codecs.opus.decoder import TPUOpusStream
from iamf_tpu_torch.codecs.opus import decoder as popus
from iamf_tpu_torch.codecs.opus.decoder import (DeviceOpusStream,
                                                FreshThreads, OpusDecoder,
                                                decode_spectrum_batch)
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from opus_modes import EXPECT, assert_lsb, sample, stream

SWITCHES = ("IAMF_OPUS_SERIAL", "IAMF_OPUS_THREADS")


@functools.lru_cache(maxsize=None)
def content(name: str):
    """(codec arguments, units, opus_cfg) of the sample or a variant: its
    element's (decoder_conf, streams, coupled_streams), and per temporal
    unit the list of its substreams' packets."""
    data = sample() if name == "sample" else stream(name)
    dec = BatchedStreamDecoder(data, sound_system=9, batch_frames=8,
                               device="cpu")
    e = dec.elems[0]
    pkts = [dec.frames_per_substream[s] for s in e.substream_ids]
    units = [[p[u] for p in pkts] for u in range(len(pkts[0]))]
    c = e.codec
    return (c.decoder_conf, c.streams, c.coupled_streams), units, e.opus_cfg


def _on_new_thread(fn, *a, **kw):
    return FreshThreads().map(lambda _: fn(*a, **kw), [0])[0]


def jax_stream(conf, hybrid: bool) -> TPUOpusStream:
    s = TPUOpusStream(*conf, 960)
    if hybrid:
        s.dec._pool = FreshThreads()
        s.dec.decode_spectrum_batch = functools.partial(
            _on_new_thread, s.dec.decode_spectrum_batch)
    return s


def run(s, calls) -> np.ndarray:
    """calls: (units, (n, k, hybrid)) per decode_frames call -> the lanes'
    timelines [L, T]."""
    outs = [s.decode_frames(u, n=n, k=k, hybrid=hybrid)
            for u, (n, k, hybrid) in calls]
    return np.concatenate([o.transpose(1, 0, 2).reshape(o.shape[1], -1)
                           for o in outs], axis=1)


def blocks(units, split, cfg):
    assert sum(split) == len(units)
    ends = np.cumsum([0] + list(split))
    return [(units[a:b], cfg) for a, b in zip(ends[:-1], ends[1:])]


def s16(pcm: np.ndarray) -> np.ndarray:
    return np.round(pcm * 32768.0).astype(np.int32)


@functools.lru_cache(maxsize=None)
def host_pcm() -> np.ndarray:
    conf, units, _ = content("sample")
    host = OpusDecoder(*conf, 960)
    return np.concatenate([host.decode(u) for u in units], axis=1)


@pytest.mark.parametrize("split", [[1, 1, 3, 11], [16], [1] * 16],
                         ids=["1-1-3-11", "16", "1x16"])
def test_sample_matches_jax_and_host(split):
    """Calls of one unit feed K1 the previous call's tail and the comb a
    history longer than the call (B·n < HIST)."""
    conf, units, cfg = content("sample")
    assert cfg == (960, 1, False)
    calls = blocks(units, split, cfg)
    got = run(DeviceOpusStream(*conf, 960, device="cpu"), calls)
    want = run(jax_stream(conf, False), calls)
    assert got.shape == want.shape == (12, 16 * 960)
    assert got.dtype == want.dtype == np.float32
    assert_lsb(s16(got), s16(want))
    d = np.abs(got - host_pcm()) * 32768.0
    assert d.max() <= 1 + 1e-3, f"{d.max()} LSB from the host decode"


@pytest.mark.parametrize("split", [[16], [1, 15]], ids=["16", "1-15"])
@pytest.mark.parametrize("name", ["celt480x2", "celt120x8", "hybrid480x2"])
def test_variants_match_jax(name, split):
    conf, units, cfg = content(name)
    assert cfg == EXPECT[name][1]
    calls = blocks(units, split, cfg)
    got = run(DeviceOpusStream(*conf, 960, device="cpu"), calls)
    want = run(jax_stream(conf, cfg[2]), calls)
    assert got.shape == (12, 16 * 960)
    assert_lsb(s16(got), s16(want), loud=True)


def test_frame_size_changes_between_calls():
    """One stream fed the sample's first 8 units (960), then celt480x2's
    next 4 (480 x 2) and celt120x8's last 4 (120 x 8): the constants are
    per frame size, the carry runs across."""
    conf, units, _ = content("sample")
    calls = [(units[:8], (960, 1, False))]
    for name, (a, b) in (("celt480x2", (8, 12)), ("celt120x8", (12, 16))):
        _, v_units, cfg = content(name)
        calls.append((v_units[a:b], cfg))
    got = run(DeviceOpusStream(*conf, 960, device="cpu"), calls)
    want = run(jax_stream(conf, False), calls)
    assert got.shape == (12, 16 * 960)
    assert_lsb(s16(got), s16(want), loud=True)


def test_empty_call_keeps_the_carry():
    conf, units, _ = content("sample")
    s = DeviceOpusStream(*conf, 960, device="cpu")
    s.decode_frames(units[:2])
    before = [t.clone() for t in s.carry]
    assert all(t.any() for t in before)
    for n in (960, 480):
        out = s.decode_frames([], n=n)
        assert out.shape == (0, 12, n) and out.dtype == np.float32
    assert all(torch.equal(a, b) for a, b in zip(before, s.carry))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_default_device_without_a_card_raises():
    conf, _, _ = content("sample")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceOpusStream(*conf, 960)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceOpusStream(*conf, 960, device="cuda")


# --- IAMF_OPUS_SERIAL / IAMF_OPUS_THREADS -----------------------------------

class Recorder:
    """The native library with its spectrum export wrapped: each call's
    thread, and the most calls in flight at once."""

    def __init__(self, lib):
        self.lib = lib
        self.idents = []
        self.active = 0
        self.most = 0
        self.lock = threading.Lock()

    def iamf_opus_decode_spectrum_batch3(self, *args):
        with self.lock:
            self.idents.append(threading.get_ident())
            self.active += 1
            self.most = max(self.most, self.active)
        try:
            return self.lib.iamf_opus_decode_spectrum_batch3(*args)
        finally:
            with self.lock:
                self.active -= 1

    def __getattr__(self, name):
        return getattr(self.lib, name)


def export(name, monkeypatch, env: dict):
    """Two blocks of 8 units through decode_spectrum_batch on a new codec
    under exactly the switches in env: (codec, Recorder, outputs)."""
    for key in SWITCHES:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    rec = Recorder(popus._load_native())
    monkeypatch.setattr(popus, "_load_native", lambda: rec)
    conf, units, (n, k, hybrid) = content(name)
    codec = OpusDecoder(*conf, 960)
    outs = [decode_spectrum_batch(codec, units[a:a + 8], n=n, k=k,
                                  hybrid=hybrid) for a in (0, 8)]
    return codec, rec, outs


@pytest.mark.parametrize("env", [{"IAMF_OPUS_SERIAL": "1"},
                                 {"IAMF_OPUS_THREADS": "1"},
                                 {"IAMF_OPUS_THREADS": "3"}],
                         ids=["serial", "threads1", "threads3"])
@pytest.mark.parametrize("name", ["sample", "hybrid960"])
def test_switches_keep_the_output(name, env, monkeypatch):
    """Bit for bit the default's buffers and parameters, over two
    consecutive blocks (the codec states chain)."""
    _, _, want = export(name, monkeypatch, {})
    _, _, got = export(name, monkeypatch, env)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            assert np.array_equal(g[key], w[key]), key


@pytest.mark.parametrize("name", ["sample", "hybrid960"])
def test_serial_switch_runs_one_substream_at_a_time(name, monkeypatch):
    """The sample's substreams on the calling thread; a hybrid export's
    each on a new thread, joined before the next starts. Without the
    switch, neither runs on the calling thread."""
    main = threading.get_ident()
    codec, rec, _ = export(name, monkeypatch, {"IAMF_OPUS_SERIAL": "1"})
    assert len(rec.idents) == 2 * 7 and rec.most == 1
    assert codec._pool is None
    if name == "sample":
        assert set(rec.idents) == {main}
    else:
        assert main not in rec.idents
    codec, rec, _ = export(name, monkeypatch, {})
    assert len(rec.idents) == 2 * 7 and main not in rec.idents
    assert (codec._pool is None) == (name == "hybrid960")


def test_threads_switch_sizes_the_shared_pool(monkeypatch):
    """IAMF_OPUS_THREADS=n gives the codec a pool of n threads, which
    decode_batch and decode_spectrum_batch share; unset, one a substream
    up to the host's cores."""
    codec, rec, _ = export("sample", monkeypatch, {"IAMF_OPUS_THREADS": "1"})
    assert codec._pool._max_workers == 1 and rec.most == 1
    assert len(set(rec.idents)) == 1
    conf, units, _ = content("sample")
    monkeypatch.setenv("IAMF_OPUS_THREADS", "2")
    dec = OpusDecoder(*conf, 960)
    per_substream = [[u[i] for u in units[:2]] for i in range(7)]
    assert dec.decode_batch(per_substream, 960).shape == (2, 12, 960)
    pool = dec._pool
    assert pool._max_workers == 2
    decode_spectrum_batch(dec, units[2:4])
    assert dec._pool is pool
    codec, _, _ = export("sample", monkeypatch, {})
    assert codec._pool._max_workers == min(7, os.cpu_count() or 2)
