"""The frame-serial Opus decode on the codec's substream pool
(codecs/opus/decoder.OpusDecoder.decode) on the CPU: bit for bit the same
decode under IAMF_OPUS_SERIAL on the sample, on every re-TOCed variant
(tests/opus_modes.py) and on lost packets, and the counters
``opus.serial_units_pooled`` / ``opus.serial_units_caller`` saying which
units went to the pool.

Each decode runs on a new thread (FreshThreads), so a native hybrid decode
starts from zeroed per-thread scratch on both sides (ROADMAP.md §1): the
comparison does not rest on what the test process decoded before.
"""

import numpy as np
import pytest

from iamf_tpu_torch import api as papi
from iamf_tpu_torch.codecs.opus.decoder import FreshThreads, OpusDecoder
from iamf_tpu_torch.utils import trace
from opus_modes import VARIANTS, sample, stream
from test_torch_api import serial_decode
from test_torch_opus_stream import SWITCHES, content

# unit -> the substreams whose packets are lost; units 0-3 go to the pool
LOST = {4: (1, 5), 6: tuple(range(7)), 10: (0,)}


@pytest.fixture(autouse=True)
def fresh_recorder():
    was = trace._forced
    trace.enable(True)
    trace.reset()
    yield
    trace.enable(was)
    trace.reset()


def _plc_decode() -> np.ndarray:
    """The sample's units through one codec, with LOST's packets as None
    -> [channels, samples]."""
    conf, units, _ = content("sample")
    dec = OpusDecoder(*conf, 960)
    return np.concatenate(
        [dec.decode([None if i in LOST.get(u, ()) else p
                     for i, p in enumerate(pkts)])
         for u, pkts in enumerate(units)], axis=1)


def decode(name: str, monkeypatch, env: dict) -> np.ndarray:
    """The serial decode of "sample", a variant or "plc" (the codec alone)
    on a new thread, under exactly the switches in env."""
    for key in SWITCHES:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if name == "plc":
        run = _plc_decode
    else:
        data = sample() if name == "sample" else stream(name)

        def run():
            return serial_decode(papi.IAMFDecoder(device="cpu"), data, ss=9)
    return FreshThreads().map(lambda _: run(), [0])[0]


def _counts() -> tuple:
    c = trace.counters()
    return (c.get("opus.serial_units_pooled", 0),
            c.get("opus.serial_units_caller", 0))


@pytest.mark.parametrize("name", ["sample", *VARIANTS, "plc"])
def test_pool_keeps_the_output(name, monkeypatch):
    got = decode(name, monkeypatch, {})
    want = decode(name, monkeypatch, {"IAMF_OPUS_SERIAL": "1"})
    assert got.dtype == want.dtype and got.shape == want.shape
    assert want.size and np.any(want)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name,env,pooled", [
    ("sample", {}, 16),
    ("celt120x8", {}, 16),
    ("hybrid960", {}, 0),
    ("silk960", {}, 0),
    ("mixed", {}, 0),
    ("plc", {}, 4),
    ("sample", {"IAMF_OPUS_THREADS": "1"}, 0),
    ("sample", {"IAMF_OPUS_SERIAL": "1"}, 0),
], ids=["sample", "celt120x8", "hybrid960", "silk960", "mixed", "plc",
        "threads1", "serial"])
def test_counters_name_the_pooled_units(name, env, pooled, monkeypatch):
    """Every unit of the sample's 16 is counted once: CELT-only ones on
    the pool; hybrid, SILK and everything from the first lost packet on
    (unit 4 of "plc") on the calling thread, as under the switches."""
    decode(name, monkeypatch, env)
    assert _counts() == (pooled, 16 - pooled)
