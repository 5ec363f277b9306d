"""The general Opus operating points through the port's other decoders on
the CPU: MultiStreamServer, PipelinedStreamDecoder, ShardedStreamDecoder
and the frame-serial IAMFDecoder, against their JAX counterparts and the
port's own batched decode (content and bounds: tests/test_torch_opus_modes.py).
"""

import jax
import numpy as np
import pytest
import torch

from iamf_tpu import api as japi
from iamf_tpu.parallel import sharded_decoder as jax_sharded
from iamf_tpu.parallel.pp_decoder import PipelinedStreamDecoder as JaxPP
from iamf_tpu_torch import api as papi
from iamf_tpu_torch.codecs.opus.decoder import FreshThreads
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from iamf_tpu_torch.core.serving import MultiStreamServer
from iamf_tpu_torch.parallel.pp_decoder import PipelinedStreamDecoder
from iamf_tpu_torch.parallel.sharded_decoder import ShardedStreamDecoder
from iamf_tpu_torch.tools.streams import split_into_units
from test_torch_api import serial_decode
from opus_modes import EXPECT, assert_lsb, sample, stream


def on_new_thread(fn, *a, **kw):
    return FreshThreads().map(lambda _: fn(*a, **kw), [0])[0]


def batched(name, bf):
    return BatchedStreamDecoder(stream(name), sound_system=9,
                                batch_frames=bf, device="cpu").decode_all()


def test_server_two_celt480x2_streams():
    """Two celt480x2 streams of different lengths share one bucket (kind
    "opus:480:2:0"), and each equals its own decode bit for bit."""
    full = stream("celt480x2")
    desc, units = split_into_units(full)
    fleet = [full, desc + b"".join(units[:10])]
    srv = MultiStreamServer(fleet, device="cpu", sound_system=9,
                            batch_frames=4)
    assert srv.n_buckets == 1
    assert srv.decs[1].stats["elements"][0]["opus_cfg"] == (480, 2, False)
    outs = srv.decode_all()
    for s, data in enumerate(fleet):
        own = BatchedStreamDecoder(data, device="cpu", sound_system=9,
                                   batch_frames=4).decode_all(fetch=False)
        assert len(outs[s]) == len(own) > 0
        for got, mine in zip(outs[s], own):
            assert torch.equal(got, mine)


@pytest.mark.parametrize("name", ["celt480x2", "silk960"])
def test_pipelined_matches_batched_and_jax(name):
    got = PipelinedStreamDecoder(stream(name), devices=["cpu", "cpu"],
                                 sound_system=9, batch_frames=4).decode_all()
    want = batched(name, 4)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    jax_want = JaxPP(stream(name), devices=jax.devices()[:2], sound_system=9,
                     batch_frames=4).decode_all()
    assert_lsb(got, np.asarray(jax_want), loud=EXPECT[name][1] is not None)


@pytest.mark.parametrize("name", ["celt480x2", "silk960"])
def test_sharded_matches_jax(name):
    """Opus other than CELT-960 one frame a unit decodes on the host and
    shards as raw frames, with no preroll, as the JAX sharded decoder."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual JAX devices (tests/conftest.py)")
    jdec = jax_sharded.ShardedStreamDecoder(stream(name), sound_system=9,
                                            n_devices=4)
    want = np.asarray(jdec.decode_all())
    dec = ShardedStreamDecoder(stream(name), sound_system=9, n_devices=4,
                               device="cpu")
    assert dec.prerolls == jdec.prerolls == (0,)
    got = dec.decode_all()
    assert_lsb(got, want)
    if name == "silk960":  # host-decoded in every decoder
        assert_lsb(got, batched(name, 8))


@pytest.mark.parametrize("name", ["silk960", "celt480x2", "sample",
                                  "hybrid960"])
def test_serial_matches_jax(name):
    """The port's serial Opus decode runs CELT-only units on the codec's
    substream pool, the JAX one on the calling thread: the same native
    decode, so the same PCM (0 LSB measured). Each runs on a new thread:
    a native hybrid decode reads its thread's history (ROADMAP.md §1)."""
    data = sample() if name == "sample" else stream(name)
    want = on_new_thread(serial_decode, japi.IAMFDecoder(), data, ss=9)
    got = on_new_thread(serial_decode, papi.IAMFDecoder(device="cpu"), data,
                        ss=9)
    assert len(want) > 0
    assert_lsb(got, want)
