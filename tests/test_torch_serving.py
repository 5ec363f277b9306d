"""MultiStreamServer on the port: S streams through one stacked decode step
must give each stream's own BatchedStreamDecoder(...).decode_all(
fetch=False), bit for bit on the CPU, and stay within 1 LSB of the JAX
package's server on the same bytes (the repo's bar between the packages:
the CELT and AAC synthesis, the demix chains and the HRTF convolution
round differently in places).

The cases are tests/test_serving.py's seven: distinct PCM content, Opus
(the libopus sample and a cut of it, since no Opus can be encoded here),
scalable demix, binaural HRTF, AAC-LC (the port's hand-written content),
mixed lengths in one bucket, and a fleet of mixed codecs and layouts.
Then the bucket count, the refusals, and a bucket with no frame to
decode.
"""

import functools
import os

import numpy as np
import pytest
import torch

import vectors
from iamf_tpu.constants import ChannelLayout
from iamf_tpu.core.serving import MultiStreamServer as JaxServer
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder, _HostPlan
from iamf_tpu_torch.core.serving import MultiStreamServer
from iamf_tpu_torch.tools import streams as pstreams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "iamf_tpu", "data", "sample_opus_714.iamf")


@functools.lru_cache(maxsize=None)
def opus_sample(units: int | None = None) -> bytes:
    """The libopus sample, or its descriptors and first `units` temporal
    units."""
    data = open(SAMPLE, "rb").read()
    if units is None:
        return data
    desc, tus = pstreams.split_into_units(data)
    return desc + b"".join(tus[:units])


def _pcm714(n, i):
    return vectors.build_pcm_layout_stream(
        ChannelLayout.L714, n_frames=n, frame_size=960, amp=0.2 + 0.1 * i,
        seed=i)[0]


# name: (streams, decoder options, n_buckets)
CASES = {
    "pcm_distinct_content": (
        lambda: [vectors.build_pcm_layout_stream(
            ChannelLayout.L714, n_frames=7, frame_size=960,
            amp=0.2 * (s + 1), seed=s)[0] for s in range(3)],
        dict(sound_system=9, batch_frames=4), 1),
    "opus": (
        lambda: [opus_sample(), opus_sample(12)],
        dict(sound_system=9, batch_frames=4), 1),
    "scalable_demix": (
        lambda: [vectors.build_scalable_pcm_stream(
            n_frames=6, demix_modes=[f % 3 for f in range(6)], amp=a)[0]
            for a in (0.3, 0.4)],
        dict(sound_system=7, batch_frames=4), 1),
    "binaural_hrtf": (
        lambda: [vectors.build_pcm_layout_stream(
            ChannelLayout.L510, n_frames=6, frame_size=960,
            amp=0.2 + 0.1 * s, seed=s, hrm=1)[0] for s in range(2)],
        dict(binaural=True, batch_frames=4), 1),
    "aac": (
        lambda: [pstreams.build_aac_layout_stream(
            ChannelLayout.STEREO, n_frames=6, seed=s)[0] for s in (33, 34)],
        dict(sound_system=0, batch_frames=4), 1),
    "mixed_lengths": (
        lambda: [_pcm714(n, i) for i, n in enumerate([7, 13, 4])],
        dict(sound_system=9, batch_frames=4), 1),
    "mixed_codec_and_layout": (
        lambda: [_pcm714(7, 1), opus_sample(9),
                 vectors.build_pcm_layout_stream(
                     ChannelLayout.STEREO, n_frames=5, frame_size=960,
                     amp=0.5)[0]],
        dict(sound_system=9, batch_frames=4), 3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_server_matches_own_decode_and_jax(name):
    make, kw, n_buckets = CASES[name]
    fleet = make()
    srv = MultiStreamServer(fleet, device="cpu", **kw)
    jsrv = JaxServer(fleet, **kw)
    assert srv.n_buckets == jsrv.n_buckets == n_buckets
    outs = srv.decode_all()
    jouts = jsrv.decode_all()
    for s, stream in enumerate(fleet):
        own = BatchedStreamDecoder(stream, device="cpu",
                                   **kw).decode_all(fetch=False)
        assert len(outs[s]) == len(own) == len(jouts[s])
        for got, mine, jax_b in zip(outs[s], own, jouts[s]):
            assert got.device.type == "cpu"
            assert torch.equal(got, mine)
            jax_b = np.asarray(jax_b)
            assert got.shape == jax_b.shape
            d = np.abs(got.numpy().astype(np.int32) - jax_b.astype(np.int32))
            assert d.max() <= 1, (s, int(d.max()))


def test_refusals():
    """Streams not at 48 kHz and reconfigured streams are refused, as the
    JAX server refuses them."""
    ok = _pcm714(3, 0)
    r441 = vectors.build_pcm_51_stream(n_frames=3, rate=44100)[0]
    seg = ok + vectors.build_pcm_51_stream(n_frames=3)[0]
    for bad, what in ((r441, "rate-mismatch"), (seg, "reconfigure")):
        with pytest.raises(ValueError, match=what):
            MultiStreamServer([ok, bad], sound_system=9, batch_frames=4,
                              device="cpu")
        with pytest.raises(ValueError, match=what):
            JaxServer([ok, bad], sound_system=9, batch_frames=4)


def test_bucket_with_nothing_to_decode():
    """A bucket whose streams hold no frame: no call sees an input, and
    the flush input comes from the plans' shapes (the JAX server builds it
    from the first input it sees, iamf_tpu/core/serving.py:116-135), so
    the decode returns empty lists; the flush input a plan builds before
    any batch has its batches' shapes and dtypes."""
    desc, _ = pstreams.split_into_units(_pcm714(3, 0))
    srv = MultiStreamServer([desc, desc], sound_system=9, batch_frames=4,
                            device="cpu")
    assert srv.n_buckets == 1
    assert srv.decode_all() == [[], []]
    for stream in (_pcm714(3, 0), opus_sample(3),
                   pstreams.build_aac_layout_stream(ChannelLayout.STEREO,
                                                    n_frames=3)[0]):
        plan = _HostPlan(BatchedStreamDecoder(stream, sound_system=9,
                                              batch_frames=4, device="cpu"))
        try:
            flush = plan.flush_bufs()
            first = plan.next_bufs()
        finally:
            plan.close()
        for z, b in zip(flush, first):
            for zt, bt in zip(*((z, b) if isinstance(z, tuple)
                                else ((z,), (b,)))):
                assert zt.shape == bt.shape and zt.dtype == bt.dtype


def test_bucket_from_jax_fleet_state():
    """convert carries a JAX fleet's stacked state across (stacked=True,
    the jax.tree.map(_stack, ...) of its plans' carries and stream_params,
    iamf_tpu/core/serving.py:112-113): after one vmapped JAX step on a
    binaural fleet (an engaged limiter and live HRTF overlaps in the
    carry), the port's fused_decode from the converted state gives each
    stream the JAX step's next batch within 1 LSB, and carries the same
    limiter envelope on."""
    import jax
    import jax.numpy as jnp

    from iamf_tpu.core import serving as jserv
    from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as JaxDecoder
    from iamf_tpu.core.batch_decoder import _HostPlan as JaxPlan
    from iamf_tpu.core.batch_decoder import plan_kinds as jax_kinds
    from iamf_tpu_torch import convert
    from iamf_tpu_torch.core.batch_decoder import fused_decode

    fleet = [vectors.build_pcm_layout_stream(
        ChannelLayout.L510, n_frames=8, frame_size=960, amp=0.5 + 0.2 * s,
        seed=s, hrm=1)[0] for s in range(2)]
    decs = [JaxDecoder(s, binaural=True, batch_frames=4) for s in fleet]
    plans = [JaxPlan(d, rows=12) for d in decs]
    try:
        carry = jax.tree.map(jserv._stack, *[p.carry for p in plans])
        params = jax.tree.map(jserv._stack,
                              *[p.stream_params for p in plans])
        cfg, kinds = decs[0].cfg, jax_kinds(decs[0])
        batches = []  # two calls' inputs of the one element, [S, B, ...]
        for _ in range(2):
            batches.append([np.stack([p.next_bufs()[0] for p in plans])])
    finally:
        for p in plans:
            p.close()
    carry, _ = jserv._fused_decode_multi(
        cfg, kinds, carry, params, [jnp.asarray(b) for b in batches[0]])
    cfg_p = convert.pipeline_config(cfg)
    params_p = convert.stream_params(params, "cpu", cfg_p, stacked=True)
    carry_p = convert.plan_carry(carry, "cpu", stacked=True)
    assert carry_p["pipe"]["pos"] == 4
    assert carry_p["pipe"]["limiter"]["env"].shape == (2, 4)
    assert float(carry_p["pipe"]["limiter"]["env"][:, 3].max()) != -1.0
    carry_j, pcm_j = jserv._fused_decode_multi(
        cfg, kinds, carry, params, [jnp.asarray(b) for b in batches[1]])
    carry_p, pcm_p = fused_decode(cfg_p, kinds, {}, carry_p, params_p,
                                  [torch.from_numpy(b) for b in batches[1]])
    pcm_j = np.asarray(pcm_j)
    assert pcm_p.shape == pcm_j.shape == (2, 4 * 960, 2)
    assert np.abs(pcm_p.numpy().astype(np.int32)
                  - pcm_j.astype(np.int32)).max() <= 1
    env_j = np.stack([np.asarray(carry_j["pipe"]["limiter"][k]) for k in (
        "current_gain", "target_start_gain", "target_end_gain",
        "current_tc")], axis=-1)
    np.testing.assert_allclose(carry_p["pipe"]["limiter"]["env"].numpy(),
                               env_j, rtol=1e-5)
