"""The port's multi-device decoders against the JAX package's, on the CPU.

Each case decodes one stream through the JAX ShardedStreamDecoder (8
virtual devices, tests/conftest.py) and through the port's
(iamf_tpu_torch.parallel.sharded_decoder, device="cpu", the same mesh
shape): the port within 1 LSB of JAX, and within 1 LSB of its own
BatchedStreamDecoder(device="cpu"). The counterparts of
tests/test_sharded_decoder.py at its sizes; its Opus meshes encode with
libopus, which is absent, so theirs use the Opus sample
(iamf_tpu/data/sample_opus_714.iamf: 16 frames, 12 lanes, head_trim 312).
The 1 LSB: a CPU matmul rounds with its row count (K1's twin runs on
preroll + F frames a shard), and XLA:CPU's FMA in the JAX limiter
(ROADMAP.md §3). The pipelined decoder equals the port's batched decode
bit for bit (the same functions, split), and the JAX one within 1 LSB.
"""

import os

import jax
import numpy as np
import pytest
import torch

from iamf_tpu.parallel import sharded_decoder as jax_sharded
from iamf_tpu.parallel.pp_decoder import PipelinedStreamDecoder as JaxPP
from iamf_tpu_torch import convert
from iamf_tpu_torch.constants import ChannelLayout
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from iamf_tpu_torch.parallel.mesh import ShardMesh
from iamf_tpu_torch.parallel.pp_decoder import PipelinedStreamDecoder
from iamf_tpu_torch.parallel.sharded_decoder import ShardedStreamDecoder
from iamf_tpu_torch.tools import scaling_bench, streams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = open(os.path.join(ROOT, "iamf_tpu", "data", "sample_opus_714.iamf"),
              "rb").read()


def _lsb(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def loud_pcm(n_frames, frame_size, nch, boundary_frame):
    """Sine bed with a +4 dB burst over the given frame boundary (the
    _loud_pcm of tests/test_sharded_decoder.py), so the limiter's curve is
    live where its state crosses from one shard to the next."""
    total = n_frames * frame_size
    pcm = streams.sine_pcm(total, nch, 48000, amp=0.4, bits=16, seed=3)
    lo = (boundary_frame - 2) * frame_size
    hi = (boundary_frame + 2) * frame_size
    burst = streams.sine_pcm(hi - lo, nch, 48000, amp=1.45, bits=16, seed=4)
    pcm[lo:hi] = np.clip(burst, -32768, 32767)
    return pcm


def _loud(layout, n_frames, nch, boundary):
    return streams.build_pcm_layout_stream(
        layout, n_frames=n_frames,
        pcm_override=loud_pcm(n_frames, 960, nch, boundary))[0]


# name: (stream builder, sound system, mesh keywords, the limiter engages)
CASES = {
    "limiter_excursion_crosses_boundary": (
        lambda: _loud(ChannelLayout.L714, 40, 12, 20), 9,
        dict(n_devices=8), True),
    "dynamic_params": (
        lambda: streams.build_pcm_layout_stream(
            ChannelLayout.L714, n_frames=24, amp=0.5,
            demix_modes=[i % 3 for i in range(24)],
            mix_gain_segments=[
                {"animation": 1, "start": -256 * (i % 4),
                 "end": -256 * ((i + 1) % 4)} for i in range(24)])[0], 9,
        dict(n_devices=8), False),
    "uneven_last_shard": (
        lambda: streams.build_pcm_layout_stream(
            ChannelLayout.L512, n_frames=19, amp=0.6)[0], 2,
        dict(n_devices=8), False),
    "opus_sample_preroll": (lambda: SAMPLE, 9, dict(n_devices=8), False),
    "elements_two_element_pcm": (
        lambda: streams.build_two_element_stream(
            n_frames=16, gain2_q78=-(3 << 8))[0], 0,
        dict(n_devices=8, element_axis=2), False),
    "elements_opus_idle_row": (
        lambda: SAMPLE, 9, dict(n_devices=8, element_axis=2), False),
    "elements_limiter_excursion": (
        lambda: _loud(ChannelLayout.L510, 16, 6, 8), 1,
        dict(n_devices=8, element_axis=2), True),
    "substreams_opus_3_lanes": (
        lambda: SAMPLE, 9, dict(n_devices=8, substream_axis=4), False),
    "substreams_opus_lane_padding": (
        lambda: SAMPLE, 9, dict(n_devices=5, substream_axis=5), False),
    "substreams_pcm_lane_padding": (
        lambda: streams.build_pcm_51_stream(n_frames=8, amp=0.6)[0], 1,
        dict(n_devices=8, substream_axis=4), False),
    "substreams_pcm_limiter": (
        lambda: _loud(ChannelLayout.L714, 16, 12, 8), 9,
        dict(n_devices=8, substream_axis=2), True),
    "aac_4_shards": (
        lambda: streams.build_aac_layout_stream(
            ChannelLayout.L714, n_frames=24)[0], 9, dict(n_devices=4), False),
}


@pytest.fixture(scope="module", autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual JAX devices (tests/conftest.py)")


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_matches_jax_and_batched(name):
    build, ss, mesh_kw, engaged = CASES[name]
    stream = build()
    want = np.asarray(jax_sharded.ShardedStreamDecoder(
        stream, sound_system=ss, **mesh_kw).decode_all())
    dec = ShardedStreamDecoder(stream, sound_system=ss, device="cpu",
                               **mesh_kw)
    got = dec.decode_all()
    batched = BatchedStreamDecoder(stream, sound_system=ss, batch_frames=8,
                                   device="cpu").decode_all()
    assert _lsb(got, want) <= 1
    assert _lsb(got, batched) <= 1
    if engaged:  # the burst is past the limiter's -1 dB threshold
        assert np.abs(batched.astype(np.int64)).max() >= 28000
    jax_dec = jax_sharded.ShardedStreamDecoder(stream, sound_system=ss,
                                               **mesh_kw)
    for attr in ("n_shards", "n_eshards", "n_sshards", "prerolls", "preroll",
                 "roll_distance", "frames_per_shard", "n_frames"):
        assert getattr(dec, attr) == getattr(jax_dec, attr), attr


def test_mesh_shapes_and_preroll():
    """The meshes the cases above ask for, and the sample's preroll."""
    dec = ShardedStreamDecoder(SAMPLE, n_devices=8, sound_system=9,
                               element_axis=2, device="cpu")
    assert (dec.n_shards, dec.n_eshards, dec.n_sshards) == (4, 2, 1)
    assert dec.preroll == 1 and dec.prerolls == (1,)
    dec = ShardedStreamDecoder(SAMPLE, n_devices=8, sound_system=9,
                               substream_axis=4, device="cpu")
    assert (dec.n_shards, dec.n_sshards) == (2, 4)
    assert dec.mesh.shards == [(0, torch.device("cpu"))] * 8


def test_explicit_mesh_of_named_devices():
    """A mesh the caller builds over a device list that names one device
    several times (as a list of cards may): the same decode as the
    default mesh of that shape."""
    mesh = ShardMesh.build(4, device="cpu", devices=["cpu", "cpu"])
    assert mesh.shape == {"frames": 4} and len(mesh.devices) == 4
    got = ShardedStreamDecoder(SAMPLE, mesh=mesh, sound_system=9).decode_all()
    want = ShardedStreamDecoder(SAMPLE, n_devices=4, sound_system=9,
                                device="cpu").decode_all()
    assert np.array_equal(got, want)


def test_last_shard_limiter_state_matches_jax(monkeypatch):
    """The limiter state after the last shard against the JAX program's
    final_lim[S - 1] (convert.limiter_state), on a stream whose limiter is
    engaged there: the delay line and peak ring equal, the envelope within
    4 ulp (XLA:CPU contracts the JAX gain step into FMAs)."""
    captured = {}
    real = jax_sharded._sharded_program

    def spy(*a, **k):
        fn = real(*a, **k)

        def run(*args):
            out = fn(*args)
            captured["final"] = out[1]
            return out
        return run

    monkeypatch.setattr(jax_sharded, "_sharded_program", spy)
    n = 16
    stream = _loud(ChannelLayout.L714, n, 12, n - 2)
    jax_sharded.ShardedStreamDecoder(stream, n_devices=4,
                                     sound_system=9).decode_all()
    want = convert.limiter_state(
        {k: np.asarray(v)[-1] for k, v in captured["final"].items()}, "cpu")
    dec = ShardedStreamDecoder(stream, n_devices=4, sound_system=9,
                               device="cpu")
    dec.decode_all()
    got = dec.final_limiter
    assert float(want["env"][3]) != -1.0  # engaged in the last shard
    assert torch.equal(got["entry_index"], want["entry_index"])
    assert torch.equal(got["delay_data"], want["delay_data"])
    assert torch.equal(got["peak_data"], want["peak_data"])
    assert torch.allclose(got["env"], want["env"], rtol=4 * 2.0 ** -23,
                          atol=0)


def test_stream_filling_the_mesh_drains():
    """16 frames on 4 and 8 shards: no padded frame runs past the stream,
    so the drain is one K3 call from the last shard's state (and 19 frames
    pad the last shard instead); all equal the batched decode."""
    stream = _loud(ChannelLayout.L714, 16, 12, 14)
    want = BatchedStreamDecoder(stream, sound_system=9, batch_frames=8,
                                device="cpu").decode_all()
    for k in (4, 8):
        got = ShardedStreamDecoder(stream, n_devices=k, sound_system=9,
                                   device="cpu").decode_all()
        assert _lsb(got, want) <= 1


def test_not_48k_keeps_the_jax_sharded_output():
    """A 44.1 kHz stream: as the JAX sharded decoder, no resample tail and
    no limiter (the batched decoders resample to 48 kHz); the quantized mix
    at 44.1 kHz, within 1 LSB of JAX (ROADMAP.md §3)."""
    stream = streams.build_pcm_layout_stream(ChannelLayout.L510, n_frames=9,
                                             rate=44100, amp=0.6)[0]
    want = np.asarray(jax_sharded.ShardedStreamDecoder(
        stream, n_devices=4, sound_system=1).decode_all())
    got = ShardedStreamDecoder(stream, n_devices=4, sound_system=1,
                               device="cpu").decode_all()
    assert _lsb(got, want) <= 1
    assert got.shape == (9 * 960, 6)
    batched = BatchedStreamDecoder(stream, sound_system=1, batch_frames=4,
                                   device="cpu").decode_all()
    assert batched.shape[0] != got.shape[0]


def test_true_peak_chain(monkeypatch):
    """IAMF_TRUEPEAK=1: K3's state carries the true-peak meter's history
    (tp_hist) along the chain, and the sharded decode equals the batched
    one on content whose true peaks engage the limiter. The JAX sharded
    decoder raises here (its shard_map out_specs list the limiter state
    without tp_hist, iamf_tpu/parallel/sharded_decoder.py:648-651;
    ROADMAP.md §3), so the port is held to its batched decode only."""
    monkeypatch.setenv("IAMF_TRUEPEAK", "1")
    stream = streams.build_pcm_layout_stream(
        ChannelLayout.L510, n_frames=24,
        pcm_override=streams.isp_tone_pcm(24, 6))[0]
    want = BatchedStreamDecoder(stream, sound_system=1, batch_frames=8,
                                device="cpu").decode_all()
    dec = ShardedStreamDecoder(stream, n_devices=4, sound_system=1,
                               device="cpu")
    assert np.array_equal(dec.decode_all(), want)
    assert "tp_hist" in dec.final_limiter
    with pytest.raises(ValueError, match="pytree structure"):
        jax_sharded.ShardedStreamDecoder(stream, n_devices=4,
                                         sound_system=1).decode_all()
    monkeypatch.setenv("IAMF_TRUEPEAK", "0")
    sample_peaks = BatchedStreamDecoder(stream, sound_system=1,
                                        batch_frames=8,
                                        device="cpu").decode_all()
    assert _lsb(sample_peaks, want) > 500  # the meter engaged


def test_refusals():
    with pytest.raises(ValueError, match="mutually exclusive"):
        ShardedStreamDecoder(SAMPLE, n_devices=8, element_axis=2,
                             substream_axis=2, device="cpu")
    with pytest.raises(ValueError, match="needs >= that many"):
        ShardedStreamDecoder(SAMPLE, n_devices=1, substream_axis=2,
                             device="cpu")
    with pytest.raises(ValueError, match="2 devices"):
        PipelinedStreamDecoder(SAMPLE, devices=["cpu"])
    with pytest.raises(ValueError, match="rate-mismatch"):
        PipelinedStreamDecoder(streams.build_pcm_layout_stream(
            ChannelLayout.STEREO, n_frames=4, rate=44100)[0],
            devices=["cpu", "cpu"])


PP_CASES = {
    "opus_sample": (lambda: SAMPLE, 9, 4),
    "loud_pcm": (lambda: _loud(ChannelLayout.L510, 12, 6, 6), 1, 4),
}


@pytest.mark.parametrize("name", sorted(PP_CASES))
def test_pipelined_equals_batched(name):
    build, ss, bf = PP_CASES[name]
    stream = build()
    want = BatchedStreamDecoder(stream, sound_system=ss, batch_frames=bf,
                                device="cpu").decode_all()
    dec = PipelinedStreamDecoder(stream, devices=["cpu", "cpu"],
                                 sound_system=ss, batch_frames=bf)
    got = dec.decode_all()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    jax_want = JaxPP(stream, devices=jax.devices()[:2], sound_system=ss,
                     batch_frames=bf).decode_all()
    assert _lsb(got, jax_want) <= 1


def _mesh(shape, axes=("frames", "elements")):
    return ShardMesh(axes, shape, ["cpu"] * int(np.prod(shape)))


def test_mesh_ppermute():
    """ppermute by +1 and -1 along each axis of a 3 x 2 mesh (zeros where
    no shard sends), and one hop of a chain (src)."""
    mesh = _mesh((3, 2))
    vals = {i: [torch.full((2,), float(i))] for i in range(6)}
    fwd = mesh.ppermute(vals, "frames", +1)
    assert [float(fwd[i][0][0]) for i in range(6)] == [0, 0, 0, 1, 2, 3]
    back = mesh.ppermute(vals, "elements", -1)
    assert [float(back[i][0][0]) for i in range(6)] == [1, 0, 3, 0, 5, 0]
    hop = mesh.ppermute(vals, "frames", +1, src=1)
    assert sorted(hop) == [4, 5]
    assert [float(hop[i][0][0]) for i in (4, 5)] == [2, 3]
    assert mesh.axis_index(5, "frames") == 2
    assert mesh.axis_index(5, "elements") == 1


def test_mesh_psum_and_gathers():
    mesh = _mesh((2, 3), ("frames", "substreams"))
    vals = {i: torch.arange(4.0) + 10 * i for i in range(6)}
    s = mesh.psum(vals, "substreams")
    assert torch.equal(s[4], vals[3] + vals[4] + vals[5])
    assert torch.equal(s[0], s[2])
    g = mesh.all_gather({i: v[None] for i, v in vals.items()},
                        "substreams", dim=0)
    assert torch.equal(g[1], torch.stack([vals[0], vals[1], vals[2]]))
    pcm = {i: torch.full((3, 2), i, dtype=torch.int16) for i in range(6)}
    out = mesh.process_allgather(pcm)
    assert out.dtype == torch.int16 and out.shape == (2, 3, 2)
    assert out[:, 0, 0].tolist() == [0, 3]


def test_scaling_bench_rows_on_cpu():
    """The bench's rows on the CPU: the JAX keys, every count within 1 LSB
    of one shard (checked inside), the model's arithmetic."""
    table = scaling_bench.rows(scaling_bench.content("pcm", 16), "cpu",
                               shards=(1, 2, 4), reps=1)
    assert [r["shards"] for r in table] == [1, 2, 4]
    for r in table:
        assert r["preroll_frames"] == 0 and r["model_efficiency_pct"] == 100
        assert r["device"] == "cpu" and not r["shared_card"]
        assert r["carry_bytes_per_boundary"] == 4 * (4 + 12 * 240 + 240 + 1)
