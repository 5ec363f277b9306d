"""The port's sharded decoder across processes: the counterpart of
tests/test_multihost.py on torch.distributed.

Each case starts N worker processes on this machine (gloo on the CPU,
127.0.0.1 and a free port), each owning its block of the mesh's shards;
the workers import no JAX and nothing of the JAX package. The carry
chains and the halo cross the process boundary as send/recv pairs, the
gathers as all_reduce, and every rank gets the whole PCM, which must equal
the single-process decode: byte for byte on PCM, within 1 LSB on Opus. A
worker has a timeout and its process group one too, so a chain that
deadlocks fails the test instead of hanging the suite.

The NCCL case (two ranks, one card each) is marked ``cuda`` and skips with
fewer than two cards.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from iamf_tpu_torch.constants import ChannelLayout
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from iamf_tpu_torch.tools import streams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import datetime
import sys
sys.modules["jax"] = None
sys.modules["iamf_tpu"] = None
(root, rank, world, port, stream_path, out_path, per_rank, sub_axis,
 elem_axis, sound_system, backend) = sys.argv[1:12]
sys.path.insert(0, root)
rank, world, per_rank, sub_axis, elem_axis, sound_system = map(
    int, (rank, world, per_rank, sub_axis, elem_axis, sound_system))
import numpy as np
import torch
import torch.distributed as dist

shared_card = backend == "nccl:0"

device = "cpu"
if backend.startswith("nccl"):
    # "nccl": rank r on card r; "nccl:0": every rank on card 0
    torch.cuda.set_device(int(backend[5:] or rank))
    device = "cuda"
    backend = "nccl"
dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=90))
from iamf_tpu_torch.parallel.mesh import ShardMesh
from iamf_tpu_torch.parallel.sharded_decoder import ShardedStreamDecoder

if backend == "gloo":
    # gloo carries CPU tensors only: a mesh of cards on it is refused
    try:
        ShardMesh(("frames",), (world,), ["cuda:0"])
    except ValueError as e:
        assert "gloo" in str(e), e
    else:
        raise AssertionError("a CUDA mesh on gloo was accepted")
data = open(stream_path, "rb").read()
if shared_card:
    try:
        ShardMesh.build(world, device="cuda")
    except ValueError as e:
        assert "share one card" in str(e), e
        print("REFUSED")
    dist.destroy_process_group()
    sys.exit(0)
dec = ShardedStreamDecoder(data, n_devices=world * per_rank,
                           sound_system=sound_system, substream_axis=sub_axis,
                           element_axis=elem_axis, device=device)
assert dec.mesh.local == list(range(rank * per_rank, (rank + 1) * per_rank))
pcm = dec.decode_all()
np.save(f"{out_path}.{rank}.npy", pcm)
assert not any(m.split(".")[0] in ("jax", "iamf_tpu") for m in sys.modules
               if sys.modules[m] is not None)
dist.destroy_process_group()
print("WORKER-OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_workers(tmp_path, stream: bytes, n_proc: int, per_rank: int,
                  substream_axis: int = 1, element_axis: int = 1,
                  sound_system: int = 9, backend: str = "gloo") -> list:
    """Run the workers on `stream` to their end (or their timeout);
    returns (return code, log) a rank."""
    spath = tmp_path / "s.iamf"
    spath.write_bytes(stream)
    out = tmp_path / "pcm"
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, ROOT, str(r), str(n_proc), str(port),
         str(spath), str(out), str(per_rank), str(substream_axis),
         str(element_axis), str(sound_system), backend],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n_proc)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def run_cluster(tmp_path, stream: bytes, n_proc: int, per_rank: int,
                **kw) -> list:
    """start_workers, each to a clean end; returns every rank's PCM."""
    for r, (rc, log) in enumerate(start_workers(tmp_path, stream, n_proc,
                                                per_rank, **kw)):
        assert rc == 0 and "WORKER-OK" in log, f"rank {r}:\n{log[-3000:]}"
    return [np.load(tmp_path / f"pcm.{r}.npy") for r in range(n_proc)]


def _single(stream: bytes, sound_system: int = 9) -> np.ndarray:
    return BatchedStreamDecoder(stream, sound_system=sound_system,
                                batch_frames=8, device="cpu").decode_all()


def _loud_714(n_frames: int, lo: int, hi: int) -> bytes:
    T = 960
    pcm = streams.sine_pcm(n_frames * T, 12, 48000, amp=0.4, bits=16,
                           seed=7)
    burst = streams.sine_pcm((hi - lo) * T, 12, 48000, amp=1.4, bits=16,
                             seed=8)
    pcm[lo * T:hi * T] = np.clip(burst, -32768, 32767)
    return streams.build_pcm_layout_stream(
        ChannelLayout.L714, n_frames=n_frames, pcm_override=pcm)[0]


@pytest.mark.parametrize("per_rank,mesh_kw", [
    (2, {}), (2, {"substream_axis": 2}), (2, {"substream_axis": 4})],
    ids=["frames-mesh", "frames-x-substreams", "substreams-across-ranks"])
def test_two_process_decode_matches_single_process(tmp_path, per_rank,
                                                   mesh_kw):
    """2 processes x 2 shards on loud 7.1.4 PCM, the limiter live at the
    boundary between the two ranks' shards: the 1-D mesh; the 2 x 2
    (frames, substreams) mesh, each rank a frames row; and the 1 x 4 one,
    whose lane gather crosses the ranks."""
    stream = _loud_714(24, 11, 13)
    want = _single(stream)
    assert np.abs(want.astype(np.int64)).max() >= 28000
    for got in run_cluster(tmp_path, stream, 2, per_rank, **mesh_kw):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_two_process_elements_mixer(tmp_path):
    """The two-element stream on a 1 x 2 (frames, elements) mesh over two
    processes, one element a rank: the mixer's psum crosses the ranks."""
    stream = streams.build_two_element_stream(n_frames=12,
                                              gain2_q78=-(3 << 8))[0]
    want = _single(stream, sound_system=0)
    for got in run_cluster(tmp_path, stream, 2, 1, element_axis=2,
                           sound_system=0):
        assert np.array_equal(got, want)


def test_three_process_uneven_shards(tmp_path):
    """3 processes x 2 shards on 17 frames, which do not fill the 6-shard
    mesh: the last shard decodes padded rows that the gather drops."""
    stream = streams.build_pcm_layout_stream(ChannelLayout.L714,
                                             n_frames=17, amp=0.5)[0]
    want = _single(stream)
    for got in run_cluster(tmp_path, stream, 3, 2):
        assert np.array_equal(got, want)


def test_two_process_opus_decode(tmp_path):
    """The Opus sample over 2 processes x 2 shards: K1's twin with the
    preroll on each shard, the comb / de-emphasis and limiter chains and
    the head-trim halo across the ranks. <= 1 LSB against the
    single-process batched decode."""
    stream = open(os.path.join(ROOT, "iamf_tpu", "data",
                               "sample_opus_714.iamf"), "rb").read()
    want = _single(stream)
    for got in run_cluster(tmp_path, stream, 2, 2):
        assert got.shape == want.shape
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.cuda
def test_nccl_two_cards(tmp_path):
    """Two ranks, one card each, on NCCL: the chains' hops card to card.
    Equal to the single-process card decode."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    stream = _loud_714(24, 11, 13)
    want = BatchedStreamDecoder(stream, sound_system=9,
                                device="cuda").decode_all()
    for got in run_cluster(tmp_path, stream, 2, 1, backend="nccl"):
        assert got.shape == want.shape
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.cuda
def test_nccl_two_ranks_on_one_card_refused(tmp_path):
    """Two NCCL ranks on one card: the mesh refuses it when it is built
    (before NCCL itself would fail)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    stream = _loud_714(8, 3, 5)
    for rc, log in start_workers(tmp_path, stream, 2, 1, backend="nccl:0"):
        assert rc == 0 and "REFUSED" in log, log[-3000:]
