"""The PyTorch port runs without JAX and without the JAX package, and
refuses to run on a CUDA device that is not there.

The test process itself imports JAX and iamf_tpu (tests/conftest.py), so
the standalone decodes run in a subprocess with ``sys.modules["jax"] =
sys.modules["iamf_tpu"] = None``: any import of either there raises.
codecs/base._ensure_registered swallows ImportError, so the subprocess
also checks that the port's own codecs are registered. The AST scan finds
any import of JAX or iamf_tpu in the port's modules and chip_smoke.py,
inside functions too.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NOJAX_DECODE = r"""
import sys
sys.modules["jax"] = None
sys.modules["iamf_tpu"] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
import iamf_tpu_torch
from iamf_tpu_torch.codecs import base
from iamf_tpu_torch.constants import Codec
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
assert {Codec.OPUS, Codec.PCM, Codec.FLAC, Codec.AAC} <= set(
    base.available_codecs()), base.available_codecs()
root = sys.argv[1]
data = open(root + "/iamf_tpu/data/sample_opus_714.iamf", "rb").read()
out = BatchedStreamDecoder(data, sound_system=9, batch_frames=8,
                           device="cpu").decode_all()
want = np.load(root + "/iamf_tpu_torch/data/sample_opus_714_ssJ.npz")["pcm"]
assert out.shape == want.shape
assert np.abs(out.astype(np.int32) - want.astype(np.int32)).max() <= 1
assert not any(m.split(".")[0] in ("jax", "iamf_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("NOJAX-OK")
"""


def test_decode_without_jax():
    r = subprocess.run([sys.executable, "-c", NOJAX_DECODE, ROOT],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX-OK" in r.stdout


NOJAX_OUTPUT_PATHS = r"""
import os
import sys
sys.modules["jax"] = None
sys.modules["iamf_tpu"] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
from iamf_tpu_torch.constants import ChannelLayout
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from iamf_tpu_torch.tools import streams
binaural = BatchedStreamDecoder(
    streams.build_pcm_51_stream(n_frames=7, hrm=1)[0], binaural=True,
    batch_frames=3, device="cpu").decode_all()
resampled = BatchedStreamDecoder(
    streams.build_pcm_layout_stream(ChannelLayout.STEREO, n_frames=8,
                                    rate=44100)[0],
    sound_system=0, batch_frames=3, device="cpu").decode_all()
aac = BatchedStreamDecoder(
    streams.build_aac_layout_stream(ChannelLayout.L510, n_frames=9)[0],
    sound_system=1, batch_frames=4, device="cpu").decode_all()
os.environ["IAMF_TRUEPEAK"] = "1"
truepeak = BatchedStreamDecoder(
    streams.build_pcm_51_stream(n_frames=8, amp=0.9)[0], sound_system=1,
    batch_frames=3, device="cpu").decode_all()
np.savez(sys.argv[2], binaural=binaural, resampled=resampled, aac=aac,
         truepeak=truepeak)
assert not any(m.split(".")[0] in ("jax", "iamf_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("NOJAX-OK")
"""


def test_output_paths_without_jax(tmp_path, monkeypatch):
    """A binaural (M2B, K8's twin), a 44.1 kHz (K10's twin), an AAC (K7's
    twin) and a true-peak (IAMF_TRUEPEAK=1, K9's twin) decode with JAX and
    the JAX package blocked, on streams from the port's own builders, held
    to the JAX decoder here on the same streams (from tests/vectors.py
    where it has the builder): <= 1 LSB, same shape."""
    import numpy as np

    import vectors
    from iamf_tpu.constants import ChannelLayout
    from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as Jax
    from iamf_tpu_torch.tools import streams

    out = tmp_path / "out.npz"
    r = subprocess.run([sys.executable, "-c", NOJAX_OUTPUT_PATHS, ROOT,
                        str(out)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX-OK" in r.stdout
    got = np.load(out)
    want = {
        "binaural": Jax(vectors.build_pcm_51_stream(n_frames=7, hrm=1)[0],
                        binaural=True, batch_frames=3).decode_all(),
        "resampled": Jax(vectors.build_pcm_layout_stream(
            ChannelLayout.STEREO, n_frames=8, rate=44100)[0],
            sound_system=0, batch_frames=3).decode_all(),
        "aac": Jax(streams.build_aac_layout_stream(
            ChannelLayout.L510, n_frames=9)[0], sound_system=1,
            batch_frames=4).decode_all(),
    }
    monkeypatch.setenv("IAMF_TRUEPEAK", "1")
    want["truepeak"] = Jax(vectors.build_pcm_51_stream(n_frames=8, amp=0.9)[0],
                           sound_system=1, batch_frames=3).decode_all()
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        assert np.abs(got[k].astype(np.int32) - w.astype(np.int32)).max() <= 1


NOJAX_SERVING_PATHS = r"""
import os
import sys
sys.modules["jax"] = None
sys.modules["iamf_tpu"] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
from iamf_tpu_torch.constants import ChannelLayout
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from iamf_tpu_torch.core.serving import MultiStreamServer
from iamf_tpu_torch.tools import streams
path = os.path.join(os.path.dirname(sys.argv[2]), "s.mp4")
with open(path, "wb") as f:
    f.write(streams.build_fmp4(streams.build_pcm_51_stream(n_frames=8)[0],
                               fragments=3))
mp4 = BatchedStreamDecoder.from_mp4(path, start_sec=0.05, sound_system=1,
                                    batch_frames=3, device="cpu").decode_all()
reconfigured = BatchedStreamDecoder(
    streams.build_pcm_layout_stream(ChannelLayout.STEREO, n_frames=5)[0]
    + streams.build_pcm_51_stream(n_frames=4)[0], sound_system=1,
    batch_frames=3, device="cpu").decode_all()
fleet = [streams.build_pcm_layout_stream(ChannelLayout.L714, n_frames=n,
                                         seed=n)[0] for n in (5, 9)]
served = MultiStreamServer(fleet, sound_system=9, batch_frames=4,
                           device="cpu").decode_all()
np.savez(sys.argv[2], mp4=mp4, reconfigured=reconfigured,
         served0=np.concatenate([b.numpy() for b in served[0]]),
         served1=np.concatenate([b.numpy() for b in served[1]]))
assert not any(m.split(".")[0] in ("jax", "iamf_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("NOJAX-OK")
"""


def test_serving_paths_without_jax(tmp_path):
    """from_mp4 (fMP4, a seek), a reconfigured stream and a
    MultiStreamServer fleet with JAX and the JAX package blocked, held to
    the JAX package's decoders here on the same bytes: 0 LSB on PCM."""
    import numpy as np

    import vectors
    from iamf_tpu.constants import ChannelLayout
    from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as Jax
    from iamf_tpu.core.serving import MultiStreamServer as JaxServer

    out = tmp_path / "out.npz"
    r = subprocess.run([sys.executable, "-c", NOJAX_SERVING_PATHS, ROOT,
                        str(out)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX-OK" in r.stdout
    got = np.load(out)
    fleet = [vectors.build_pcm_layout_stream(ChannelLayout.L714, n_frames=n,
                                             seed=n)[0] for n in (5, 9)]
    served = JaxServer(fleet, sound_system=9, batch_frames=4).decode_all()
    want = {
        "mp4": Jax.from_mp4(str(tmp_path / "s.mp4"), start_sec=0.05,
                            sound_system=1, batch_frames=3).decode_all(),
        "reconfigured": Jax(vectors.build_pcm_layout_stream(
            ChannelLayout.STEREO, n_frames=5)[0]
            + vectors.build_pcm_51_stream(n_frames=4)[0], sound_system=1,
            batch_frames=3).decode_all(),
        "served0": np.concatenate([np.asarray(b) for b in served[0]]),
        "served1": np.concatenate([np.asarray(b) for b in served[1]]),
    }
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        assert np.array_equal(got[k], w), k


NOJAX_SERIAL = r"""
import sys
sys.modules["jax"] = None
sys.modules["iamf_tpu"] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
from iamf_tpu_torch.api import IAMFDecoder
from iamf_tpu_torch.constants import ChannelLayout
from iamf_tpu_torch.tools import streams


def decode(data, **kw):
    dec = IAMFDecoder(device="cpu")
    if kw.get("binaural"):
        dec.set_binaural()
    else:
        dec.set_sound_system(kw["ss"])
    pos = dec.configure(data)
    chunks = []
    while pos < len(data):
        consumed, pcm = dec.decode(data[pos:])
        if consumed == 0 and pcm is None:
            break
        pos += consumed
        if pcm is not None and len(pcm):
            chunks.append(pcm)
    _, pcm = dec.decode(None)
    if pcm is not None and len(pcm):
        chunks.append(pcm)
    return np.concatenate(chunks)


sample = open(sys.argv[1] + "/iamf_tpu/data/sample_opus_714.iamf",
              "rb").read()
np.savez(sys.argv[2], sample=decode(sample, ss=9),
         binaural=decode(streams.build_pcm_layout_stream(
             ChannelLayout.L714, n_frames=5, hrm=1)[0], binaural=True))
assert not any(m.split(".")[0] in ("jax", "iamf_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("NOJAX-OK")
"""


def test_serial_decoder_without_jax(tmp_path):
    """The frame-serial IAMFDecoder(device="cpu") decodes the Opus sample
    and a binaural (M2B) PCM stream with JAX and the JAX package blocked,
    held here to iamf_tpu.api.IAMFDecoder on the same bytes: <= 1 LSB,
    same shape."""
    import numpy as np

    import vectors
    from iamf_tpu.constants import ChannelLayout
    from test_torch_api import serial_decode
    from iamf_tpu.api import IAMFDecoder as Jax

    out = tmp_path / "out.npz"
    r = subprocess.run([sys.executable, "-c", NOJAX_SERIAL, ROOT, str(out)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX-OK" in r.stdout
    got = np.load(out)
    sample = open(os.path.join(ROOT, "iamf_tpu", "data",
                               "sample_opus_714.iamf"), "rb").read()
    want = {
        "sample": serial_decode(Jax(), sample, ss=9),
        "binaural": serial_decode(Jax(), vectors.build_pcm_layout_stream(
            ChannelLayout.L714, n_frames=5, hrm=1)[0], binaural=True),
    }
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        d = np.abs(got[k].astype(np.int32) - w.astype(np.int32)).max()
        assert d <= 1, f"{k}: max|diff| {d} LSB"


def test_serial_decoder_defaults_to_the_card():
    """IAMFDecoder() runs on the card: with none visible it raises, as do
    the serial pieces it builds on a CUDA request; nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: this checks the refusal")
    from iamf_tpu_torch.api import IAMFDecoder
    from iamf_tpu_torch.constants import ChannelLayout
    from iamf_tpu_torch.dsp.binaural import HRTFRenderer
    from iamf_tpu_torch.dsp.limiter import Limiter, LimiterConfig

    for make in (IAMFDecoder, lambda: IAMFDecoder(device="cuda"),
                 lambda: Limiter(LimiterConfig()),
                 lambda: HRTFRenderer(ChannelLayout.STEREO, 960)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_sources_import_no_jax():
    """No module of the port, not chip_smoke.py and no perf/ script
    imports JAX or the JAX package, at module level or inside a function
    (relative imports stay inside the port)."""
    perf = os.path.join(ROOT, "perf")
    paths = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(perf, f) for f in sorted(os.listdir(perf))
        if f.endswith(".py")]
    assert os.path.join(perf, "k11.py") in paths
    for dirpath, _, files in os.walk(os.path.join(ROOT, "iamf_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    assert len(paths) > 30
    for new in ("core/serving.py", "mp4/demux.py", "mp4/iamf_track.py",
                "tools/mp4builder.py", "api.py", "utils/wav.py",
                "mp4/atoms.py", "tools/vlogger.py", "tools/player.py",
                "codecs/opus/device_cwrsi.py", "codecs/opus/device_leaf.py",
                "codecs/opus/device_bands.py", "codecs/opus/band_replay.py",
                "codecs/opus/band_pack.py", "tools/celt_taps.py",
                "utils/logging.py", "parallel/mesh.py",
                "parallel/sharded_decoder.py", "parallel/pp_decoder.py",
                "tools/scaling_bench.py"):
        assert os.path.join(ROOT, "iamf_tpu_torch", new) in paths, new
    bad = []
    for path in paths:
        for node in ast.walk(ast.parse(open(path).read())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif (isinstance(node, ast.ImportFrom) and node.module
                  and node.level == 0):
                names = [node.module]
            bad += [(path, n) for n in names
                    if n.split(".")[0] in ("jax", "iamf_tpu")]
    assert not bad
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert '"tests"' not in src and "vectors" not in src


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: this checks the refusal")
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: this checks the refusal")
    from iamf_tpu_torch import require_cuda, resolve_device
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

    data = open(os.path.join(ROOT, "iamf_tpu", "data",
                             "sample_opus_714.iamf"), "rb").read()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        require_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedStreamDecoder(data, sound_system=9, device="cuda")


def test_default_device_is_the_card():
    """BatchedStreamDecoder without a device runs on the card: with none
    visible it raises, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: this checks the refusal")
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

    data = open(os.path.join(ROOT, "iamf_tpu", "data",
                             "sample_opus_714.iamf"), "rb").read()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedStreamDecoder(data, sound_system=9)


def test_server_and_mp4_default_to_the_card(tmp_path):
    """MultiStreamServer and from_mp4 run on the card by default too: with
    no card visible they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: this checks the refusal")
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
    from iamf_tpu_torch.core.serving import MultiStreamServer
    from iamf_tpu_torch.tools import streams

    data = open(os.path.join(ROOT, "iamf_tpu", "data",
                             "sample_opus_714.iamf"), "rb").read()
    path = tmp_path / "s.mp4"
    path.write_bytes(streams.build_mp4(data))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiStreamServer([data, data], sound_system=9)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedStreamDecoder.from_mp4(str(path), sound_system=9)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel's wrapper never hands a CPU pointer to the device: it
    raises before building or loading anything."""
    from iamf_tpu_torch.codecs.aac import synth as aac_synth
    from iamf_tpu_torch.codecs.opus import (device_bands, device_cwrsi,
                                            device_leaf, imdct, synth)
    from iamf_tpu_torch.constants import ChannelLayout
    from iamf_tpu_torch.dsp import binaural, limiter, resample

    cfg = limiter.LimiterConfig(channels=2)
    hrir = binaural.hrir_for_batch(
        binaural.hrir_bank(ChannelLayout.STEREO), 1, 960, "cpu")
    calls = {
        "K1": lambda: imdct.imdct_overlap_cuda(
            imdct.FusedMats(), torch.zeros(1, 2, 960),
            torch.zeros(1, 2, dtype=torch.bool), torch.zeros(2, 60)),
        "K2": lambda: synth.comb_deemph_cuda(
            torch.zeros(120), torch.zeros(1, 2, 960), torch.zeros(1, 2, 973),
            torch.zeros(2, synth.HIST), torch.zeros(2)),
        "K3": lambda: limiter.limit_quantize_cuda(
            cfg, {k: v[None] for k, v in limiter.init_state(cfg, "cpu")
                  .items()}, torch.zeros(1, 2, 960), 16),
        "K8": lambda: binaural.hrtf_conv_cuda(
            hrir, torch.zeros(1, 2, 960), torch.zeros(1, 2, 255)),
        "K10": lambda: resample.resample_cuda(
            resample.ResamplePlan(44100, 48000, device="cpu"),
            torch.zeros(2, 960)),
        "K7": lambda: aac_synth.synthesize_cuda(
            aac_synth.Tables(), torch.zeros(1, 2, 1024),
            torch.zeros(1, 2, 3, dtype=torch.int32), torch.zeros(2, 1024)),
        "K9": lambda: limiter.truepeak_cuda(torch.zeros(1, 2, 960),
                                            torch.zeros(1, 2, 11)),
        "K11": lambda: device_cwrsi.cwrsi_cuda(
            torch.full((3,), 4, dtype=torch.int32),
            torch.ones(3, dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32).view(torch.uint32)),
        "K12": lambda: device_leaf._normrot_cuda(
            torch.ones(2, 96, dtype=torch.int32), None, torch.ones(2), None,
            None, 2, 96),
        "K12 LCG": lambda: device_leaf.K12_ENTRY(
            0, torch.zeros(3, dtype=torch.int32), 3,
            torch.zeros(2, 4097, dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32)),
        "K13": lambda: device_bands.run_frames_cuda(*_one_packed_frame()),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CUDA device"):
            call()


def _one_packed_frame():
    """An empty packed frame's tensors on the CPU (pack_tensors' defaults,
    no band present) and its seed."""
    from iamf_tpu_torch import convert
    from iamf_tpu_torch.codecs.opus import band_pack, device_bands

    pf = band_pack.PackedFrame(C=1, M=8, norm_offset=0, seed0=5, bands=[],
                               leaves=[])
    bt, lt = convert.packed_frame(*device_bands.pack_tensors(pf, []), "cpu")
    return bt, lt, torch.tensor([5], dtype=torch.int32).view(torch.uint32)


NOJAX_CELT = r"""
import sys
sys.modules["jax"] = None
sys.modules["iamf_tpu"] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
from iamf_tpu_torch.codecs.opus import band_pack, device_bands, device_leaf
from iamf_tpu_torch.tools import celt_taps
frames = celt_taps.tap_stream(open(
    sys.argv[1] + "/iamf_tpu/data/sample_opus_714.iamf", "rb").read())
n, k, idx, gain, spread, blocks, xo = celt_taps.all_leaves(frames)
X = device_leaf.reconstruct(n, k, idx, gain, spread, blocks,
                            device="cpu").numpy()
mask = np.arange(32)[None, :] < np.minimum(n, 32)[:, None]
a, b = np.where(mask, xo, 0), np.where(mask, X[:, :32], 0)
assert (np.abs(a - b) / np.maximum(np.abs(a).max(1, keepdims=True),
                                   1e-3)).max() < 1e-5
off = 0
for f in frames:
    L = len(f.leaves[0])
    if f.tap_C == 1:
        pf = band_pack.pack_frame(f.recs)
        bt, lt = device_bands.pack_tensors(pf, list(X[off:off + L]))
        spec, seed, _ = device_bands.run_frame(bt, lt, pf.seed0,
                                               device="cpu")
        want = f.X[0]
        assert np.abs(spec.numpy() - want).max() / np.abs(want).max() < 2e-5
        assert int(seed) == f.seed_out
    off += L
np.save(sys.argv[2], X)
assert not any(m.split(".")[0] in ("jax", "iamf_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("NOJAX-OK")
"""


def test_celt_device_stages_without_jax(tmp_path):
    """The CELT entropy stages' twins on the Opus sample's taps with JAX
    and the JAX package blocked: reconstruct on every leaf within rel
    1e-5 of the native leaf tap, run_frame on each mono frame within rel
    2e-5 of the band tap with the emitted end seed; the leaf vectors
    equal the port's own run here."""
    import numpy as np

    from iamf_tpu_torch.codecs.opus import device_leaf
    from iamf_tpu_torch.tools import celt_taps

    out = tmp_path / "x.npy"
    r = subprocess.run([sys.executable, "-c", NOJAX_CELT, ROOT, str(out)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX-OK" in r.stdout
    leaves = celt_taps.all_leaves(celt_taps.tap_stream(open(os.path.join(
        ROOT, "iamf_tpu", "data", "sample_opus_714.iamf"), "rb").read()))
    want = device_leaf.reconstruct(*leaves[:6], device="cpu").numpy()
    assert np.array_equal(np.load(out), want)


def test_celt_entry_points_default_to_the_card():
    """reconstruct and run_frame on numpy input run on the card unless
    asked for the CPU: with no card visible they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: this checks the refusal")
    import numpy as np

    from iamf_tpu_torch.codecs.opus import band_pack, device_bands
    from iamf_tpu_torch.codecs.opus import device_leaf

    one = np.ones(1, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_leaf.reconstruct(4 * one, one, np.zeros(1, np.uint32),
                                np.ones(1, np.float32), one, one)
    pf = band_pack.PackedFrame(C=1, M=8, norm_offset=0, seed0=5, bands=[],
                               leaves=[])
    bt, lt = device_bands.pack_tensors(pf, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_bands.run_frame(bt, lt, 5)


NOJAX_PARALLEL = r"""
import sys
sys.modules["jax"] = None
sys.modules["iamf_tpu"] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
from iamf_tpu_torch.parallel.pp_decoder import PipelinedStreamDecoder
from iamf_tpu_torch.parallel.sharded_decoder import ShardedStreamDecoder
from iamf_tpu_torch.tools import scaling_bench
sample = open(sys.argv[1] + "/iamf_tpu/data/sample_opus_714.iamf",
              "rb").read()
sharded = ShardedStreamDecoder(sample, n_devices=4, sound_system=9,
                               device="cpu").decode_all()
substreams = ShardedStreamDecoder(sample, n_devices=4, sound_system=9,
                                  substream_axis=2, device="cpu").decode_all()
pp = PipelinedStreamDecoder(sample, devices=["cpu", "cpu"], sound_system=9,
                            batch_frames=8).decode_all()
rows = scaling_bench.rows(sample, "cpu", shards=(1, 2), reps=1)
assert [r["shards"] for r in rows] == [1, 2]
np.savez(sys.argv[2], sharded=sharded, substreams=substreams, pp=pp)
assert not any(m.split(".")[0] in ("jax", "iamf_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("NOJAX-OK")
"""


def test_parallel_decoders_without_jax(tmp_path):
    """ShardedStreamDecoder (1-D and (frames, substreams)),
    PipelinedStreamDecoder and the scaling bench's rows on the Opus sample
    with JAX and the JAX package blocked, held here to the JAX package's
    decoders on the same bytes and meshes: <= 1 LSB, same shape."""
    import jax
    import numpy as np

    from iamf_tpu.parallel.pp_decoder import PipelinedStreamDecoder as JaxPP
    from iamf_tpu.parallel.sharded_decoder import ShardedStreamDecoder as Jax

    out = tmp_path / "out.npz"
    r = subprocess.run([sys.executable, "-c", NOJAX_PARALLEL, ROOT,
                        str(out)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX-OK" in r.stdout
    got = np.load(out)
    sample = open(os.path.join(ROOT, "iamf_tpu", "data",
                               "sample_opus_714.iamf"), "rb").read()
    want = {
        "sharded": Jax(sample, n_devices=4, sound_system=9).decode_all(),
        "substreams": Jax(sample, n_devices=4, sound_system=9,
                          substream_axis=2).decode_all(),
        "pp": JaxPP(sample, devices=jax.devices()[:2], sound_system=9,
                    batch_frames=8).decode_all(),
    }
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        assert np.abs(got[k].astype(np.int32) - w.astype(np.int32)).max() <= 1


def test_parallel_decoders_default_to_the_card():
    """Both multi-device decoders run on the card unless asked for the CPU:
    with no card visible they raise, and nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: this checks the refusal")
    from iamf_tpu_torch.parallel.pp_decoder import PipelinedStreamDecoder
    from iamf_tpu_torch.parallel.sharded_decoder import ShardedStreamDecoder

    data = open(os.path.join(ROOT, "iamf_tpu", "data",
                             "sample_opus_714.iamf"), "rb").read()
    for make in (lambda: ShardedStreamDecoder(data, sound_system=9),
                 lambda: ShardedStreamDecoder(data, n_devices=4,
                                              device="cuda"),
                 lambda: PipelinedStreamDecoder(data, sound_system=9),
                 lambda: PipelinedStreamDecoder(data,
                                                devices=["cuda", "cuda"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
