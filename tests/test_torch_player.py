"""The port's CLI player (iamf_tpu_torch/tools/player.py, --device cpu)
against the JAX package's (iamf_tpu/tools/player.py) on the same files:
equal WAV files for a bitstream, an MP4 (-i1) and a binaural (-sb) decode
(headphones rendering mode 0, the reference's default binaural gain
matrix), and equal vlogs (-v) from the copied vlogger and MP4 atom dump.
With mode 1 (the HRTF convolution) the two packages' FFT libraries round
differently: the WAVs' headers are equal and their samples within 1 LSB.

Both players run in-process through their ``main(argv)``, each in its own
working directory, where they write their ss<N>_/binaural_ WAVs.
"""

import filecmp
import io
import os

import numpy as np
import pytest

import vectors
from iamf_tpu.constants import ChannelLayout
from iamf_tpu.mp4 import atoms as jatoms
from iamf_tpu.tools import player as jplayer
from iamf_tpu.tools import vlogger as jvlog
from iamf_tpu.utils.wav import read_wav
from iamf_tpu_torch.mp4 import atoms as patoms
from iamf_tpu_torch.tools import player as pplayer
from iamf_tpu_torch.tools import streams
from iamf_tpu_torch.tools import vlogger as pvlog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "iamf_tpu", "data", "sample_opus_714.iamf")


def _inputs(tmp_path):
    sample = open(SAMPLE, "rb").read()
    files = {
        "sample.iamf": sample,
        "sample.mp4": streams.build_mp4(sample),
        "m2b.iamf": vectors.build_pcm_layout_stream(
            ChannelLayout.L510, n_frames=6, hrm=1)[0],
        "m2m.iamf": vectors.build_pcm_layout_stream(
            ChannelLayout.L510, n_frames=6)[0],
        "scalable.iamf": vectors.build_scalable_pcm_stream(
            n_frames=6, demix_modes=[0, 1, 2, 1, 0, 1])[0],
    }
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    return files


# (input file, player flags, the WAV the player writes)
RUNS = {
    "bitstream_ss9": ("sample.iamf", ["-o2", "-s9"], "ss9_sample.wav"),
    "mp4_ss9": ("sample.mp4", ["-i1", "-o2", "-s9"], "ss9_sample.wav"),
    "binaural_m2m": ("m2m.iamf", ["-o2", "-sb"], "binaural_m2m.wav"),
    "binaural_m2b_hrtf": ("m2b.iamf", ["-o2", "-sb"], "binaural_m2b.wav"),
    "scalable_ss0_24bit_vlog": ("scalable.iamf",
                                ["-o2", "-s0", "-d", "24", "-v", "vlog.txt",
                                 "-m"], "ss0_scalable.wav"),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_player_wav_matches_jax(name, tmp_path, monkeypatch):
    _inputs(tmp_path)
    src, flags, wav = RUNS[name]
    out, met = {}, {}
    for tag, main, extra in (("jax", jplayer.main, []),
                             ("port", pplayer.main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        inp = str(tmp_path / src)
        assert main([*flags, *extra, inp]) == 0
        out[tag] = d
        if "-m" in flags:  # the .met sidecar goes beside the input
            met[tag] = open(f"{inp}.met").read()
    assert os.path.getsize(out["jax"] / wav) > 44
    if name.endswith("hrtf"):
        want = read_wav(str(out["jax"] / wav))
        got = read_wav(str(out["port"] / wav))
        assert got[1:] == want[1:] and got[0].shape == want[0].shape
        d = np.abs(got[0].astype(np.int32) - want[0].astype(np.int32)).max()
        assert d <= 1, f"{name}: max|diff| {d} LSB"
    else:
        assert filecmp.cmp(out["jax"] / wav, out["port"] / wav,
                           shallow=False)
    if "-v" in flags:
        assert filecmp.cmp(out["jax"] / "vlog.txt", out["port"] / "vlog.txt",
                           shallow=False)
    assert met.get("jax") == met.get("port")


def test_vlogger_and_atoms_match_jax(tmp_path):
    """The copied vlogger and MP4 atom dump print the same text."""
    files = _inputs(tmp_path)
    for name in ("sample.iamf", "scalable.iamf", "m2b.iamf"):
        texts = []
        for mod in (jvlog, pvlog):
            buf = io.StringIO()
            n = mod.vlog_stream(files[name], buf)
            texts.append((n, buf.getvalue()))
        assert texts[0] == texts[1] and texts[0][0] > 0, name
    texts = []
    for mod in (jatoms, patoms):
        buf = io.StringIO()
        n = mod.vlog_mp4(files["sample.mp4"], buf)
        texts.append((n, buf.getvalue()))
    assert texts[0] == texts[1] and texts[0][0] > 0


def test_player_defaults_to_the_card(tmp_path, monkeypatch):
    """Without --device the port's player runs on the card: with none
    visible it raises, and nothing falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: this checks the refusal")
    _inputs(tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pplayer.main(["-o2", "-s9", str(tmp_path / "sample.iamf")])
