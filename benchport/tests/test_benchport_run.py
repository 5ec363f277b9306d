"""Whole runs of the harness on the CPU at tiny sizes (the look for a card
skipped): the result line's keys, and `correct` false when the timed path
is broken underneath."""

import json
import os
import subprocess
import sys

import pytest

import run as bench_run

from conftest import BENCH, OPUS_FLEET, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, workload, trace=0, capsys=None, seed=2**31 + 12345):
    rc = bench_run.main(["--workload", workload, "--seed", str(seed),
                         "--seconds", "0.5", "--trace", str(trace)],
                        device="cpu", root=root)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("workload,trace", [
    (OPUS_FLEET, 0), ("binaural714_loud_fleet8", 1),
    ("opus714_ssJ_serial", 1), ("opus714_long_sharded4", 1)])
def test_result_line(tiny_root, capsys, workload, trace):
    res, err = _run(tiny_root, workload, trace, capsys)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(res) == want
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
        assert f"check {name} {c['value']} limit {c['limit']}" in err
    assert err.strip().splitlines()[-1].startswith("check ")
    from harness import manifest

    cell = manifest.Cell(workload, tiny_root)
    kind = cell.per_layer() if trace else cell.end_to_end()
    host = {m["name"] for m in kind if m["source"] == "host_clock"}
    assert host <= set(res["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _altered(monkeypatch):
    """An answer altered where it is produced: each stream's last batch
    off by 3 steps."""
    from iamf_tpu_torch.core import serving

    orig = serving.MultiStreamServer.decode_all

    def decode_all(self):
        outs = orig(self)
        for o in outs:
            o[-1] += 3
        return outs

    monkeypatch.setattr(serving.MultiStreamServer, "decode_all", decode_all)


def _half_left_out(monkeypatch):
    """Half of the fleet's streams left out of the decode: their output
    is the other half's."""
    from iamf_tpu_torch.core import serving

    orig = serving.MultiStreamServer.decode_all

    def decode_all(self):
        outs = orig(self)
        h = len(outs) // 2
        return outs[:h] + outs[:h] + outs[2 * h:]

    monkeypatch.setattr(serving.MultiStreamServer, "decode_all", decode_all)


def _state_unchanged(monkeypatch):
    """The decode step returns the carry it was given: every batch starts
    from the stream's initial synthesis and limiter state."""
    from iamf_tpu_torch.core import serving

    orig = serving.fused_decode

    def fused_decode(cfg, kinds, synths, carry, params, bufs):
        new, pcm = orig(cfg, kinds, synths, carry, params, bufs)
        pipe = dict(carry["pipe"], pos=new["pipe"]["pos"])
        return {"pipe": pipe, "syn": carry["syn"]}, pcm

    monkeypatch.setattr(serving, "fused_decode", fused_decode)


def _serial_altered(monkeypatch):
    from iamf_tpu_torch import api

    orig = api.IAMFDecoder.decode

    def decode(self, data):
        n, pcm = orig(self, data)
        if pcm is not None and len(pcm) > 100:
            pcm = pcm.copy()
            pcm[100, 0] += 300
        return n, pcm

    monkeypatch.setattr(api.IAMFDecoder, "decode", decode)


def _sharded_altered(monkeypatch):
    """An answer altered where it is produced: one shard's frames off by 3
    steps."""
    from iamf_tpu_torch.parallel import sharded_decoder as sd

    orig = sd.ShardedStreamDecoder.decode_all

    def decode_all(self):
        pcm = orig(self).copy()
        pcm[:self.frames_per_shard * 960] += 3
        return pcm

    monkeypatch.setattr(sd.ShardedStreamDecoder, "decode_all", decode_all)


def _zeros(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros(v) for v in tree)
    return tree


def _sharded_no_exchange(monkeypatch):
    """The exchange between chips left out: every hop of the carry chains
    and the halo delivers zeros, as to a shard with no sender."""
    from iamf_tpu_torch.parallel import mesh

    orig = mesh.ShardMesh.ppermute

    def ppermute(self, values, axis, shift, src=None):
        return _zeros(orig(self, values, axis, shift, src))

    monkeypatch.setattr(mesh.ShardMesh, "ppermute", ppermute)


def _sharded_state_unchanged(monkeypatch):
    """The limiter chain's step hands on the state it was given."""
    from iamf_tpu_torch.parallel import sharded_decoder as sd

    orig = sd.limit_quantize

    def limit_quantize(cfg, state, x, bits, frame):
        _, pcm = orig(cfg, state, x, bits, frame)
        return state, pcm

    monkeypatch.setattr(sd, "limit_quantize", limit_quantize)


def _serial_state_unchanged(monkeypatch):
    """The serial limiter keeps the state it started the frame with."""
    from iamf_tpu_torch.dsp.limiter import Limiter

    orig = Limiter.process

    def process(self, x, bits, stride=0):
        state = self.state
        y = orig(self, x, bits, stride)
        self.state = state
        return y

    monkeypatch.setattr(Limiter, "process", process)


@pytest.mark.parametrize("workload,fault", [
    (OPUS_FLEET, _altered),
    (OPUS_FLEET, _half_left_out),
    (OPUS_FLEET, _state_unchanged),
    ("binaural714_loud_fleet8", _altered),
    ("binaural714_loud_fleet8", _half_left_out),
    ("binaural714_loud_fleet8", _state_unchanged),
    ("opus714_long_sharded4", _sharded_altered),
    ("opus714_long_sharded4", _sharded_state_unchanged),
    ("opus714_long_sharded4", _sharded_no_exchange),
    ("opus714_ssJ_serial", _serial_altered),
    ("opus714_ssJ_serial", _serial_state_unchanged)])
def test_fault_makes_correct_false(tiny_root, capsys, monkeypatch, workload,
                                   fault):
    fault(monkeypatch)
    # a seed whose kept fleet is the first, so the checked streams are
    # the two of the tiny fleet
    res, _ = _run(tiny_root, workload, 0, capsys, seed=4)
    assert res["correct"] is False, res["checks"]


def test_no_card_exits_without_result(capsys):
    """Without a CUDA device the run exits with 2 and prints nothing on
    standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    rc = bench_run.main(["--workload", "opus714_ssJ_serial", "--seed", "1",
                         "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""


def test_bare_directory_fails(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone (no
    program) gives no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchport",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchport/run.py", "--workload",
                        "opus714_ssJ_serial", "--seed", "1", "--seconds",
                        "1"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())


def test_forbidden_modules_are_seen(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "iamf_tpu_torchx", object())
    assert bench_run.loaded_forbidden() == ["jax.numpy"]
