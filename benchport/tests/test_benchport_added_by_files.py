"""A configuration goes in by new files alone: its content kind and its
reference are found by name under the run's root, a missing one stops the
run before the warm-up, a stream's own frame size and rate count its
audio and the rooflines' work, and the three cells' streams are the bytes
they were before content kinds were looked up by name."""

import hashlib
import json
import os
import types

import numpy as np
import pytest

import run as bench_run
from harness import check, content, drivers, manifest, roofline

from conftest import BENCH

SEED = 2**31 + 12345
ADDED = "pcm714_binaural_added"
ADDED_CELL = "binaural714_added_fleet2"


def _add_config(root, kind="pcm_loud_added", ref="lpcm_binaural_added",
                files=True):
    """pcm714_binaural under a new name, with a content kind and a
    reference of its own (new files that hand on to the existing ones),
    and a cell of it: files and entries only."""
    b = os.path.join(root, "benchport")
    cfg = json.load(open(os.path.join(b, "configs", "pcm714_binaural.json")))
    cfg.update(name=ADDED, reference=ref)
    cfg["content"] = dict(cfg["content"], kind=kind)
    json.dump(cfg, open(os.path.join(b, "configs", f"{ADDED}.json"), "w"))
    if files:
        with open(os.path.join(b, "content", f"{kind}.py"), "w") as f:
            f.write("from harness import manifest\n\n\n"
                    "def streams(cfg, traffic, units, rng, device):\n"
                    "    return manifest.load('content', 'pcm_loud')"
                    ".streams(cfg, traffic, units, rng, device)\n")
        with open(os.path.join(b, "reference", f"{ref}.py"), "w") as f:
            f.write("from . import lpcm_binaural\n\n"
                    "pcm = lpcm_binaural.pcm\n")
    path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["configs"].append({"name": ADDED, "source": "as pcm714_binaural",
                             "file": f"benchport/configs/{ADDED}.json",
                             "reduced": [], "why": "added by files"})
    bench["workloads"].append({"name": ADDED_CELL, "config": ADDED,
                               "traffic": "loud_fleet8", "chips": 1,
                               "why": "added by files"})
    for m in bench["end_to_end"]:
        if "binaural714_loud_fleet8" in m.get("workloads", []):
            m["workloads"].append(ADDED_CELL)
    json.dump(bench, open(path, "w"))


def test_configuration_added_by_files_runs_correct(tiny_root, capsys):
    _add_config(tiny_root)
    rc = bench_run.main(["--workload", ADDED_CELL, "--seed", str(SEED),
                         "--seconds", "0.5", "--trace", "0"],
                        device="cpu", root=tiny_root)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 2
    assert {"realtime_x", "setup_s"} <= set(res["metrics"])

    added = manifest.Cell(ADDED_CELL, tiny_root)
    first = manifest.Cell("binaural714_loud_fleet8", tiny_root)
    got = content.make(added.config, added.traffic, SEED, root=tiny_root)
    want = content.make(first.config, first.traffic, SEED, root=tiny_root)
    assert [s.data for s in got] == [s.data for s in want]
    assert all(np.array_equal(a.source, b.source)
               for a, b in zip(got, want))


@pytest.mark.parametrize("sub,name,kw", [
    ("content", "no_such_kind", {"kind": "no_such_kind",
                                 "ref": "lpcm_binaural"}),
    ("reference", "no_such_reference", {"kind": "pcm_loud",
                                        "ref": "no_such_reference"})])
def test_missing_file_stops_the_run_before_warm_up(tiny_root, capsys,
                                                   monkeypatch, sub, name,
                                                   kw):
    _add_config(tiny_root, files=False, **kw)
    warmed = []
    monkeypatch.setattr(drivers.Fleet, "warm",
                        lambda self: warmed.append(1))
    with pytest.raises(SystemExit,
                       match=os.path.join(tiny_root, "benchport", sub,
                                          f"{name}.py")):
        bench_run.main(["--workload", ADDED_CELL, "--seed", "1",
                        "--seconds", "0.5"], device="cpu", root=tiny_root)
    assert warmed == []
    assert capsys.readouterr().out == ""


def test_stream_at_another_rate_stops_the_run(tiny_root):
    """The reference limiter and the check's delay are at 48 kHz."""
    _add_config(tiny_root, kind="pcm_441_added")
    with open(os.path.join(tiny_root, "benchport", "content",
                           "pcm_441_added.py"), "w") as f:
        f.write("from harness.content import Stream\n\n\n"
                "def streams(cfg, traffic, units, rng, device):\n"
                "    return [Stream(b'', u, 1024, 44100) for u in units]\n")
    cell = manifest.Cell(ADDED_CELL, tiny_root)
    with pytest.raises(SystemExit, match="44100 Hz.*48000 Hz"):
        content.make(cell.config, cell.traffic, 1, root=tiny_root)


def test_opus_file_of_another_frame_size_stops_the_run(tiny_root):
    """The configuration's frame_size is the one source of a unit's
    samples: an Opus file of other frames stops the run."""
    cell = manifest.Cell("opus714_ssJ_serial", tiny_root)
    cfg = dict(cell.config, frame_size=1024)
    with pytest.raises(SystemExit, match="1024-sample frames"):
        content.make(cfg, cell.traffic, 1, root=tiny_root)


class _StubDecoder:
    """An IAMFDecoder stand-in whose every decode() takes one byte and
    returns one unit of 1024 samples."""

    def __init__(self, device=None):
        pass

    def set_sound_system(self, ss):
        pass

    def configure(self, data):
        return 0

    def decode(self, data):
        return 1, np.zeros((1024, 2), np.int16)


def _cfg(name):
    return json.load(open(os.path.join(BENCH, "configs", f"{name}.json")))


def test_serial_audio_counts_the_streams_frame():
    n = 1 << 20
    stream = content.Stream(bytes(n), n, 1024, 48000)
    d = drivers.Serial(_cfg("opus714_ssJ"), {"mode": "serial"}, [stream], 1,
                       device="cpu")
    d.make = _StubDecoder
    d.warm()
    win = d.run(0.05)
    assert win.attempted > 0
    assert win.audio_s == win.attempted * 1024 / 48000


def test_serial_check_reads_the_streams_frame(monkeypatch):
    """The serial check compares the outputs with a reference of one unit
    more, all but that unit and the limiter's delay: of 1024 samples
    here. A reference one sample longer than that leaves the outputs
    short."""
    n = 1 << 20
    stream = content.Stream(bytes(n), n, 1024, 48000)
    d = drivers.Serial(_cfg("opus714_ssJ"), {"mode": "serial"}, [stream], 1,
                       device="cpu")
    d.make = _StubDecoder
    d.warm()
    win = d.run(0.0)
    extra = [0]

    def reference_pcm(cfg, s, units=None, device="cuda", tf32=False,
                      root=None):
        assert units == win.units + 1
        return np.zeros((win.units * 1024 + 1024 + check.DELAY + extra[0],
                         2), np.int16)

    monkeypatch.setattr(check, "reference_pcm", reference_pcm)
    got = check.serial_numbers({}, {}, win, 1, "cpu")
    assert got["samples"] == win.outputs.size == win.units * 1024 * 2
    extra[0] = 1
    assert check.serial_numbers({}, {}, win, 1, "cpu")["samples"] == 0


@pytest.mark.parametrize("metric,bound", [
    ("k3_roofline_pct.fleet", lambda cfg, n: roofline.k3_bound(n, 2)),
    ("k8_roofline_pct.fleet", lambda cfg, n: roofline.k8_bound(
        n, cfg["channels"], cfg["hrir"]["taps"]))])
def test_rooflines_count_the_streams_frame(metric, bound):
    cfg = _cfg("pcm714_binaural")
    units = [10, 30]
    done = [content.Stream(b"", u, 1024, 48000) for u in units]
    run = types.SimpleNamespace(
        cfg=cfg, win=types.SimpleNamespace(streams_done=done),
        trace=types.SimpleNamespace(kernel_s=lambda symbols: 2.0))
    got = manifest.Reader(metric).read(run)
    want = 100.0 * sum(bound(cfg, u * 1024) for u in units) / 2.0
    assert got == pytest.approx(want, rel=1e-12)


def _digest(streams):
    h = hashlib.sha256()
    for s in streams:
        h.update(s.data)
        if s.source is not None:
            h.update(np.ascontiguousarray(s.source).tobytes())
        h.update(repr((s.units, s.seconds)).encode())
    return h.hexdigest()


# each cell's streams at the tiny root's sizes, as the generator made them
# before content kinds and references were looked up by name
DIGESTS = {
    ("binaural714_loud_fleet8", 7):
        "cbf0dd6cb2dd01f8ba0eb2b1648ede68d09b28637b8a6b5144a02f6c810efa8c",
    ("binaural714_loud_fleet8", SEED):
        "23dc2ce43ae48c5ae869f116ad624f3386a9237246f7486e2d604751ec816e58",
    ("opus714_ssJ_serial", 7):
        "2806c005f4a7f7ffcde6cf6dbb98f457ba485dd90993a209de66fd5a36a6c3da",
    ("opus714_ssJ_serial", SEED):
        "3a1556f10bcd9d6018563c627931f384b409f74afabbd3a0dfce53b395691719",
    ("opus714_long_sharded4", 7):
        "cc8434b04555ccce7c59beaf8305bed03399b6e58835846528a20a28886a46e5",
    ("opus714_long_sharded4", SEED):
        "4df3e126ce0d2bb88663be46f09236d4da01881812da4ddd4cc4cabf802e1729",
}


@pytest.mark.parametrize("workload,seed", sorted(DIGESTS))
def test_streams_are_the_bytes_they_were(tiny_root, workload, seed):
    cell = manifest.Cell(workload, tiny_root)
    streams = content.make(cell.config, cell.traffic, seed, root=tiny_root)
    assert _digest(streams) == DIGESTS[workload, seed]
