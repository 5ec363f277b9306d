"""The readers of the program's spans (harness/spans.py and the metrics
that use it): the clock fit, idle intervals put down to the innermost
main-thread span, and every new reader on the tiny CPU cells."""

import ast
import json
import sys
import threading

import numpy as np
import pytest

import run as bench_run
from harness import spans
from harness.drivers import Window
from harness.trace import DeviceTrace

from conftest import OPUS_FLEET  # noqa: F401 (the tiny root's cells)

A_US, B = 1234.5, 1.0e6 * (1 + 3e-5)  # offset and drift of the fake clock


class FakeRec:
    """A recorder holding given spans."""

    def __init__(self, recs, counters=None):
        self.recs, self.cnt = recs, counters or {}

    def records(self):
        return list(self.recs)

    def counters(self):
        return dict(self.cnt)


class FakeRun:
    def __init__(self, win, trace):
        self.win, self.trace = win, trace


def _span(name, a_s, b_s, sid, parent=None, request=None, thread=1):
    from iamf_tpu_torch.utils.trace import Span

    return Span(name, int(a_s * 1e9), int(b_s * 1e9), thread, sid, parent,
                request if request is not None else sid)


def _dev(t):
    return A_US + B * (t - 100.0)


def _fake(ops, jitter_us=0.0, pairs=3):
    """A window of `pairs` constructor/serve pairs at perf_counter 100.0 s
    on, its ranges on the device clock (a jitter of +-jitter_us on
    alternate edges), and device ops at the given perf_counter times."""
    win = Window()
    t = 100.0
    ranges = []
    for k in range(pairs):
        for name, d in (("constructor", 0.3), ("serve", 0.2)):
            win.spans[name].append((t, t + d))
            j = jitter_us if k % 2 else -jitter_us
            ranges.append((name, _dev(t) + j, _dev(t + d) - j))
            t += d
    win.audio_s = 10.0
    dops = [("k", _dev(a), _dev(b), d) for a, b, d in ops]
    return FakeRun(win, DeviceTrace(dops, ranges))


def test_fit_recovers_offset_and_drift(capsys):
    run = _fake([(100.05, 100.06, 0)], jitter_us=2.0)
    fit = spans.clock_fit(run)
    assert fit.pairs == 12 and fit.dropped == 0
    assert fit.us(100.0) == pytest.approx(A_US, abs=3.0)
    assert fit.b == pytest.approx(B, rel=1e-6)
    assert 1.0 <= fit.median_us <= 2.5 and fit.max_us <= 3.0
    assert "clock fit" in capsys.readouterr().err
    assert spans.clock_fit(run) is fit  # once a run


def test_fit_separates_edges_and_drops_a_pause():
    """Ranges entered 30 us after the host clock and left 20 us before it;
    one start edge 2 ms late (a pause): the edges' offsets apart, the
    pause dropped, the time mapped within the offsets' half-difference."""
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(100.0, 150.0, 400))
    end = np.tile([0, 1], 200)
    y = _dev(x) + np.where(end == 1, -20.0, 30.0) + rng.normal(0, 1.0, 400)
    y[10 * 2] += 2000.0
    fit = spans.Fit(x, y, end)
    assert fit.dropped == 1 and fit.max_all_us > 1900
    assert fit.c == pytest.approx(-50.0, abs=1.0)
    assert fit.median_us < 1.5 and fit.max_us < 6.0
    assert fit.us(120.0) == pytest.approx(_dev(120.0) + 5.0, abs=1.0)


def test_idle_goes_to_the_innermost_main_thread_span(monkeypatch):
    # device 0 busy in [100.10, 100.20] and [100.40, 100.45]: idle
    # [100.0, 100.10), (100.20, 100.40), (100.45, 101.5]
    run = _fake([(100.10, 100.20, 0), (100.40, 100.45, 0),
                 (100.0, 101.5, 1)])
    main = 7
    recs = [
        _span("front.construct", 100.0, 100.3, 1, thread=main),
        _span("front.parse", 100.05, 100.15, 2, 1, 1, thread=main),
        _span("other.child", 100.25, 100.28, 3, 1, 1, thread=main),
        _span("plan.put", 100.3, 100.5, 4, thread=main),
        # a worker's span over the idle time: ignored
        _span("front.elements", 100.30, 100.5, 5, thread=8),
        # outside the window: ignored
        _span("front.parse", 99.0, 99.5, 6, thread=main),
    ]
    monkeypatch.setattr(spans, "recorder", lambda: FakeRec(recs))
    under = spans.idle_under(run, "front.", thread=main)
    # front.construct's own time less other.child, and front.parse, where
    # device 0 is idle: [100.0, 100.10) and (100.20, 100.25), (100.28,
    # 100.30)
    assert under == pytest.approx(0.10 + 0.05 + 0.02, abs=1e-5)
    assert spans.idle_under(run, "front.parse", thread=main) == \
        pytest.approx(0.05, abs=1e-5)
    assert spans.idle_under(run, "plan.put", thread=main) == \
        pytest.approx(0.10 + 0.05, abs=1e-5)
    assert spans.idle_under(run, "serial.", thread=main) is None


def test_h2d_rate_times_the_copies_inside_plan_copy(monkeypatch):
    """Only the host-to-device copies whose middle lies in a main-thread
    plan.copy span count: 3 MB over 0.006 + 0.003 s of copies there."""
    run = _fake([])
    run.trace.ops = [
        ("Memcpy HtoD (Pinned -> Device)", _dev(100.010), _dev(100.016), 0),
        ("Memcpy HtoD (Pinned -> Device)", _dev(100.040), _dev(100.043), 0),
        # the constructor's upload, a kernel, a copy back: not the puts'
        ("Memcpy HtoD (Pageable -> Device)", _dev(100.2), _dev(100.25), 0),
        ("k3_walk", _dev(100.011), _dev(100.015), 0),
        ("Memcpy DtoH (Device -> Pinned)", _dev(100.041), _dev(100.042), 0)]
    main = threading.main_thread().ident
    recs = [_span("plan.copy", 100.0, 100.017, 1, thread=main),
            _span("plan.copy", 100.03, 100.044, 2, thread=main),
            _span("plan.copy", 100.19, 100.21, 3, thread=main + 1)]
    monkeypatch.setattr(spans, "recorder", lambda: FakeRec(
        recs, {"h2d_bytes": 3_000_000}))
    assert spans.h2d_gbps(run) == pytest.approx(3e6 / 0.009 / 1e9, rel=1e-3)
    monkeypatch.setattr(spans, "recorder", lambda: FakeRec(recs))
    assert spans.h2d_gbps(run) is None  # nothing counted


def test_dropped_edges_read_as_pauses(monkeypatch, capsys):
    """A start edge late and an end edge early, each alone: named so, and
    the idle reading given on the fit over all edges beside it."""
    run = _fake([(100.10, 100.20, 0)], jitter_us=1.0, pairs=20)
    for k, shift in ((0, 800.0), (3, -900.0)):
        name, a, b = run.trace.ranges[k // 2]
        run.trace.ranges[k // 2] = (
            name, a + (shift if k % 2 == 0 else 0),
            b + (shift if k % 2 else 0))
    fit = spans.clock_fit(run)
    err = capsys.readouterr().err
    assert fit.dropped == 2
    assert "1 start edges, 1 of them late; 1 end edges, 1 of them early; " \
        "2 with the range's other edge kept" in err
    every = spans.clock_fit(run, drop=False)
    assert every.dropped == 0 and every.max_all_us == every.max_us
    monkeypatch.setattr(spans, "recorder", lambda: FakeRec(
        [_span("front.parse", 100.0, 100.3, 1,
               thread=threading.main_thread().ident)]))
    assert spans.idle_pct(run, "front.") == pytest.approx(
        100 * 0.2 / run.trace.window_s, rel=1e-3)
    assert "on the fit over all edges" in capsys.readouterr().err


def test_idle_needs_device_work(monkeypatch):
    run = _fake([(100.10, 100.20, 1)])  # nothing on device 0
    monkeypatch.setattr(spans, "recorder", lambda: FakeRec(
        [_span("front.parse", 100.0, 100.1, 1)]))
    assert spans.idle_under(run, "front.", thread=1) is None


def test_per_call_groups_by_request(monkeypatch):
    run = _fake([])
    recs = [_span("serial.decode", 100.0, 100.01, 1),
            _span("serial.codec", 100.0, 100.004, 2, 1, 1),
            _span("serial.codec", 100.005, 100.006, 3, 1, 1),
            _span("serial.decode", 100.1, 100.12, 4),
            _span("serial.codec", 100.1, 100.103, 5, 4, 4),
            _span("serial.decode", 100.2, 100.21, 6)]
    monkeypatch.setattr(spans, "recorder", lambda: FakeRec(recs))
    # calls: 5 ms, 3 ms, 0 ms
    assert spans.per_call_ms_p50(run, "serial.codec") == \
        pytest.approx(3.0, abs=1e-6)
    assert spans.per_call_ms_p50(run, "serial.limit") is None
    assert spans.ms_per_s(run, "serial.codec") == \
        pytest.approx(8.0 / 10.0, abs=1e-6)


NEW = {
    "binaural714_loud_fleet8": [
        "parse_ms_per_s.fleet", "elements_ms_per_s.fleet",
        "timeline_ms_per_s.fleet", "plan_ms_per_s.fleet",
        "put_ms_per_s.fleet", "put_gbps.fleet", "launch_ms_per_s.fleet",
        "sync_ms_per_s.fleet", "idle_front_pct.fleet",
        "copy_ms_per_s.fleet"],
    "opus714_ssJ_serial": [
        "codec_ms_p50.serial", "render_ms_p50.serial",
        "limit_ms_p50.serial", "idle_codec_pct.serial"],
    "opus714_long_sharded4": [
        "inputs_ms_per_s.sharded", "mesh_ms_per_s.sharded",
        "idle_inputs_pct.sharded"],
}


def _run(root, workload, trace, capsys):
    rc = bench_run.main(["--workload", workload, "--seed", "3000000017",
                         "--seconds", "0.5", "--trace", str(trace)],
                        device="cpu", root=root)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    host = {}
    for line in out.err.splitlines():
        if line.startswith("per-layer host clocks"):
            host = ast.literal_eval(line.split(": ", 1)[1])
    return json.loads(out.out.strip().splitlines()[-1]), host


@pytest.mark.parametrize("workload", sorted(NEW))
def test_new_readers_on_the_tiny_cells(tiny_root, capsys, workload):
    from harness import manifest
    from iamf_tpu_torch.utils import trace

    names = {m["name"] for m in manifest.Cell(workload,
                                              tiny_root).per_layer()}
    assert set(NEW[workload]) <= names
    trace.reset()
    res, _ = _run(tiny_root, workload, 1, capsys)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in NEW[workload]:
        if name.startswith("idle_") or name == "put_gbps.fleet":
            # device 0's idle time and copies: a card's trace only
            assert name not in m
        else:
            assert m[name] > 0, name
    if workload == "binaural714_loud_fleet8":
        front = sum(m[f"{k}_ms_per_s.fleet"]
                    for k in ("parse", "elements", "timeline"))
        assert front <= m["construct_ms_per_s.fleet"]
        plans = sum(m[f"{k}_ms_per_s.fleet"]
                    for k in ("plan", "put", "copy", "launch", "sync"))
        assert plans <= m["serve_ms_per_s.fleet"]
    if workload == "opus714_ssJ_serial":
        # each call's parts inside its root span
        recs = trace.records()
        roots = {r.id: r for r in recs if r.name == "serial.decode"}
        inside = dict.fromkeys(roots, 0)
        for r in recs:
            if r.name in ("serial.codec", "serial.render", "serial.limit"):
                inside[r.request] += r.end_ns - r.start_ns
        assert roots and all(inside[i] <= r.end_ns - r.start_ns
                             for i, r in roots.items())
    # untraced: the recorder is off, every new reader gives None
    trace.reset()
    _, host = _run(tiny_root, workload, 0, capsys)
    for name in NEW[workload]:
        assert host.get(name) is None, name
    assert trace.records() == []


def test_readers_without_the_recorder(tiny_root, capsys, monkeypatch):
    """On a program without iamf_tpu_torch.utils.trace (the parent of the
    recorder) the traced run still ends, without the new metrics."""
    import iamf_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "iamf_tpu_torch.utils.trace", None)
    monkeypatch.delattr(iamf_tpu_torch.utils, "trace", raising=False)
    assert spans.recorder() is None
    res, _ = _run(tiny_root, "opus714_ssJ_serial", 1, capsys)
    assert res["correct"] is True
    assert not set(NEW["opus714_ssJ_serial"]) & set(res["metrics"])
    assert "frame_p95_ms.serial" in res["metrics"]


def test_fit_needs_pairs():
    win = Window()
    run = FakeRun(win, None)
    assert spans.clock_fit(run) is None
    fit = spans.Fit(np.array([1.0, 2.0, 3.0, 4.0]),
                    np.array([1.0, 2.0, 3.0, 4.0]), np.array([0, 1, 0, 1]))
    assert fit.b == pytest.approx(1.0) and fit.dropped == 0
