"""The port's span recorder (iamf_tpu_torch/utils/trace.py): off, it records
nothing and hands out one shared no-op; on (enable() or an active
torch.profiler) its spans carry their parent, request and thread; it keeps
at most MAX_RECORDS. The decoders' spans fire on the CPU twins of the
fleet, the serial decoder and the sharded decoder, and the PCM is the same
bit for bit with the recorder on and off."""

import collections
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from iamf_tpu_torch.api import IAMFDecoder
from iamf_tpu_torch.constants import ChannelLayout
from iamf_tpu_torch.core.serving import MultiStreamServer
from iamf_tpu_torch.parallel.sharded_decoder import ShardedStreamDecoder
from iamf_tpu_torch.tools import streams
from iamf_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "iamf_tpu", "data", "sample_opus_714.iamf")


@pytest.fixture(autouse=True)
def fresh_recorder():
    was = trace._forced
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(was)
    trace.reset()


def _names(recs) -> collections.Counter:
    return collections.Counter(r.name for r in recs)


def test_off_records_nothing_and_shares_one_noop():
    a, b = trace.span("front.parse"), trace.span("plan.put")
    assert a is b is trace._OFF
    with a:
        with b:
            trace.count("h2d_bytes", 10)
    assert trace.records() == [] and trace.counters() == {}


def test_enabled_spans_link_parent_request_and_thread():
    trace.enable(True)
    with trace.span("root"):
        with trace.span("child"):
            with trace.span("grandchild"):
                pass
        with trace.span("child"):
            pass
    with trace.span("next_root"):
        pass

    def worker():
        with trace.span("worker_root"):
            with trace.span("worker_child"):
                pass

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    trace.count("h2d_bytes", 5)
    trace.count("h2d_bytes", 7)
    recs = {r.name: r for r in trace.records()}
    assert len(trace.records()) == 7
    root = recs["root"]
    assert root.parent is None and root.request == root.id
    kids = [r for r in trace.records() if r.name == "child"]
    assert all(k.parent == root.id and k.request == root.id for k in kids)
    g = recs["grandchild"]
    assert g.parent == kids[0].id and g.request == root.id
    assert recs["next_root"].parent is None
    assert recs["next_root"].request == recs["next_root"].id != root.id
    main = threading.get_ident()
    assert {r.thread for r in trace.records()
            if not r.name.startswith("worker")} == {main}
    w, wc = recs["worker_root"], recs["worker_child"]
    assert w.thread == wc.thread == t.ident != main
    assert w.parent is None and wc.parent == w.id and wc.request == w.id
    for r in trace.records():
        assert r.start_ns <= r.end_ns
    assert root.start_ns <= g.start_ns <= g.end_ns <= root.end_ns
    assert trace.counters() == {"h2d_bytes": 12}
    assert len(trace.records()) == 7  # records() keeps them
    trace.reset()
    assert trace.records() == [] and trace.counters() == {}


def test_an_active_profiler_turns_recording_on():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(4).sum()
            trace.count("h2d_bytes", 3)
    with trace.span("after"):
        pass
    recs = trace.records()
    assert [r.name for r in recs] == ["inner", "outer"]
    assert recs[0].parent == recs[1].id == recs[0].request
    assert trace.counters() == {"h2d_bytes": 3}
    # a span is no record_function range: the profiler does not see it
    assert not {"inner", "outer"} & {e.name for e in prof.events()}


def test_exception_inside_a_span_closes_it():
    trace.enable(True)
    with pytest.raises(ValueError):
        with trace.span("failing"):
            raise ValueError("x")
    with trace.span("later"):
        pass
    recs = {r.name: r for r in trace.records()}
    assert recs["failing"].parent is None and recs["later"].parent is None


def test_cap_drops_and_counts(monkeypatch):
    assert trace.MAX_RECORDS == 2 ** 20
    monkeypatch.setattr(trace, "MAX_RECORDS", 4)
    trace.enable(True)
    for _ in range(7):
        with trace.span("s"):
            pass
    assert len(trace.records()) == 4
    assert trace.counters() == {"trace.dropped": 3}


def test_spanned_wraps_each_call():
    trace.enable(True)

    @trace.spanned("plan.launch")
    def f(x, y=1):
        """doc"""
        with trace.span("inside"):
            return x + y

    assert f(1, y=2) == 3 and f.__name__ == "f" and f.__doc__ == "doc"
    trace.enable(False)
    assert f(2) == 3
    recs = trace.records()
    assert [r.name for r in recs] == ["inside", "plan.launch"]
    assert recs[0].parent == recs[1].id


CHILD = r"""
import sys
sys.modules["jax"] = None
sys.modules["iamf_tpu"] = None
sys.path.insert(0, sys.argv[1])
from iamf_tpu_torch.utils import trace
with trace.span("a"):
    pass
assert [r.name for r in trace.records()] == ["a"], trace.records()
assert not any(m.split(".")[0] in ("jax", "iamf_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("TRACE-OK")
"""


def test_env_turns_recording_on_without_jax():
    """IAMF_TRACE=1 at import records; the recorder imports neither JAX
    nor iamf_tpu."""
    env = dict(os.environ, IAMF_TRACE="1")
    r = subprocess.run([sys.executable, "-c", CHILD, ROOT], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "TRACE-OK" in r.stdout


def _twice(fn):
    """fn() with the recorder off, then on: both results and the spans."""
    off = fn()
    assert trace.records() == []
    trace.enable(True)
    on = fn()
    trace.enable(False)
    return off, on, trace.records()


def test_fleet_spans_and_pcm_unchanged():
    fleet = [streams.build_pcm_layout_stream(
        ChannelLayout.L714, n_frames=9, frame_size=960, seed=s)[0]
        for s in range(2)]

    def decode():
        srv = MultiStreamServer(fleet, device="cpu", sound_system=9,
                                batch_frames=4)
        return [torch.cat(o).numpy() for o in srv.decode_all()]

    off, on, recs = _twice(decode)
    for a, b in zip(off, on):
        assert np.array_equal(a, b)
    n = _names(recs)
    assert n["front.construct"] == 2
    for name in ("front.parse", "front.elements", "front.timeline",
                 "plan.build"):
        assert n[name] == 2, n
    # one bucket: one fill, one copy and one launch a call, one sync
    assert n["plan.put"] == n["plan.copy"] == n["plan.launch"] >= 3
    assert n["plan.sync"] == 1
    roots = {r.id: r for r in recs if r.name == "front.construct"}
    for r in recs:
        if r.name.startswith("front.") and r.name != "front.construct":
            assert r.parent in roots and r.request == r.parent
    # the staging buffers of every call: [S, B, 12] int16 frames of 960
    assert trace.counters()["h2d_bytes"] == n["plan.put"] * 2 * 4 * 960 \
        * 12 * 2


def test_serial_spans_and_pcm_unchanged():
    data = memoryview(open(SAMPLE, "rb").read())
    calls = 6

    def decode():
        dec = IAMFDecoder(device="cpu")
        dec.set_sound_system(9)
        pos = dec.configure(data)
        out = []
        for _ in range(calls):
            n, pcm = dec.decode(data[pos:])
            pos += n
            out.append(pcm)
        return np.concatenate(out)

    off, on, recs = _twice(decode)
    assert np.array_equal(off, on)
    roots = [r for r in recs if r.name == "serial.decode"]
    assert len(roots) == calls and all(r.parent is None for r in roots)
    for root in roots:
        kids = _names(r for r in recs
                      if r.request == root.id and r is not root)
        assert set(kids) == {"serial.codec", "serial.render",
                             "serial.limit"}
        assert kids["serial.codec"] == 1 and kids["serial.limit"] == 1
    assert all(r.parent is not None for r in recs
               if r.name != "serial.decode")


def test_sharded_spans_and_pcm_unchanged():
    data = open(SAMPLE, "rb").read()

    def decode():
        return ShardedStreamDecoder(data, n_devices=2, sound_system=9,
                                    device="cpu").decode_all()

    off, on, recs = _twice(decode)
    assert np.array_equal(off, on)
    n = _names(recs)
    assert n["mesh.inputs"] == 1 and n["mesh.hop"] >= 2
    assert n["front.construct"] == 1
