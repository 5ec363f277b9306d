"""Shared set-up of the benchmark's own tests: the harness, the reference
and the program importable, and a checkout-like root of tiny cells."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


# an Opus fleet, which BENCHMARK.json leaves out until its spread meets
# the bound: the harness keeps its path (the Opus fleet's traffic, the K1
# and K2 rooflines), and the tiny root adds it as a later cell would, by
# data alone
OPUS_FLEET = "opus714_ssJ_fleet2"


def _add_opus_fleet(dst: str) -> None:
    with open(os.path.join(dst, "benchport", "traffic", "fleet2.json"),
              "w") as f:
        json.dump({"mode": "fleet", "streams": 2, "units": [16, 24],
                   "env": {"IAMF_OPUS_THREADS": "1"}}, f)
    path = os.path.join(dst, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["workloads"].insert(0, {"name": OPUS_FLEET, "config": "opus714_ssJ",
                                  "traffic": "fleet2", "chips": 1,
                                  "why": "the Opus fleet, tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "binaural714_loud_fleet8" in m.get("workloads", []):
            m["workloads"].append(OPUS_FLEET)
    for k in ("k1", "k2"):
        bench["per_layer"].append({
            "name": f"{k}_roofline_pct.fleet", "unit": "%",
            "better": "higher", "source": "device_trace", "layer": "kernels",
            "moves": "realtime_x", "workloads": [OPUS_FLEET]})
    json.dump(bench, open(path, "w"))


# the four-card long stream, out of BENCHMARK.json until its spread meets
# the bound and a check can afford its sets: the harness keeps its path
# (its traffic and readers), and the tiny root adds it back by data alone
SHARDED = "opus714_long_sharded4"


def _add_sharded(dst: str) -> None:
    path = os.path.join(dst, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["workloads"].append({"name": SHARDED, "config": "opus714_ssJ",
                               "traffic": "long_sharded4", "chips": 4,
                               "why": "one long stream over 4 cards, tiny"})
    e2e = {"name": "stream_realtime_x", "unit": "x", "better": "higher",
           "bound": 0.25, "source": "host_clock", "workloads": [SHARDED]}
    bench["end_to_end"].insert(-1, e2e)
    for name, source, layer in [
            ("construct_ms_per_s.sharded", "host_clock", "front end"),
            ("device_idle_pct.sharded", "device_trace", "device"),
            ("inputs_ms_per_s.sharded", "host_clock", "mesh"),
            ("mesh_ms_per_s.sharded", "host_clock", "mesh"),
            ("idle_inputs_pct.sharded", "device_trace", "device")]:
        bench["per_layer"].append({
            "name": name, "unit": "%" if "pct" in name else "ms/s",
            "better": "lower", "source": source, "layer": layer,
            "moves": "stream_realtime_x", "workloads": [SHARDED]})
    json.dump(bench, open(path, "w"))


def make_root(dst: str) -> str:
    """A copy of BENCHMARK.json and the benchmark's files under `dst`, its
    cells cut to CPU size: fleets of two streams of 16-24 units, batches
    of 8 frames, a serial stream of 400 units, a sharded one of 40; and
    a tiny Opus fleet cell."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    for d in ("configs", "traffic", "metrics", "data", "content",
              "reference"):
        shutil.copytree(os.path.join(BENCH, d),
                        os.path.join(dst, "benchport", d))
    for name in os.listdir(os.path.join(dst, "benchport", "configs")):
        path = os.path.join(dst, "benchport", "configs", name)
        cfg = json.load(open(path))
        cfg["decoder"]["batch_frames"] = 8
        json.dump(cfg, open(path, "w"))
    for name in os.listdir(os.path.join(dst, "benchport", "traffic")):
        path = os.path.join(dst, "benchport", "traffic", name)
        t = json.load(open(path))
        if t["mode"] == "fleet":
            t.update(streams=2, units=[16, 24])
        elif t["mode"] == "serial":
            t.update(units=400)
        else:
            t.update(units=40)
        json.dump(t, open(path, "w"))
    _add_opus_fleet(dst)
    _add_sharded(dst)
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(str(tmp_path))
