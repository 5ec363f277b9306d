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


def make_root(dst: str) -> str:
    """A copy of BENCHMARK.json and the benchmark's files under `dst`, its
    cells cut to CPU size: fleets of two streams of 16-24 units, batches
    of 8 frames, a serial stream of 400 units, a sharded one of 40; and
    a tiny Opus fleet cell."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    for d in ("configs", "traffic", "metrics", "data"):
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
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(str(tmp_path))
