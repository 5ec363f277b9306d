"""The harness finds what a cell names, and picks up files added beside
the ones it has, with no edit to them."""

import json
import os

from harness import manifest


def test_finds_cell_config_traffic_and_metrics():
    cell = manifest.Cell("binaural714_loud_fleet8")
    assert cell.config["name"] == "pcm714_binaural"
    assert cell.traffic["mode"] == "fleet"
    assert [m["name"] for m in cell.end_to_end()] == ["realtime_x",
                                                      "setup_s"]
    names = {m["name"] for m in cell.per_layer()}
    assert "k8_roofline_pct.fleet" in names
    assert "frame_p95_ms.serial" not in names
    serial = manifest.Cell("opus714_ssJ_serial")
    assert {m["name"] for m in serial.end_to_end()} == {"frame_p50_ms",
                                                         "setup_s"}
    reader = manifest.Reader("k3_roofline_pct.fleet")
    assert "::gain_walk" in reader.symbols


def test_every_metric_and_cell_has_its_files():
    bench = manifest.Cell("opus714_ssJ_serial").bench
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(
            manifest.HERE, "metrics", m["name"], "read.py")), m["name"]
    for w in bench["workloads"]:
        manifest.Cell(w["name"])


def test_added_files_are_picked_up(tiny_root):
    """A new metric, a new kernel-name file of an existing metric and a
    new cell (its traffic file and its BENCHMARK.json entries) need no
    edit to any file the benchmark has."""
    bp = os.path.join(tiny_root, "benchport")
    d = os.path.join(bp, "metrics", "new_metric.fleet")
    os.makedirs(os.path.join(d, "kernels"))
    with open(os.path.join(d, "read.py"), "w") as f:
        f.write("def read(run):\n    return 42.0 + len(run.symbols)\n")
    with open(os.path.join(d, "kernels", "one.txt"), "w") as f:
        f.write("::a_kernel\n")
    with open(os.path.join(bp, "metrics", "k1_roofline_pct.fleet",
                           "kernels", "redesign.txt"), "w") as f:
        f.write("::k1_next\n")
    with open(os.path.join(bp, "traffic", "fleet5.json"), "w") as f:
        json.dump({"mode": "fleet", "streams": 5, "units": [16, 24]}, f)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["workloads"].append({"name": "opus714_ssJ_fleet5",
                               "config": "opus714_ssJ",
                               "traffic": "fleet5", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("opus714_ssJ_fleet5")
    bench["per_layer"].append({"name": "new_metric.fleet", "unit": "x",
                               "better": "higher", "source": "host_clock",
                               "layer": "front end", "moves": "realtime_x"})
    json.dump(bench, open(path, "w"))

    cell = manifest.Cell("opus714_ssJ_fleet5", tiny_root)
    assert cell.traffic["streams"] == 5
    assert "new_metric.fleet" in {m["name"] for m in cell.per_layer()}
    assert {m["name"] for m in cell.end_to_end()} == {"realtime_x",
                                                       "setup_s"}

    class Run:
        symbols = []

    assert manifest.Reader("new_metric.fleet", tiny_root).read(Run()) == 43
    k1 = manifest.Reader("k1_roofline_pct.fleet", tiny_root)
    assert "::k1_next" in k1.symbols and "::k1_product" in k1.symbols
