"""Everything a run finds by name: the cell in BENCHMARK.json, its
configuration and traffic files, and the readers of its metrics.

- A configuration is the ``file`` that BENCHMARK.json's ``configs`` entry
  names.
- A traffic mix is ``benchport/traffic/<traffic>.json``.
- A metric (end-to-end or per-layer) is ``benchport/metrics/<name>/``:
  ``read.py`` defines ``read(run)``, which returns the metric's value or
  None where the run has nothing for it to read; the kernels whose device
  time a roofline share reads are the names, one a line, in the files
  under its ``kernels/`` (a new implementation of the function adds a
  file there).
- A content kind (a configuration's ``content.kind``) is
  ``benchport/content/<kind>.py``, and a configuration's plain reference
  (its ``reference``) is ``benchport/reference/<name>.py``: what each
  defines is in harness/content.py and reference/__init__.py.
A cell reports an end-to-end metric where the metric lists the cell under
``workloads``, or lists none; a per-layer metric where it lists the cell,
or lists none and the cell reports the end-to-end metric it moves.
"""

from __future__ import annotations

import functools
import glob
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "benchport")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def path(sub: str, name: str, root: str = ROOT) -> str:
    """``benchport/<sub>/<name>.py`` under `root`; a missing file stops
    the run, naming the path looked for."""
    p = os.path.join(root, "benchport", sub, f"{name}.py")
    if not os.path.isfile(p):
        raise SystemExit(f"benchport: no {sub} {name!r}: {p} is not there")
    return p


def _exec(name: str, p: str):
    spec = importlib.util.spec_from_file_location(name, p)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def load(sub: str, name: str, root: str = ROOT):
    """The module at path(sub, name, root), as ``<sub>.<name>``, so that
    its relative imports find the package <sub> on the path; run once a
    process for each (sub, name, root)."""
    return _exec(f"{sub}.{name}", path(sub, name, root))


class Cell:
    def __init__(self, name: str, root: str = ROOT):
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.cell = cells[name]
        self.name = name
        cfgs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(os.path.join(
            root, cfgs[self.cell["config"]]["file"]))
        self.traffic = load_json(os.path.join(
            root, "benchport", "traffic", f"{self.cell['traffic']}.json"))

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


class Reader:
    """A metric's reader and its kernel names."""

    def __init__(self, name: str, root: str = ROOT):
        d = os.path.join(root, "benchport", "metrics", name)
        self.module = _exec(f"benchport_metric_{name.replace('.', '_')}",
                            os.path.join(d, "read.py"))
        self.symbols = []
        for txt in sorted(glob.glob(os.path.join(d, "kernels", "*.txt"))):
            with open(txt) as f:
                self.symbols += [s.strip() for s in f if s.strip()]

    def read(self, run):
        run.symbols = self.symbols
        return self.module.read(run)
