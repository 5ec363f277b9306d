"""The benchmark of iamf_tpu_torch: one cell, one run.

    python3 benchport/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the program (iamf_tpu_torch and
native/). It finds the cell in BENCHMARK.json, makes the cell's streams
from the seed (harness/content.py), builds or loads the kernels (the
program's fixed build directory inside the checkout), warms the cell's
path up once (all of that is set-up), then drives the path for
``--seconds`` (harness/drivers.py), closed loop. With ``--trace 1`` the
window runs under torch.profiler (the serial player's closes at
drivers.CHECK_CALLS calls if that comes first) and the run reports the
cell's per-layer metrics, the device's busy seconds and a breakdown; with
``--trace 0`` its end-to-end metrics. After the window the plain
reference decodes the same inputs and the program's PCM is held to it
(harness/check.py).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with --trace 1), and last the
compared numbers with their limits, which also end standard error. Without
a CUDA device, or with fewer than the cell's cards, it exits with 2 and
prints no result; if JAX, jaxlib, flax or the JAX package iamf_tpu is
loaded once the window has closed, with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "iamf_tpu"}
CACHE = os.path.join(ROOT, ".bench_cache")


class Run:
    """What a metric's reader reads: set-up seconds, the window
    (drivers.Window), the device trace (trace.DeviceTrace, None with
    --trace 0), the cell, its configuration and traffic, and the cards."""

    def __init__(self, cell, setup_s, win, trace, devices):
        self.cell = cell.cell
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.setup_s = setup_s
        self.win = win
        self.trace = trace
        self.devices = devices
        self.symbols: list = []


def _environment(traffic: dict) -> None:
    """Caches in fixed directories of the checkout, transformers kept off
    JAX, and the traffic's own settings (before the program is imported)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    for k, v in traffic.get("env", {}).items():
        os.environ[k] = str(v)


def loaded_forbidden() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv=None, device: str = "cuda", root: str = ROOT) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, HERE)
    sys.path.insert(0, root)
    from harness import manifest

    cell = manifest.Cell(args.workload, root)
    _environment(cell.traffic)

    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count()
                             < cell.cell["chips"]):
        print(f"benchport: {cell.cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible; no result", file=sys.stderr)
        return 2

    from harness import check, content, drivers, trace

    # the content kind and the reference are found by name: a missing file
    # stops the run here, before any set-up work
    manifest.path("content", cell.config["content"]["kind"], root)
    manifest.path("reference", cell.config["reference"], root)
    if device == "cuda":
        from iamf_tpu_torch.kernels import build
        build.load()
    streams = content.make(cell.config, cell.traffic, args.seed,
                           device if device == "cuda" else None, root)
    driver = drivers.MODES[cell.traffic["mode"]](
        cell.config, cell.traffic, streams, args.seed, device)
    driver.warm()
    setup_s = time.perf_counter() - T_START

    dtrace = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            win = driver.run(args.seconds, traced=True)
        dtrace = trace.from_profiler(prof)
        del prof
    else:
        win = driver.run(args.seconds)
    peak = (max(torch.cuda.max_memory_allocated(i)
                for i in range(cell.cell["chips"]))
            if device == "cuda" else 0)
    del driver
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    run = Run(cell, setup_s, win, dtrace, cell.cell["chips"])
    kind = cell.per_layer() if args.trace else cell.end_to_end()
    metrics = {}
    for m in kind:
        v = manifest.Reader(m["name"], root).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    nums = check.numbers(cell.config, cell.traffic, win, args.seed, device,
                         root=root)
    ok, shown = check.verdict(cell.config, nums)
    correct = ok and win.failed == 0

    bad = loaded_forbidden()
    if bad:
        print(f"benchport: the process holds {bad} after the window; no "
              "result", file=sys.stderr)
        return 3

    result = {"correct": bool(correct), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": (torch.cuda.get_device_name(0)
                                  if device == "cuda" else device),
                         "count": cell.cell["chips"],
                         "memory_peak_bytes": int(peak)}}
    if dtrace is not None:
        result["device"]["busy_s"] = dtrace.busy_s(cell.cell["chips"])
        result["device"]["window_s"] = dtrace.window_s
        result["breakdown"] = {"device_ops": dtrace.device_ops(),
                               "idle_gaps": dtrace.idle_gaps()}
    result["checks"] = shown
    # the per-layer host clocks of this window, traced or not: the traced
    # run reports them under the profiler's overhead, the others show it
    host = {m["name"]: manifest.Reader(m["name"], root).read(run)
            for m in cell.per_layer() if m["source"] == "host_clock"}
    if host:
        how = "traced" if args.trace else "untraced"
        print(f"per-layer host clocks ({how}): {host}", file=sys.stderr)
    walls = sorted(b - a for k in ("serve", "decode_call")
                   for a, b in win.spans[k])
    if walls:
        q = [walls[int(f * (len(walls) - 1))] for f in (0, 0.25, 0.5, 0.75,
                                                         1)]
        print(f"{len(walls)} requests' host walls (s): min, quartiles, max "
              f"{[round(x, 4) for x in q]}; window {win.seconds:.3f} s",
              file=sys.stderr)
    print(f"correct {correct}, samples compared {nums.get('samples', 0)}",
          file=sys.stderr)
    for name, c in shown.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
