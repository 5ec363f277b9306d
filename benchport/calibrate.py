"""The readings the correctness limits are set from, on the card.

    python3 benchport/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--seconds 0]

For each seed, in one process: the cell's streams, one short window of
the timed path at the cell's own load (a fleet: one fleet, which finishes
every stream; the serial cell: --seconds of calls), then
- the program's reading: the run's compared numbers (harness/check.py);
- the control's reading: the same numbers with the reference computed
  with TF32 products (the step below the configuration's float32) put in
  the program's place.
Prints one JSON line a seed and the largest program reading and the
smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_outputs(cfg, traffic, win, seed, device):
    """The window's outputs with the TF32 reference in the program's place
    (for the streams the check compares)."""
    import numpy as np

    from harness import check

    if traffic["mode"] == "sharded":
        return [check.reference_pcm(cfg, win.fleet_streams[0], device=device,
                                    tf32=True)]
    if traffic["mode"] == "fleet":
        outs = list(win.outputs)
        for i in check.sample_streams(win, traffic, seed):
            ref = check.reference_pcm(cfg, win.fleet_streams[i],
                                      device=device, tf32=True)
            outs[i] = np.concatenate(
                [np.zeros((check.DELAY, ref.shape[1]), ref.dtype), ref])
        return outs
    ref = check.reference_pcm(cfg, win.fleet_streams[0], win.units + 1,
                              device=device, tf32=True)
    return ref[:len(win.outputs)]


def main(argv=None, device: str = "cuda") -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--control-seeds", type=int, default=3,
                   help="the first seeds that also read the control")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    from harness import manifest

    cell = manifest.Cell(args.workload)
    for k, v in cell.traffic.get("env", {}).items():
        os.environ[k] = str(v)
    from harness import check, content, drivers

    if device == "cuda":
        from iamf_tpu_torch.kernels import build
        build.load()
    low, high = {}, {}
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        streams = content.make(cell.config, cell.traffic, seed,
                               device if device == "cuda" else None)
        driver = drivers.MODES[cell.traffic["mode"]](
            cell.config, cell.traffic, streams, seed, device)
        if cell.traffic["mode"] == "serial":
            driver.warm()
        win = driver.run(args.seconds)
        del driver
        prog = check.numbers(cell.config, cell.traffic, win, seed, device)
        ctl = {}
        if n < args.control_seeds:
            win.outputs = control_outputs(cell.config, cell.traffic, win,
                                          seed, device)
            ctl = check.output_numbers(cell.config, cell.traffic, win, seed,
                                       device)
        print(json.dumps({"seed": seed, "program": prog, "control": ctl}),
              flush=True)
        for k, v in prog.items():
            low[k] = max(low.get(k, v), v)
        for k, v in ctl.items():
            high[k] = min(high.get(k, v), v)
    print(json.dumps({"workload": args.workload, "lower": low,
                      "control_least": high}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
