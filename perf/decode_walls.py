#!/usr/bin/env python3
"""Single-stream decode walls of one tree on the card, for comparing trees.

    python3 perf/decode_walls.py times [--tree DIR] [--reps N] [--out FILE]
                                       [--fleets | --serial]
    python3 perf/decode_walls.py pairs FILE PARENT CHANGE

Decodes, as chip_smoke.py's decode phases time them (the decoder built
from the stream's bytes, then decode_all(); one warm-up, then N timed
runs), four cells: 30 s of 7.1.4 M2B binaural at batch_frames=128 (K8 and
K3 engaged), the same 30 s of 7.1.4 PCM -> sound system J with
IAMF_TRUEPEAK=1 on chip_smoke's true-peak content (K9 and K3 engaged),
30 s of 7.1.4 PCM -> J (K3 idle), and the Opus sample -> J at
batch_frames=8. Per cell it prints the realtime factor (audio seconds
over the median wall), every wall, the device time of one traced decode
(chip_smoke.trace_decode), and the ten host functions with the most own
time in one decode under cProfile. With --fleets the cells are
chip_smoke.py's three full-width fleets instead, each served by
MultiStreamServer(...).decode_all() (the batches left on the card), its
realtime factor the streams' audio seconds over the wall. With --serial
they are the frame-serial decoder's (api.IAMFDecoder on the card, one
access unit a call, chip_smoke.serial_decode): 30 s of 7.1.4 PCM -> J,
the same through the player's loop (each call given a copy of the rest of
the bytes), 30 s of 7.1.4 M2B binaural, the first 300 access units of
chip_smoke's 30 s AAC-LC content -> J, and the Opus sample -> J.

DIR is a directory holding its own iamf_tpu_torch (e.g. a `git archive`
of the parent commit unpacked under the ignored _chip/); by default this
checkout's. With --out, each cell's walls are appended to FILE as a JSON
line with the tree's label (its directory's name).

Host walls move between calls, so compare two trees only within one
call, in turns, with the side that runs first alternating from pair to
pair. pairs reads FILE and, per cell, sets the k-th run of PARENT beside
the k-th run of CHANGE: each run's median wall, the pairs the change wins
(a lower median), both sides' median of medians and the parent's spread
(the distance between the quartiles of its medians). Needs a CUDA device
and nvcc for times.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import sys

from trees import ROOT, label, smoke


def cells(cs):
    from iamf_tpu_torch.tools import streams

    L714 = streams.ChannelLayout.L714
    n30 = 1500  # 30 s of 960-sample frames
    opus = open(os.path.join(ROOT, "iamf_tpu", "data",
                             "sample_opus_714.iamf"), "rb").read()
    return {
        "binaural 7.1.4 M2B 30 s": (streams.build_pcm_layout_stream(
            L714, n_frames=n30, amp=0.5, hrm=1)[0],
            dict(binaural=True, batch_frames=cs.B_MAIN), False),
        "pcm 7.1.4 30 s true peak -> ssJ": (streams.build_pcm_layout_stream(
            L714, n_frames=n30,
            pcm_override=streams.isp_tone_pcm(n30, 12))[0],
            dict(sound_system=9, batch_frames=cs.B_MAIN), True),
        "pcm 7.1.4 30 s -> ssJ": (streams.build_pcm_layout_stream(
            L714, n_frames=n30, amp=0.5)[0],
            dict(sound_system=9, batch_frames=cs.B_MAIN), False),
        "opus sample -> ssJ": (opus, dict(sound_system=9,
                                          batch_frames=cs.B_OPUS), False),
    }


def fleets(cs):
    from iamf_tpu_torch.tools import streams

    L714 = streams.ChannelLayout.L714
    n30 = 1500
    pcm = [streams.build_pcm_layout_stream(L714, n_frames=n30,
                                           amp=0.2 + 0.1 * s, seed=s)[0]
           for s in range(cs.S_FLEET)]
    binaural = [streams.build_pcm_layout_stream(L714, n_frames=n30,
                                                amp=0.2 + 0.1 * s, seed=s,
                                                hrm=1)[0]
                for s in range(cs.S_FLEET)]
    sample = open(os.path.join(ROOT, "iamf_tpu", "data",
                               "sample_opus_714.iamf"), "rb").read()
    desc, units = streams.split_into_units(sample)
    hetero = [pcm[0], streams.build_pcm_layout_stream(
        L714, n_frames=1100, amp=0.4, seed=7)[0], sample,
        desc + b"".join(units[:12])]
    kw = dict(sound_system=9, batch_frames=cs.B_MAIN)
    return {
        "fleet pcm 4 x 7.1.4 30 s -> ssJ": (pcm, kw, False),
        "fleet binaural 4 x 7.1.4 M2B 30 s": (
            binaural, dict(binaural=True, batch_frames=cs.B_MAIN), False),
        "fleet hetero pcm 30 s + 22 s + opus sample + cut": (hetero, kw,
                                                             False),
    }


def serial_cells(cs):
    from iamf_tpu_torch.tools import streams

    L714 = streams.ChannelLayout.L714
    pcm = streams.build_pcm_layout_stream(L714, n_frames=1500, amp=0.5)[0]
    desc, units = streams.split_into_units(streams.build_aac_layout_stream(
        L714, n_frames=1407, seed=5)[0])
    opus = open(os.path.join(ROOT, "iamf_tpu", "data",
                             "sample_opus_714.iamf"), "rb").read()
    return {
        "serial pcm 7.1.4 30 s -> ssJ": (pcm, dict(ss=9), False),
        "serial pcm 7.1.4 30 s -> ssJ, the player's loop": (
            pcm, dict(ss=9, view=False), False),
        "serial binaural 7.1.4 M2B 30 s": (streams.build_pcm_layout_stream(
            L714, n_frames=1500, amp=0.5, hrm=1)[0], dict(binaural=True),
            False),
        "serial aac 7.1.4 300 units -> ssJ": (
            desc + b"".join(units[:300]), dict(ss=9), False),
        "serial opus sample -> ssJ": (opus, dict(ss=9), False),
    }


def times(args) -> None:
    cs = smoke(args.tree)
    import numpy as np
    from iamf_tpu_torch import require_cuda
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
    from iamf_tpu_torch.kernels import build

    dev = require_cuda()
    build.build()
    name = label(args.tree)
    card = cs.card_line()
    table = (fleets(cs) if args.fleets else serial_cells(cs) if args.serial
             else cells(cs))
    for cell, (data, kw, truepeak) in table.items():
        if truepeak:
            os.environ["IAMF_TRUEPEAK"] = "1"
        try:
            if args.fleets:
                from iamf_tpu_torch.core.serving import MultiStreamServer

                def run():
                    srv = MultiStreamServer(data, device=dev, **kw)
                    srv.decode_all()
                    return srv
            elif args.serial:
                def run():
                    return cs._serial(dev, data, **kw)
            else:
                def run():
                    return BatchedStreamDecoder(data, device=dev,
                                                **kw).decode_all()

            out = run()  # warm-up
            walls = cs.timed(run, args.reps)
            secs = (sum(d.n_frames * d.frame_size - d.lead - d.tail
                        for d in out.decs) if args.fleets
                    else out.shape[0]) / 48000.0
            w = sorted(1e3 * x for x in walls)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps({"tree": name, "cell": cell,
                                        "secs": secs, "walls_ms": w}) + "\n")
            print(f"{name} {cell}: realtime factor "
                  f"{secs / np.median(walls):.2f}x (median of {len(w)}: "
                  f"{np.median(w):.1f} ms; walls {[round(x, 1) for x in w]}"
                  f" ms) [{card}]")
            cs.trace_decode(run, f"{name} {cell}")
            prof = cProfile.Profile()
            prof.enable()
            run()
            prof.disable()
            text = io.StringIO()
            pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(
                10)
            lines = text.getvalue().splitlines()
            head = next(i for i, ln in enumerate(lines) if "ncalls" in ln)
            total = next(ln for ln in lines if "function calls" in ln)
            print(f"{name} {cell}: host profile of one decode "
                  f"({total.strip()}); by own time:")
            for ln in lines[head:head + 11]:
                print(f"  {ln.strip()}")
        finally:
            os.environ.pop("IAMF_TRUEPEAK", None)


def pairs(path: str, parent: str, change: str) -> None:
    import numpy as np

    runs: dict = {}
    for line in open(path):
        r = json.loads(line)
        runs.setdefault(r["cell"], {}).setdefault(r["tree"], []).append(
            float(np.median(r["walls_ms"])))
    for cell, by in runs.items():
        p, c = by.get(parent, []), by.get(change, [])
        n = min(len(p), len(c))
        wins = sum(b < a for a, b in zip(p, c))
        q1, q3 = np.percentile(p, [25, 75])
        mp, mc = np.median(p), np.median(c)
        print(f"{cell}: {n} pairs; {parent} medians {[round(x, 1) for x in p]}"
              f" ms, {change} {[round(x, 1) for x in c]} ms; {change} wins "
              f"{wins} of {n}; median of medians {mp:.1f} against {mc:.1f} ms "
              f"({100 * (mc / mp - 1):+.1f} %); {parent}'s spread (IQR) "
              f"{q3 - q1:.1f} ms")


def main() -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("times")
    t.add_argument("--tree")
    t.add_argument("--reps", type=int, default=9)
    t.add_argument("--out")
    t.add_argument("--fleets", action="store_true")
    t.add_argument("--serial", action="store_true")
    pa = sub.add_parser("pairs")
    pa.add_argument("file")
    pa.add_argument("parent")
    pa.add_argument("change")
    args = ap.parse_args()
    if args.cmd == "times":
        times(args)
    else:
        pairs(args.file, args.parent, args.change)
    return 0


if __name__ == "__main__":
    sys.exit(main())
