#!/usr/bin/env python3
"""K7 and K9 of one tree on the card, on chip_smoke.py's inputs.

    python3 perf/k7_k9.py times [--tree DIR]
    python3 perf/k7_k9.py compare LABEL_A LABEL_B
    python3 perf/k7_k9.py sweep

times builds the tree's kernels (DIR's own iamf_tpu_torch, e.g. a
`git archive` of the parent commit unpacked under the ignored _chip/; by
default this checkout's) and prints, for K7 at B=128 and B=8
(chip_smoke.k7_inputs) and K9 at [12, 122,880] and [2, 122,880]
(chip_smoke.k9_inputs), the ms per call (CUDA events over 20 calls) and
the device ms per call (torch.profiler: every kernel of the call) with
the number of device launches, and the ms per call of 50 calls queued
back to back behind a spin kernel (CUDA events). It keeps the outputs in
perf/build/k7_k9_<label>.pt, the label being the tree's directory name.

compare prints, between two labels' outputs, torch.equal and the max
|diff| of each (K7's PCM in s16 LSBs and its carry; K9's peaks and
history).

sweep times this checkout's K7 for each run length a warp may take
(synthesize_cuda's run=; the outputs must be equal), samples the SM
clock while K9 runs back to back, and times K9 built in other tilings
(samples a lane, warps a CTA; a copy of csrc/truepeak.cu), whose outputs
must equal the first build's, and with parts of its work cut out (its
FIR, its loads after the first channel), with each build's fp32
multiplies and adds and local memory instructions in its SASS.

To compare two trees on one card, run them in turns in one call:
parent, change, change, parent, then compare. Needs a CUDA device and
nvcc. Builds go to each tree's own ignored build directory.
"""

from __future__ import annotations

import argparse
import sys

from trees import ROOT, compare, label, save, smoke, use_source

# K9 builds for sweep: (samples a lane, warps a CTA)
K9_TILINGS = [(4, 2), (8, 2), (4, 1), (4, 4)]
# K9 with a part of its work cut out (a diagnostic: the peaks are wrong)
K9_CUTS = [
    ("no FIR", [("for (int k0 = 0; k0 < SPT; k0 += KB) meter<KB>(w, k0, mx);",
                 "for (int k = 0; k < SPT; ++k) mx[k] = fmaxf(mx[k], "
                 "fabsf(w[OFF + k]));")]),
    ("no loads after the first", [(
        "if (c + G < C) load_window(x, hist, N, c + G, t, nxt);",
        "for (int m = 0; m < WIN; ++m) nxt[m] = w[m] * 0.5f + c;")]),
]


def _time(cs, name, fn, card):
    ms = cs.cuda_ms(fn)
    q_ms = cs.queued_ms(fn)
    dev_ms, _ = cs.device_ms(fn, name)
    print(f"{name}: {ms:.4f} ms per call, device {dev_ms:.4f} ms in "
          f"{cs.device_launches(fn)} launches (a captured graph's kernel "
          f"nodes), {q_ms:.4f} ms queued back to back (CUDA events) "
          f"[{card}]")


def times(cs, tree: str) -> None:
    import torch
    from iamf_tpu_torch.codecs.aac import synth as aac
    from iamf_tpu_torch.dsp import limiter

    dev = torch.device("cuda")
    name = label(tree)
    card = cs.card_line()
    tabs = aac.Tables().to(dev)
    out = {}
    for B in (cs.B_MAIN, cs.B_OPUS):
        spec, meta, carry = cs.k7_inputs(B, dev, 10 * B)

        def k7():
            return aac.synthesize_cuda(tabs, spec, meta, carry)

        out[f"k7_b{B}"] = [t.cpu() for t in k7()]
        _time(cs, f"{name} K7 [B={B}, L={cs.LANES}]", k7, card)
    for C in (cs.LANES, 2):
        hist, xs = cs.k9_inputs(C, dev)

        def k9():
            return limiter.truepeak_cuda(xs[0], hist)

        out[f"k9_c{C}"] = [t.cpu() for t in k9()]
        _time(cs, f"{name} K9 [C={C}, N={xs[0].shape[-1]}]", k9, card)
    save(out, "k7_k9", tree)


def describe(key: str, diffs: list) -> str:
    if key.startswith("k7"):
        return (f"PCM {diffs[0] * 32768:.0f} LSB, carry {diffs[1]:.3e} at "
                "s16 scale")
    return f"peaks {diffs[0]:.3e}, history {diffs[1]:.3e}"


def with_constants(src: str, **values) -> str:
    """src with each `constexpr <type> NAME = ...;` set to values[NAME]."""
    for name, v in values.items():
        hits = [t for t in ("int", "bool") if f"constexpr {t} {name} = "
                in src]
        assert len(hits) == 1, name
        a = f"constexpr {hits[0]} {name} = "
        assert src.count(a) == 1, a
        v = str(v).lower() if isinstance(v, bool) else v
        src = src.replace(a, f"constexpr {hits[0]} {name} = {v}; //")
    return src


def clocks(cs, fn, secs: float = 2.0) -> None:
    """The SM clock and power that nvidia-smi samples while fn runs back
    to back for `secs`."""
    import subprocess
    import time

    import torch

    mon = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader", "-lms", "200"], stdout=subprocess.PIPE,
        text=True)
    t = time.perf_counter()
    while time.perf_counter() - t < secs:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
    mon.terminate()
    samples = mon.communicate()[0].strip().splitlines()
    print(f"nvidia-smi while it runs: {'; '.join(samples[-5:])}")


def sweep(cs) -> None:
    import torch
    from iamf_tpu_torch.codecs.aac import synth as aac
    from iamf_tpu_torch.dsp import limiter
    from iamf_tpu_torch.kernels import build

    dev = torch.device("cuda")
    card = cs.card_line()
    tabs = aac.Tables().to(dev)
    fill = aac.k7_fill(dev)
    for B in (cs.B_MAIN, cs.B_OPUS):
        spec, meta, carry = cs.k7_inputs(B, dev, 10 * B)
        y0 = None
        for run in (1, 2, 3, 4, 8):
            if run > B:
                continue

            def k7():
                return aac.synthesize_cuda(tabs, spec, meta, carry, run=run)

            y, c = k7()
            y0 = (y, c) if y0 is None else y0
            same = torch.equal(y, y0[0]) and torch.equal(c, y0[1])
            _time(cs, f"K7 [B={B}] run {run} ({cs.LANES * -(-B // run)} "
                  f"warps; default {aac.k7_run(B, cs.LANES, fill)}; equal: "
                  f"{same})", k7, card)
            assert same, run
    src = (ROOT / "iamf_tpu_torch" / "csrc" / "truepeak.cu").read_text()
    ins = {C: cs.k9_inputs(C, dev) for C in (cs.LANES, 2)}
    hist, xs = ins[cs.LANES]
    print(f"K9 [C={cs.LANES}] as built, run back to back:")
    clocks(cs, lambda: limiter.truepeak_cuda(xs[0], hist))
    versions = [(f"SPT {spt}, {wpc} warps a CTA",
                 with_constants(src, SPT=spt, WPC=wpc), True)
                for spt, wpc in K9_TILINGS]
    for cut, subs in K9_CUTS:
        text = src
        for a, b in subs:
            assert text.count(a) == 1, a
            text = text.replace(a, b)
        versions.append((cut, text, False))
    ref = {}
    for i, (label, text, whole) in enumerate(versions):
        lib = use_source(build, limiter.K9, f"k9_{i}", "truepeak.cu", text)
        sass = cs.sass_counts(lib, "k9_truepeak",
                              ("LDL", "STL", "FMUL", "FADD", "FFMA"))
        for C, (hist, xs) in ins.items():

            def k9():
                return limiter.truepeak_cuda(xs[0], hist)

            pk, h = k9()
            ref.setdefault(C, (pk, h))
            same = torch.equal(pk, ref[C][0]) and torch.equal(h, ref[C][1])
            _time(cs, f"K9 [C={C}] {label} (equal to the first build's: "
                  f"{same}; SASS {sass})", k9, card)
            assert same or not whole, label


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("part", choices=("times", "compare", "sweep"))
    ap.add_argument("labels", nargs="*")
    ap.add_argument("--tree", default=str(ROOT))
    a = ap.parse_args()
    if a.part == "compare":
        compare("k7_k9", *a.labels, describe)
        return 0
    cs = smoke(a.tree)
    if a.part == "sweep":
        sweep(cs)
    else:
        times(cs, a.tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
