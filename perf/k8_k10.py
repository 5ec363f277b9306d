#!/usr/bin/env python3
"""K8 and K10 of one tree on the card, on chip_smoke.py's inputs.

    python3 perf/k8_k10.py times [--tree DIR] [--save]
    python3 perf/k8_k10.py compare LABEL_A LABEL_B
    python3 perf/k8_k10.py parts

times builds the tree's kernels (DIR's own iamf_tpu_torch, e.g. a
`git archive` of the parent commit unpacked under the ignored _chip/; by
default this checkout's) and prints, for K8 at C=12 and C=10 with B=128
(chip_smoke.k8_inputs) and K10 over 30 s of 12 channels at 44.1 kHz
(chip_smoke.k10_inputs), the ms per call (CUDA events over 20 calls) and
the device ms per call (torch.profiler: every kernel of the call). It
keeps the outputs in perf/build/k8_k10_<label>.pt, the label being the
tree's directory name; --save also writes K10's output where
chip_smoke.py looks for another tree's (chip_smoke.K10_PARENT).

compare prints, between two labels' outputs, torch.equal and the max
|diff| of K10's and of K8's (y and the carry).

parts times K10 at the same shape with parts of its work cut out of a
copy of csrc/resample.cu (a diagnostic: the outputs are wrong): its
stores, its staging of the input, its tap loop; and in other CTA shapes
(channels a thread, a cap on a CTA's shared memory: at 113 KB two CTAs
fit an SM), whose outputs must equal the kernel's. It also counts the
local memory instructions (LDL, STL) in each kernel's SASS.

To compare two trees on one card, run them in turns in one call:
parent, change, change, parent, then compare. Needs a CUDA device and
nvcc. Builds go to each tree's own ignored build directory.
"""

from __future__ import annotations

import argparse
import sys

from trees import ROOT, compare, label, save, smoke, use_source


def times(cs, tree: str, keep: bool) -> None:
    import torch
    from iamf_tpu_torch.dsp import binaural, resample

    dev = torch.device("cuda")
    name = label(tree)
    card = cs.card_line()
    out = {}
    for C in (12, 10):
        h, x, ov = cs.k8_inputs(C, cs.B_MAIN, dev)

        def k8():
            return binaural.hrtf_conv_cuda(h, x, ov)

        out[f"k8_c{C}"] = [t.cpu() for t in k8()]
        ms = cs.cuda_ms(k8)
        dev_ms, _ = cs.device_ms(k8, f"{name} K8 [C={C}]")
        print(f"{name} K8 [C={C}, B={cs.B_MAIN}]: {ms:.4f} ms per call, "
              f"device {dev_ms:.4f} ms [{card}]")
    plan, x = cs.k10_inputs(44100, 30.0, dev)

    def k10():
        return resample.resample_cuda(plan, x)

    y = k10()
    out["k10"] = y.cpu()
    ms = cs.cuda_ms(k10)
    dev_ms, _ = cs.device_ms(k10, f"{name} K10")
    print(f"{name} K10 [44100, 30 s x {x.shape[0]} ch]: {ms:.4f} ms per "
          f"call, device {dev_ms:.4f} ms [{card}]")
    save(out, "k8_k10", tree)
    if keep:
        torch.save(out["k10"], cs.K10_PARENT)


# K10 with a part of its work cut out: (name, [(text, replacement)])
K10_CUTS = [
    ("no stores", [("if (j < T_out) yc[j]", "if (j < 0) yc[j]")]),
    ("no input staging", [("cp_async4(xs + c * S + q, in ? xc + g : xc, in);",
                           "(void)in;")]),
    ("no tap loop", [("for (int f = 0; f < NE; ++f)",
                      "for (int f = 0; f < 0; ++f)")]),
]
# K10 in other CTA shapes: (channels a thread, shared memory cap in KB)
K10_SHAPES = [(4, 227), (4, 113), (2, 227), (2, 113), (2, 75), (1, 113),
              (1, 75), (1, 56)]


def k10_shape(src: str, ct: int, kb: int) -> str:
    for a, b in (("constexpr int CT = ", f"constexpr int CT = {ct}; //"),
                 ("constexpr size_t SMEM_MAX = ",
                  f"constexpr size_t SMEM_MAX = {kb} * 1024; //")):
        assert src.count(a) == 1, a
        src = src.replace(a, b)
    return src


def parts(cs) -> None:
    import torch
    from iamf_tpu_torch.dsp import resample
    from iamf_tpu_torch.kernels import build

    dev = torch.device("cuda")
    card = cs.card_line()
    lib, _ = build.build()
    for k in ("hrtf_fft", "resample"):
        print(f"{k} SASS: {cs.sass_counts(lib, k, ('LDL', 'STL'))}")
    plan, x = cs.k10_inputs(44100, 30.0, dev)
    src = (ROOT / "iamf_tpu_torch" / "csrc" / "resample.cu").read_text()
    versions = [("as built", src, True)]
    for name, subs in K10_CUTS:
        text = src
        for a, b in subs:
            assert text.count(a) == 1, a
            text = text.replace(a, b)
        versions.append((name, text, False))
    versions += [(f"CT {ct}, {kb} KB a CTA", k10_shape(src, ct, kb), True)
                 for ct, kb in K10_SHAPES]
    for name, text, whole in versions:
        use_source(build, resample.K10, name, "resample.cu", text)

        def k10():
            return resample.resample_cuda(plan, x)

        y = k10()
        if name == "as built":
            y0 = y
        same = f", equal to the kernel's: {torch.equal(y, y0)}" if whole \
            else ""
        dev_ms, _ = cs.device_ms(k10, f"K10 {name}")
        print(f"K10 [44100, 30 s x 12 ch], {name}: device {dev_ms:.4f} ms"
              f"{same} [{card}]")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("part", choices=("times", "compare", "parts"))
    ap.add_argument("labels", nargs="*")
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--save", action="store_true")
    a = ap.parse_args()
    if a.part == "compare":
        compare("k8_k10", *a.labels)
        return 0
    cs = smoke(a.tree)
    if a.part == "parts":
        parts(cs)
    else:
        times(cs, a.tree, a.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
