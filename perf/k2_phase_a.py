#!/usr/bin/env python3
"""K2 on the card: its time on the smoke's inputs, and what its phase A
(the comb, a chain of dependent steps per lane) spends a step on.

    python3 perf/k2_phase_a.py micro            # perf/k2_microbench.cu
    python3 perf/k2_phase_a.py stamps           # clock() per segment
    python3 perf/k2_phase_a.py times [--tree DIR] [--variants 512:2,256:3]

micro builds and runs the microbenchmark: cycles per dependent step of a
bare warp step through shared memory, of the same step by warp shuffle,
and of block steps with a barrier of 1..16 warps.

stamps builds a copy of iamf_tpu_torch/csrc/comb_deemph.cu that records
clock() at the start of each frame, after its z copy and staging, and
after each of its three segments (written over its z: a diagnostic only),
runs it on both parameter sets of chip_smoke.k2_inputs and prints, for the
lanes with the most and the fewest steps, the cycles a frame spends
outside its segments and the cycles a step by segment and path (one warp
or the block).

times prints K2's ms per call (CUDA events) and each kernel's device ms
(torch.profiler) at [12, 128·960] on both parameter sets: for the tree DIR
(its own iamf_tpu_torch, e.g. an unpacked parent commit), or for copies of
this checkout's kernel source with the block width NT and the samples a
thread G set as listed, whose outputs must equal the first's.

Builds go to perf/build/ (ignored by git). Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys

from trees import BUILD, HERE, ROOT, label, smoke, use_source

B, L, F = 128, 12, 960


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def micro() -> None:
    BUILD.mkdir(exist_ok=True)
    exe = BUILD / "k2_microbench"
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "--fmad=false", "-o", str(exe),
                    str(HERE / "k2_microbench.cu")], check=True)
    subprocess.run([str(exe)], check=True)


def stamps(cs, build, synth) -> None:
    import numpy as np
    import torch

    text = (ROOT / "iamf_tpu_torch" / "csrc" / "comb_deemph.cu").read_text()
    mark = "    if (t == 0 && f < 128) tim[f * 6 + {}] = clock();\n"
    for anchor, add in [
            ("  int steps = 0;\n", "  __shared__ unsigned tim[128 * 6];\n"),
            ("    const int cur = f & 1;\n", mark.format(0)),
            ("    if (f > 0) copy_out(ring, zl, (f - 1) * n, n, t, 32);\n",
             mark.format(1)),
            ("        comb_segment<false>(ring, fw, s, yb[cur], f * n, t);\n",
             "  " + mark.format("2 + k")),
            ("  copy_out(ring, zl, (B - 1) * n, n, t, 0);\n",
             "  __syncthreads();\n  for (int i = t; i < 128 * 6; i += NT)\n"
             "    reinterpret_cast<unsigned*>(zl)[i] = tim[i];\n")]:
        assert text.count(anchor) == 1, anchor
        text = text.replace(anchor, anchor + add)
    use_source(build, synth.K2, "stamps", "comb_deemph.cu", text)
    dev = torch.device("cuda")
    bufs, y, hist, demem, window = cs.k2_inputs(dev)
    scratch = torch.empty(L * B * F + L, device=dev)
    lens = np.array([120, 120, 720])
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"SM clock after the runs below: {clk}")
    for name, buf in bufs.items():
        for _ in range(3):
            synth.comb_deemph_cuda(window, y, buf, hist, demem, scratch)
        torch.cuda.synchronize()
        chunk = synth.comb_chunks(buf[..., F:].cpu().numpy())
        steps = -(-lens // chunk)
        one_warp = np.minimum(chunk, lens) <= 64  # 32 G, G = 2
        per_lane = steps.sum(axis=(0, 2))
        for l in (int(per_lane.argmax()), int(per_lane.argmin())):
            tim = scratch[l * B * F:l * B * F + 6 * B].view(torch.int32)
            tim = tim.cpu().numpy().astype(np.int64).reshape(B, 6)

            def d(a, b):
                return (tim[:, b] - tim[:, a]) % (1 << 32)

            rest = (np.roll(tim[:, 0], -1) - tim[:, 4])[:-1] % (1 << 32)
            total = int(sum(d(k + 1, k + 2).sum() for k in range(3))
                        + d(0, 1).sum() + rest.sum())
            print(f"{name} lane {l}: {per_lane[l]} steps, {total} cycles; "
                  f"a frame: {d(0, 1).mean():.0f} cycles before its first "
                  f"segment (z copy, staging), {rest.mean():.0f} after its "
                  f"last")
            for k in range(3):
                cyc = d(k + 1, k + 2)
                for path, m in (("one warp", one_warp[:, l, k]),
                                ("block", ~one_warp[:, l, k])):
                    if m.any():
                        st = steps[m, l, k]
                        print(f"  segment {k}, {path}: {m.sum()} frames, "
                              f"{st.mean():.1f} steps, {cyc[m].mean():.0f} "
                              f"cycles, {cyc[m].sum() / st.sum():.0f} a step")


def times(cs, build, synth, variants, label) -> None:
    import torch

    dev = torch.device("cuda")
    bufs, y, hist, demem, window = cs.k2_inputs(dev)
    card = cs.card_line()
    src = (ROOT / "iamf_tpu_torch" / "csrc" / "comb_deemph.cu").read_text()
    first = {}
    for v in variants or [None]:
        if v is not None:
            nt, g = v.split(":")
            text = src.replace("constexpr int NT = 512;", f"constexpr int NT = {nt};")
            text = text.replace("constexpr int G = 2;", f"constexpr int G = {g};")
            use_source(build, synth.K2, f"nt{nt}_g{g}", "comb_deemph.cu",
                       text)
            label = f"NT {nt}, G {g}"
        for name, buf in bufs.items():
            def k2():
                return synth.comb_deemph_cuda(window, y, buf, hist, demem)

            out = [t.clone() for t in k2()]
            same = all(torch.equal(a, b)
                       for a, b in zip(out, first.setdefault(name, out)))
            ms = cs.cuda_ms(k2)
            _, per = cs.device_ms(k2, f"{label} {name}")
            kern = ", ".join(f"{m.group(0)} {t:.4f}" for k, t in per.items()
                             if (m := re.search(r"\w*(comb|deemph)\w*", k)))
            print(f"{label} {name}: K2 {ms:.4f} ms per call; device ms "
                  f"{kern}; outputs equal the first's: {same} [{card}]")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("part", choices=("micro", "stamps", "times"))
    ap.add_argument("--tree", help="time this tree's K2 instead")
    ap.add_argument("--variants", help="NT:G,... copies of this checkout's K2")
    a = ap.parse_args()
    if a.part == "micro":
        micro()
        return 0
    cs = smoke(a.tree)
    from iamf_tpu_torch.codecs.opus import synth  # noqa: E402
    from iamf_tpu_torch.kernels import build  # noqa: E402

    if a.part == "stamps":
        stamps(cs, build, synth)
    else:
        times(cs, build, synth, a.variants and a.variants.split(","),
              label(a.tree))
    return 0


if __name__ == "__main__":
    sys.exit(main())
