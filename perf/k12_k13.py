#!/usr/bin/env python3
"""K12 and K13 of one tree on the card, on chip_smoke.py's phase 17 inputs.

    python3 perf/k12_k13.py times [--tree DIR]
    python3 perf/k12_k13.py compare LABEL_A LABEL_B
    python3 perf/k12_k13.py stamps [--tree DIR]
    python3 perf/k12_k13.py sweep

times builds the tree's kernels (DIR's own iamf_tpu_torch, e.g. a
`git archive` of the parent commit unpacked under the ignored _chip/; by
default this checkout's) and prints, on the Opus sample's taps
(chip_smoke.celt_inputs: 7,751 leaves, 833 of them rotating in 167
configurations, 32 mono frames), the ms per call (CUDA events over 20
calls), the device ms per call (torch.profiler) and the device launches
a call of: K12 normalize + rotate on every leaf, K12 normalize alone, K12
apply_rotations on the rotating rows, torch.bmm of the gathered bank on
the same rows (the yardstick), and K13 on the 32 frames. It keeps the
outputs in perf/build/k12_k13_<label>.pt, the label being the tree's
directory name.

compare prints, between two labels' outputs, torch.equal and the max
|diff| of each.

stamps builds a copy of the tree's csrc/celt_bands.cu that stamps
clock64() at the phases of each band (thread 0 of a frame's first block),
runs it on the 32 frames and prints the cycles of each phase a band,
averaged over the frames, for each band size N, and the cycles of a
frame. The marks are inserted here, after text anchors where each phase
ends: those of the cluster design (this checkout's) or of the
block-a-frame design (the parent commit's), as the source is one or the
other; the kernel that ships has none.

sweep times this checkout's K13 built with 2 CTAs a cluster (the banks
laid out to match) and with waits that poll, and K12 built with other
blocks an SM and leaves a normalizing warp (copies of csrc/celt_bands.cu
and celt_leaf.cu), each against the build as it is, whose outputs they
must equal.

To compare two trees on one card, run them in turns in one call:
parent, change, change, parent, then compare. Needs a CUDA device and
nvcc. Builds go to each tree's own ignored build directory.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

from k7_k9 import with_constants
from trees import compare, csrc, label, save, smoke, use_source

STAMPED = 32  # frames stamped
# sweep's builds: K13 by CTAs a cluster, K12 by (blocks an SM, leaves a
# normalizing warp)
K13_CLUSTERS = [2]
K12_SHAPES = [(2, 2), (1, 4)]
# K13 with its mbarrier waits polling (test_wait) instead of suspending
# (outputs equal)
POLL = """
__device__ __forceinline__ void mbar_poll(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\\n .reg .pred p;\\n"
        " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
        " selp.u32 %0, 1, 0, p;\\n}\\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
"""
K13_VARIANTS = [
    ("waits that poll (test_wait)", [
        ("namespace cg = cooperative_groups;\n",
         "namespace cg = cooperative_groups;\nnamespace {" + POLL + "}\n"),
        ("mbar_wait(", "mbar_poll(")]),
]

# K13's phases, (anchor, the mark inserted after it) where each ends; a
# mark stamps band i's clock64() of thread 0 of a frame's first block
# (STAMP(p)) or of another thread (STAMP_AT(thread, p)).
# The block-a-frame design: the band's start and each phase's end (after
# the block's barrier, where there is one)
BLOCK_MARKS = [
    ("    const int cfg = p.bt[CFG_ID][band];\n", "STAMP(0);"),
    ("        cm_pvq[lane] = 0u;\n      }\n    }\n", "STAMP(1);"),
    ("    __syncthreads();\n    // through the lowband pre-transform\n",
     "STAMP(2);"),
    ("    for (int u = N + t; u < 2 * W; u += THREADS) lbcat[u] = 0.f;\n"
     "    __syncthreads();\n", "STAMP(3);"),
    ("    __syncthreads();\n    // each q0 slot's energy (the warps' parts "
     "in order) and gain; then the\n", "STAMP(4);"),
    ("      __syncthreads();\n    }\n\n", "STAMP(5);"),
    ("      if (present) collapse[i] = apply_cols16(cmb + c * 16, acc) & "
     "bmb[c];\n    }\n", "STAMP(6);"),
    ("    matvec(post + boff + (size_t)cfg * N * N, X, Xp, N);\n"
     "    __syncthreads();\n", "STAMP(7);"),
    ("    boff += (size_t)NCFG * N * N;\n", "STAMP(8);"),
]
BLOCK_PHASES = ["fills (warp 0)", "window + barrier", "pre matvec + barrier",
                "slot values + barrier", "16 placements (a barrier each)",
                "seed + collapse (thread 0)", "post matvec + barrier",
                "store + barrier"]
# The cluster design: the band's start after the norm rows' wait (0), the
# ends of its phases (1-6), its leaf vectors' wait (7) and the issue of
# band i + 2's vector copy (8, by the thread that issues the copies); the
# gap between a band's end and the next start is the norm rows' wait
CLUSTER_MARKS = [
    ("      exch_wait(smem_u32(&S.bar[BAR_NM + ((i - 1) & 1)]), "
     "((i - 1) >> 1) & 1);\n", "STAMP(0);"),
    ("    __syncthreads();  // A: the window, the band's slots\n",
     "STAMP(1);"),
    ("    mbar_wait(smem_u32(&S.bar[BAR_VEC + (i & 1)]), (i >> 1) & 1);\n",
     "STAMP(7);"),
    ("      exch_wait(smem_u32(&S.bar[BAR_LB + (i & 1)]), (i >> 1) & 1);\n",
     "STAMP(2);"),
    ("    __syncthreads();  // B\n", "STAMP(3);"),
    ("    __syncthreads();  // C\n", "STAMP(4);"),
    ("    __syncthreads();  // D: band i's buffer is read\n", "STAMP(5);"),
    ("    if (t == STAGER && i + 2 < NBANDS) copy_vec(S, i + 2, vecf);\n",
     "if (i + 2 < NBANDS) STAMP_AT(STAGER, 8);"),
    ("    __syncthreads();  // E: band i's post is read, its collapse mask "
     "set\n", "STAMP(6);"),
]
PHASES = ["window + inputs' wait + barrier",
          "pre rows + PVQ values + barrier + cluster wait",
          "q0 values + barrier", "gains + barrier",
          "placement gather + barrier",
          "post rows + arrive + collapse + barrier"]
STAMP_ENTRY = """
extern "C" int iamf_k13_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, k13_stamps, sizeof(k13_stamps));
}
"""


def _bits(t):
    import torch

    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _time(cs, name, fn, card):
    ms = cs.cuda_ms(fn)
    dev_ms, _ = cs.device_ms(fn, name)
    print(f"{name}: {ms:.4f} ms per call, device {dev_ms:.4f} ms in "
          f"{cs.device_launches(fn)} launches (a captured graph's kernel "
          f"nodes) [{card}]")


def times(cs, tree: str) -> None:
    import torch
    from iamf_tpu_torch.codecs.opus import device_bands as db
    from iamf_tpu_torch.codecs.opus import device_leaf as dl

    dev = torch.device("cuda")
    name = label(tree)
    card = cs.card_line()
    d = cs.celt_inputs(dev)
    y, g, cfg, bank = d["y"], d["g"], d["cfg"], d["bank"]
    sel = torch.nonzero(cfg >= 0).flatten()
    xr = dl.normalize_pulses(y, g)[sel].contiguous()
    cr = cfg[sel].contiguous()
    mats = bank[cr.long()]
    calls = {
        f"K12 normalize + rotate [{len(y)} leaves]":
            ("k12_normrot", lambda: dl.normalize_rotate(y, g, cfg, bank)),
        f"K12 normalize [{len(y)} leaves]":
            ("k12_norm", lambda: dl.normalize_pulses(y, g)),
        f"K12 apply_rotations [{len(sel)} rows]":
            ("k12_apply", lambda: dl.apply_rotations(xr, cr, bank)),
        f"torch.bmm [{len(sel)}, 96, 96] x [{len(sel)}, 96, 1]":
            (None, lambda: torch.bmm(mats, xr[:, :, None])),
        f"K13 [{d['s0'].shape[0]} frames]":
            ("k13", lambda: db.run_frames_cuda(d["bt"], d["lt"], d["s0"])),
    }
    out = {}
    for what, (key, fn) in calls.items():
        if key:  # u32 kept as int32 bits (the CPU has no uint32 sub)
            r = fn()
            out[key] = [_bits(t) for t in r] if isinstance(r, tuple) \
                else _bits(r)
        _time(cs, f"{name} {what}", fn, card)
    save(out, "k12_k13", tree)


def _stamped(src: str) -> tuple[str, list]:
    """(the source with its marks, the phases' names)."""
    cluster = "__cluster_dims__" in src
    marks, names, kernel, who = (
        (CLUSTER_MARKS, PHASES, "__global__ void __cluster_dims__",
         "t == (who) && q == 0") if cluster else
        (BLOCK_MARKS, BLOCK_PHASES,
         "__global__ void __launch_bounds__(THREADS)", "t == (who)"))
    for anchor, mark in marks:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, f"{anchor}    {mark}\n")
    head = (f"__device__ long long k13_stamps[{STAMPED}][21][9];\n"
            "#define STAMP_AT(who, p) \\\n"
            f"  if ({who} && f < {STAMPED}) k13_stamps[f][i][p] = clock64()\n"
            "#define STAMP(p) STAMP_AT(0, p)\n")
    assert src.count(kernel) == 1, kernel
    return src.replace(kernel, head + kernel) + STAMP_ENTRY, names


def stamps(cs) -> None:
    import ctypes

    import numpy as np
    import torch
    from iamf_tpu_torch.codecs.opus import device_bands as db
    from iamf_tpu_torch.kernels import build

    dev = torch.device("cuda")
    card = cs.card_line()
    src = (csrc(build) / "celt_bands.cu").read_text()
    text, names = _stamped(src)
    lib = ctypes.CDLL(str(use_source(build, db.K13, "k13_stamps",
                                     "celt_bands.cu", text)))
    d = cs.celt_inputs(dev)
    db.run_frames_cuda(d["bt"], d["lt"], d["s0"])
    torch.cuda.synchronize()
    st = np.zeros((STAMPED, db.NBANDS, 9), np.int64)
    lib.iamf_k13_stamps.argtypes = [ctypes.c_void_p]
    assert lib.iamf_k13_stamps(st.ctypes.data) == 0
    n_ph = len(names)
    cyc = np.diff(st[:, :, :n_ph + 1], axis=2)  # [frames, bands, phases]
    gap = st[:, 1:, 0] - st[:, :-1, n_ph]       # band end to next start
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0]
    print(f"K13 stamps ({STAMPED} frames, mean cycles; thread 0 of a "
          f"frame's first block) [{card}; max SM clock {mhz} MHz]")
    sizes = db.band_sizes()
    print("N     bands  " + "  ".join(f"{i}:{n}" for i, n in enumerate(names))
          + "  band")
    for N in sorted(set(sizes.tolist())):
        b = np.flatnonzero(sizes == N)
        per_phase = cyc[:, b].mean(axis=(0, 1))
        print(f"{N:<5} {len(b):<6} "
              + "  ".join(f"{c:9.0f}" for c in per_phase)
              + f"  {per_phase.sum():9.0f}")
    if names is PHASES:  # 7: the band's leaf vectors waited for; 8: band
        # i + 2's copy issued (the stager)
        late = st[:, :, 7] - st[:, :, 1]
        flight = st[:, 2:, 7] - st[:, :-2, 8]
        print("leaf vectors ready, cycles after the window's barrier, by N: "
              + ", ".join(f"{N} {late[:, sizes == N].mean():.0f}"
                          for N in sorted(set(sizes.tolist())))
              + f"; from the copy's issue to the wait's end {flight.mean():.0f}"
              f" (min {flight.min()}, max {flight.max()})")
    frame = st[:, -1, n_ph] - st[:, 0, 0]
    print(f"a frame: {frame.mean():.0f} cycles (min {frame.min()}, max "
          f"{frame.max()}), = {frame.mean() / float(mhz):.2f} us at "
          f"{mhz} MHz; between bands {gap.mean():.0f} cycles a band")


def sweep(cs) -> None:
    import torch
    from iamf_tpu_torch.codecs.opus import device_bands as db
    from iamf_tpu_torch.codecs.opus import device_leaf as dl
    from iamf_tpu_torch.kernels import build

    dev = torch.device("cuda")
    card = cs.card_line()
    d = cs.celt_inputs(dev)
    y, g, cfg, bank = d["y"], d["g"], d["cfg"], d["bank"]

    def k12():
        return dl.normalize_rotate(y, g, cfg, bank)

    def k13():
        return db.run_frames_cuda(d["bt"], d["lt"], d["s0"])

    ref12, ref13 = k12(), k13()
    _time(cs, "K12 as built", k12, card)
    _time(cs, f"K13 as built ({db.k13_cluster()} CTAs a cluster)", k13, card)
    src = (csrc(build) / "celt_leaf.cu").read_text()
    for blocks, leaves in K12_SHAPES:
        use_source(build, dl.K12, f"k12_{blocks}_{leaves}", "celt_leaf.cu",
                   with_constants(src, MIN_BLOCKS=blocks,
                                  NORM_LEAVES=leaves))
        same = torch.equal(k12(), ref12)
        _time(cs, f"K12 {blocks} blocks an SM, {leaves} leaves a warp "
              f"(equal: {same})", k12, card)
    src = (csrc(build) / "celt_bands.cu").read_text()
    for c in K13_CLUSTERS:  # the banks follow the library's cluster
        use_source(build, db.K13, f"k13_c{c}", "celt_bands.cu",
                   with_constants(src, CLUSTER=c))
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(k13(), ref13))
        _time(cs, f"K13 {c} CTAs a cluster (equal: {same})", k13, card)
    for name, subs in K13_VARIANTS:
        text = src
        for a, b in subs:
            assert text.count(a) >= 1, a
            text = text.replace(a, b)
        use_source(build, db.K13, f"k13_{name[:12]}", "celt_bands.cu", text)
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(k13(), ref13))
        _time(cs, f"K13 {name} (equal: {same})", k13, card)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("part", choices=("times", "compare", "stamps", "sweep"))
    ap.add_argument("labels", nargs="*")
    ap.add_argument("--tree", default=None)
    a = ap.parse_args()
    if a.part == "compare":
        compare("k12_k13", *a.labels)
        return 0
    cs = smoke(a.tree)
    if a.part == "stamps":
        stamps(cs)
    elif a.part == "sweep":
        sweep(cs)
    else:
        times(cs, a.tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
