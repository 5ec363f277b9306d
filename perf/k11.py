#!/usr/bin/env python3
"""K11 (CWRS pulse decode) of one tree on the card.

    python3 perf/k11.py times [--tree DIR]
    python3 perf/k11.py compare LABEL_A LABEL_B
    python3 perf/k11.py stamps [--tree DIR]
    python3 perf/k11.py sweep

times builds the tree's kernels (DIR's own iamf_tpu_torch, e.g. a
`git archive` of the parent commit unpacked under the ignored _chip/; by
default this checkout's) and prints the ms per call (CUDA events over 20
calls), the device ms per call (torch.profiler) and the device launches
a call (a captured graph's kernel nodes) of K11 on phase 17's leaves (the
Opus sample's 7,751, chip_smoke.sample_taps) and on the random corpus
(this checkout's chip_smoke.cwrsi_corpus, 4,096 leaves, whatever the
tree). It keeps the outputs (both
layouts at n_max 96 and 24, and the edges) in perf/build/k11_<label>.pt,
the label being the tree's directory name.

compare prints, between two labels' outputs, torch.equal and the max
|diff| of each.

stamps builds a copy of the tree's csrc/celt_cwrsi.cu with clock64()
marks inserted after text anchors (those of the warp-a-leaf design, this
checkout's, or of the thread-a-leaf one, the parent commit's; the kernel
that ships has none), runs it once on the sample's leaves and once on its n = 96
leaves alone (a block with nothing else to do) and prints the blocks'
prologue (thread 0's clock past each barrier and when the rows are in)
and busy cycles, and for each leaf of n = 96 its start, its steps and
runs of zero steps with their mean cycles, and its walk's total. The
marks read the SM's own clock, so only marks of one block are subtracted;
they cost cycles themselves, so totals come from times.

sweep times this checkout's K11 built in other forms (copies of
csrc/celt_cwrsi.cu with lines replaced after text anchors, or other
constants): natural order for long-first, a static stride for the
tickets, the early exit at kk == 0 and i == 0, a step for each zero step
(no runs), five entries a lane for every leaf, and other warps a block
and blocks an SM; each on the sample and on its n = 96 leaves alone,
against the build as it is, whose outputs it must equal.

To compare two trees on one card, run them in turns in one call:
parent, change, change, parent, then compare. Needs a CUDA device and
nvcc. Builds go to each tree's own ignored build directory.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

from k7_k9 import with_constants
from trees import BUILD, ROOT, compare, csrc, label, save, smoke, use_source

STAMP_N = 96     # the leaves stamped: top dimension at least this
MAX_STAMPED = 8
MAX_BLOCKS = 1024
# sweep's builds: (name, constants, (anchor, replacement) pairs)
VARIANTS = [
    ("natural order", {}, [
        ("    {  // a counting sort by n, descending\n",
         "    if (false) {\n")]),
    ("static stride", {}, [
        ("      int nx = 0;\n"
         "      if (lane == 0) nx = atomicAdd(&ticket, 1);\n"
         "      s = __shfl_sync(FULL, nx, 0);\n", "      s += WARPS;\n")]),
    # from kk = 0, i = 0 every coefficient left is 0, and so are the
    # closed forms of n = 2 and n = 1
    ("early exit at kk == 0, i == 0", {}, [
        ("    --d;\n  }\n}\n",
         "    --d;\n    if (kk == 0 && i == 0u) break;\n  }\n}\n")]),
    ("a step a zero step (no runs)", {}, [
        ("    if (kk < d && p0 <= i && i < p1) {\n", "    if (false) {\n")]),
    ("5 entries a lane for every leaf", {}, [
        ("    switch (hi / 32 + 1) {\n", "    switch (5) {\n")]),
    ("16 warps a block", dict(WARPS=16), []),
    ("16 warps a block, 2 blocks an SM", dict(WARPS=16, BLOCKS_SM=2), []),
]
# (anchor, mark inserted after it) of each design. STAMP_BLOCK(p): thread
# 0's clock at block phase p (0 start, 1 rows staged, 2 end, 3 the leaves
# sorted, 4 past the first barrier, 5 the leaves read and counted);
# STAMP_LEAF: a stamped leaf's slot and the clock at its walk's start;
# STAMP_STEP(d): the clock at each pass of the walk's loop, at dimension d;
# STAMP_RUN(F): that pass took a run of F zero steps; STAMP_END: after the
# walk. STAMPER is the thread that stamps a leaf (lane 0 of its warp, or
# the thread of a thread-a-leaf design).
WARP_MARKS = [
    ("  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n",
     "STAMP_BLOCK(0);"),
    ("    for (int u = t; u < BINS; u += THREADS) bins[u] = 0;\n"
     "    __syncthreads();\n", "if (base == 0) STAMP_BLOCK(4);"),
    ("      if (have) atomicAdd(&bins[key], 1);\n      __syncthreads();\n",
     "if (base == 0) STAMP_BLOCK(5);"),
    ("    if (t == 0) ticket = WARPS;\n    __syncthreads();\n",
     "if (base == 0) STAMP_BLOCK(3);"),
    ("    if (base == 0) mbar_wait(rows_bar, 0);\n",
     "if (base == 0) STAMP_BLOCK(1);"),
    ("    __syncthreads();  // the slots are read before the next round's "
     "writes\n  }\n", "STAMP_BLOCK(2);"),
    ("  int d = top;\n", "STAMP_LEAF;"),
    ("  while (d > 2) {\n", "STAMP_STEP(d);"),
    ("      const int F = zero_run(rows, d, kk, i, p0, p1, lane);\n",
     "STAMP_RUN(F);"),
    ("    --d;\n  }\n", "STAMP_END;"),
]
THREAD_MARKS = [
    ("  const int stride = n_max + 1;\n", "STAMP_BLOCK(0);"),
    ("  __syncthreads();\n\n  if (l < L) {\n", "STAMP_BLOCK(1);"),
    ("    const int top = n0 < n_max ? n0 : n_max;\n", "STAMP_LEAF;"),
    ("      const unsigned* row = rows + d * ROW_W;\n", "STAMP_STEP(d);"),
    ("      my[n_max - d] = y;\n    }\n", "STAMP_END;"),
    ("    out[(size_t)(base + r) * n_max + j] = v;\n  }\n",
     "STAMP_BLOCK(2);"),
]
EVENTS = 128
STAMP_HEAD = f"""
__device__ long long k11_blk[{MAX_BLOCKS}][6];
__device__ long long k11_st[{MAX_STAMPED}][{EVENTS}];
__device__ int k11_ev[{MAX_STAMPED}][{EVENTS}][2];  // d, run length
__device__ int k11_meta[{MAX_STAMPED}][4];  // block, top, k, passes
__device__ long long k11_t0[{MAX_STAMPED}];
__device__ int k11_nst;
#define STAMP_AT(who, p) \\
  if (threadIdx.x == (who) && blockIdx.x < {MAX_BLOCKS}) \\
    k11_blk[blockIdx.x][p] = clock64()
#define STAMP_BLOCK(p) STAMP_AT(0, p)
#define STAMP_LEAF \\
  int k11_slot = -1, k11_n = 0; \\
  if (top >= {STAMP_N} && (STAMPER)) {{ \\
    const long long k11_c = clock64(); \\
    k11_slot = atomicAdd(&k11_nst, 1); \\
    if (k11_slot < {MAX_STAMPED}) {{ \\
      k11_meta[k11_slot][0] = blockIdx.x; \\
      k11_meta[k11_slot][1] = top; \\
      k11_meta[k11_slot][2] = kk; \\
      k11_t0[k11_slot] = k11_c; \\
    }} else k11_slot = -1; \\
  }}
#define STAMP_STEP(d) \\
  if (k11_slot >= 0 && k11_n < {EVENTS - 1}) {{ \\
    k11_st[k11_slot][k11_n] = clock64(); \\
    k11_ev[k11_slot][k11_n][0] = (d); \\
    k11_ev[k11_slot][k11_n++][1] = 0; \\
  }}
#define STAMP_RUN(F) \\
  if (k11_slot >= 0 && k11_n > 0) k11_ev[k11_slot][k11_n - 1][1] = (F)
#define STAMP_END \\
  if (k11_slot >= 0) {{ \\
    k11_st[k11_slot][k11_n] = clock64(); \\
    k11_meta[k11_slot][3] = k11_n; \\
  }}
"""
STAMP_ENTRY = """
extern "C" int iamf_k11_stamps(void* blk, void* st, void* ev, void* meta,
                               void* t0, void* nst, int reset) {
  if (reset) {
    static long long zeros[sizeof(k11_blk) / 8];
    const int z = 0;
    cudaError_t e = cudaMemcpyToSymbol(k11_blk, zeros, sizeof(k11_blk));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(k11_nst, &z, sizeof(z));
    return (int)e;
  }
  cudaError_t e = cudaMemcpyFromSymbol(blk, k11_blk, sizeof(k11_blk));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(st, k11_st, sizeof(k11_st));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ev, k11_ev, sizeof(k11_ev));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(meta, k11_meta, sizeof(k11_meta));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(t0, k11_t0, sizeof(k11_t0));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(nst, k11_nst, sizeof(int));
  return (int)e;
}
"""


# chip_smoke.cwrsi_corpus of this checkout into an .npz (argv 1, 2)
CORPUS = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import chip_smoke
np.savez(sys.argv[2], **{f"{c}_{j}": a for c, t in
                         chip_smoke.cwrsi_corpus().items()
                         for j, a in enumerate(t)})
"""


def _corpora() -> dict:
    """chip_smoke.cwrsi_corpus as this checkout builds it, whatever tree's
    package is loaded (an older tree's may not build it), so two trees
    are timed on the same leaves: built in a child process."""
    import numpy as np

    BUILD.mkdir(parents=True, exist_ok=True)
    path = BUILD / "k11_corpus.npz"
    subprocess.run([sys.executable, "-c", CORPUS, str(ROOT), str(path)],
                   check=True)
    z = np.load(path)
    return {c: tuple(z[f"{c}_{j}"] for j in range(3))
            for c in ("random", "edges")}


def _leaves(cs, dev) -> dict:
    """{corpus: (n, k, idx) tensors on dev}: the sample's leaves and the
    random corpus and edges."""
    import torch

    _, (n, k, idx, *_rest) = cs.sample_taps()
    long = n == STAMP_N
    out = {"sample": (n, k, idx), **_corpora(),
           "long": (n[long], k[long], idx[long])}
    return {name: tuple(torch.from_numpy(v).to(dev) for v in t)
            for name, t in out.items()}


def _time(cs, name, fn, card):
    ms = cs.cuda_ms(fn)
    dev_ms, _ = cs.device_ms(fn, name)
    print(f"{name}: {ms:.4f} ms per call, device {dev_ms:.4f} ms in "
          f"{cs.device_launches(fn)} launches (a captured graph's kernel "
          f"nodes) [{card}]")
    return dev_ms


def _outputs(dc, leaves) -> dict:
    """K11's outputs on every corpus, both layouts, n_max 96 and 24."""
    out = {}
    for name, (n, k, idx) in leaves.items():
        for n_max in (96, 24):
            sel = n <= n_max
            if not bool(sel.any()):
                continue
            a = (n[sel], k[sel], dc.contiguous(idx.cpu()[sel.cpu()]).to(
                n.device))
            for al in (True, False):
                out[f"{name} n_max {n_max} {'aligned' if al else 'walk'}"] = \
                    dc.cwrsi_cuda(*a, al, n_max).cpu()
    return out


def times(cs, tree: str) -> None:
    import torch
    from iamf_tpu_torch.codecs.opus import device_cwrsi as dc

    dev = torch.device("cuda")
    card = cs.card_line()
    leaves = _leaves(cs, dev)
    for name in ("sample", "random", "long"):
        a = leaves[name]
        _time(cs, f"{label(tree)} K11 [{name}, {len(a[0])} leaves]",
              lambda: dc.cwrsi_cuda(*a), card)
    save(_outputs(dc, leaves), "k11", tree)


def _stamped(src: str) -> str:
    warp = "template <int R>" in src
    marks, who, kernel = (
        (WARP_MARKS, "lane == 0", "template <int R>\n__device__") if warp
        else (THREAD_MARKS, "1", "__global__ void __launch_bounds__"))
    for anchor, mark in marks:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, f"{anchor}    {mark}\n")
    assert src.count(kernel) == 1, kernel
    head = STAMP_HEAD + f"#define STAMPER {who}\n"
    return src.replace(kernel, head + kernel) + STAMP_ENTRY


def stamp_run(cs, src: str, name: str) -> None:
    """Build `src` (a celt_cwrsi.cu) with the marks, run it once on the
    sample's leaves and once on its leaves of n = 96 alone (a block with
    nothing else to do: the chain's own cycles a step), and print both."""
    import ctypes

    import numpy as np
    import torch
    from iamf_tpu_torch.codecs.opus import device_cwrsi as dc
    from iamf_tpu_torch.kernels import build

    dev = torch.device("cuda")
    card = cs.card_line()
    lib = ctypes.CDLL(str(use_source(build, dc.K11, f"k11_stamps_{name}",
                                     "celt_cwrsi.cu", _stamped(src))))
    fn = lib.iamf_k11_stamps
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0])
    leaves = _leaves(cs, dev)
    for what, a in (("the sample's leaves", leaves["sample"]),
                    (f"its leaves of n = {STAMP_N} alone", leaves["long"])):
        blk = np.zeros((MAX_BLOCKS, 6), np.int64)
        st = np.zeros((MAX_STAMPED, EVENTS), np.int64)
        ev = np.zeros((MAX_STAMPED, EVENTS, 2), np.int32)
        meta = np.zeros((MAX_STAMPED, 4), np.int32)
        t0 = np.zeros(MAX_STAMPED, np.int64)
        nst = np.zeros(1, np.int32)
        dc.cwrsi_cuda(*a)  # warm-up
        torch.cuda.synchronize()
        assert fn(*[None] * 6, 1) == 0
        y = dc.cwrsi_cuda(*a)
        torch.cuda.synchronize()
        assert fn(*(v.ctypes.data for v in (blk, st, ev, meta, t0, nst)),
                  0) == 0
        assert torch.equal(y.cpu(), dc.cwrsi_plain(*(t.cpu() for t in a)))
        used = blk[:int(np.count_nonzero(blk[:, 0]))]
        staged = used[:, 1] - used[:, 0]
        busy = used[:, 2] - used[:, 0]
        sort = "".join(
            f"{what} {(used[:, p] - used[:, 0]).mean():.0f} (max "
            f"{(used[:, p] - used[:, 0]).max()}), "
            for p, what in ((4, "first barrier"), (5, "leaves read and counted"),
                            (3, "leaves sorted")) if used[:, p].any())
        print(f"K11 stamps, {name}, on {what} ({len(a[0])}; {len(used)} "
              f"blocks; equal to the twin) [{card}; max SM clock {mhz:.0f} "
              f"MHz]: cycles after a block's start: {sort}rows staged "
              f"{staged.mean():.0f} (max {staged.max()}); a block's busy "
              f"cycles {busy.mean():.0f} (max {busy.max()} = "
              f"{busy.max() / mhz:.2f} us)")
        for s in range(min(int(nst[0]), MAX_STAMPED)):
            b, top, k0, passes = (int(v) for v in meta[s])
            marks = st[s, :passes + 1]      # each pass's start, the end
            per = np.diff(marks)
            run = ev[s, :passes, 1]
            steps, runs = per[run == 0], per[run > 0]
            walk = marks[-1] - t0[s]
            print(f"  leaf of n {top}, k {k0} (block {b}): starts "
                  f"{t0[s] - blk[b, 0]} cycles after its block "
                  f"({t0[s] - blk[b, 1]} after the rows are staged); "
                  f"{len(steps)} steps of {steps.mean() if len(steps) else 0:.1f}"
                  f" cycles (min {steps.min() if len(steps) else 0}, max "
                  f"{steps.max() if len(steps) else 0}), {len(runs)} runs of "
                  f"{run[run > 0].sum()} zero steps, "
                  f"{runs.mean() if len(runs) else 0:.1f} cycles a run; first "
                  f"pass {marks[0] - t0[s]} cycles after the walk's start; "
                  f"walk {walk} cycles (= {walk / mhz:.2f} us); ends "
                  f"{marks[-1] - blk[b, 0]} after its block's start")


def stamps(cs) -> None:
    from iamf_tpu_torch.kernels import build

    stamp_run(cs, (csrc(build) / "celt_cwrsi.cu").read_text(), "as built")


def sweep(cs) -> None:
    """Time this checkout's celt_cwrsi.cu and its VARIANTS on the sample's
    leaves and on its leaves of n = 96 alone, each variant's outputs
    against the source's own."""
    import torch
    from iamf_tpu_torch.codecs.opus import device_cwrsi as dc
    from iamf_tpu_torch.kernels import build

    dev = torch.device("cuda")
    card = cs.card_line()
    leaves = _leaves(cs, dev)
    src = (csrc(build) / "celt_cwrsi.cu").read_text()
    ref = None
    for v, (name, consts, subs) in enumerate([("as built", {}, []),
                                              *VARIANTS]):
        text = with_constants(src, **consts)
        for a, b in subs:
            assert text.count(a) == 1, a
            text = text.replace(a, b)
        use_source(build, dc.K11, f"k11_sweep{v}", "celt_cwrsi.cu", text)
        got = _outputs(dc, leaves)
        ref = ref or got
        same = all(torch.equal(got[key], ref[key]) for key in ref)
        for corpus in ("sample", "long"):
            a = leaves[corpus]
            _time(cs, f"K11 {name} (equal: {same}) [{corpus}, "
                  f"{len(a[0])} leaves]", lambda: dc.cwrsi_cuda(*a), card)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("part", choices=("times", "compare", "stamps", "sweep"))
    ap.add_argument("labels", nargs="*")
    ap.add_argument("--tree", default=None)
    a = ap.parse_args()
    if a.part == "compare":
        compare("k11", *a.labels)
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
