#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (iamf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package (both are blocked in
sys.modules); its streams come from iamf_tpu_torch.tools.streams, and the
only file of the JAX package it reads is the Opus sample stream (data).

Builds the hand-written kernels from iamf_tpu_torch/csrc, then:
  1. build: compiles the kernel library with nvcc and reports the seconds;
  2. kernels: K1 (IMDCT+TDAC), K2 (comb+de-emphasis+s16) and K3
     (limiter+quantize) at the main path's batch shape against their plain
     PyTorch twins, with each one's time, its twin's and its bound; K2 on
     random comb parameters and on the Opus sample's, each phase's device
     time and phase A's steps per lane against its schedule; K1
     also at the Opus cell's batch of 8, with its device time
     (torch.profiler), and its product kernel's SASS must hold tensor-core
     (HGMMA) and TMA (UTMALDG) instructions. K3 is held bit for bit (0 LSB,
     equal state) on a burst across two [12, N] batches and on a batch of
     the binaural cell (engaged, C = 2) and of the PCM cell (idle, C = 12),
     each with its gain walk's device time beside the first design's; its
     walk's SASS must hold no MUFU.RCP (no division left in the chain);
  3. Opus end to end: iamf_tpu/data/sample_opus_714.iamf -> sound system J
     at batch_frames=8 against the stored golden (the JAX package's decode),
     with the kernels' launch counts from that run;
  4. PCM at the bench's size: 30 s of 7.1.4 PCM -> sound system J at
     batch_frames=128, and a short loud stream that engages the limiter,
     each against this package's own CPU run; realtime factors;
  5. kernels of the output paths: K8 (HRTF convolution, overlap-save
     FFTs) at B=128 and B=3 with 12- and 10-channel beds and a live overlap
     carry, K10 (resampler) over 30 s of 12 channels at 44.1 kHz and on
     short 16/32/96/22.05/11.025/88.2 kHz inputs, and K3 over the whole
     resampled stream, against their plain twins, with times per call
     (CUDA events) and device times (torch.profiler); K8 and K10 also
     against their one-call yardsticks (F.conv1d), and K10 against the
     output of another tree where perf/k8_k10.py saved one;
  6. binaural at full width: 30 s of 7.1.4 PCM with headphones rendering
     mode 1 (M2B, 12-channel bed) at batch_frames=128, limiter on, against
     the CPU run, with its realtime factor, K8's launches and a profiler
     trace; short H2B (FOA), two-element and mode-0 (matrix, no K8) runs;
  7. resampled at full width: 30 s of 7.1.4 PCM at 44.1 kHz -> sound
     system J at batch_frames=128, limiter on, likewise (K10 and K3); short
     5.1 runs with normalization, limiter on and off;
  8. kernels of the AAC and true-peak paths: K7 (AAC filterbank) at
     B=128 and B=8 with every (sequence, shape, previous shape) and a live
     carry over two consecutive calls, against its twin (1 LSB; the
     unrounded carry within 0.25 at s16 scale), one device launch a call
     and no local memory in its SASS; K9 (true-peak meter) at [12, 122,880]
     and [2, 122,880] from a nonzero history over two batches, one device
     launch a call, no local memory and no fused multiply-add in its SASS;
     each with its times, its twin's, its bound and its one-call
     yardstick (torch.matmul of the long product; F.conv1d of the FIR);
  9. AAC at full width: 30 s of 7.1.4 AAC-LC (1407 frames, short blocks
     included; streams.build_aac_layout_stream) -> sound system J at
     batch_frames=128, limiter on, against the CPU run, with its realtime
     factor and K7's launches; a loud 5.1 AAC stream at batch_frames=8;
 10. true peak at full width: 30 s of 7.1.4 PCM carrying an fs/4 tone at
     45 degrees -> J at batch_frames=128 with IAMF_TRUEPEAK=1 (set around
     the decoders, then restored), against the CPU run, with K9's
     launches; the limiter engages where a sample-peak decode's stays idle;
 11. the stream axis: K3 (an engaged [4, 2, 122,880] and an idle [4, 12,
     122,880] batch, four consecutive batches of the binaural and PCM
     cells, each stream with its decode's state), K9 ([4, 12, 122,880])
     and K8 ([4, 12, 128·960], one bank) in one launch against four S = 1
     calls on the card (K3 0 LSB and equal states, K9 bit-equal, K8 equal
     and within 1e-4 of its twin), with device times beside the S = 1
     call's and bounds; K1 + K2 and K7 with 4 streams folded into 48 lanes
     against four 12-lane calls;
 12. fleets at full width through MultiStreamServer (batch_frames=128):
     4 x 30 s of 7.1.4 PCM -> J (seeds 0-3, amp 0.2-0.5; one bucket),
     4 x 30 s binaural M2B (K8, K3 engaged at S = 4), and 30 s + 22 s of
     7.1.4 PCM with the Opus sample and its first 12 temporal units (two
     buckets: K1, K2, K3); each stream against its own decode_all(
     fetch=False) on the card (<= 1 LSB), each kernel's launches against
     the buckets' longest members' own decodes, the aggregate realtime
     factor and a trace;
 13. short fleets at batch_frames=16, untimed: 2 AAC-LC 7.1.4 streams (K7
     at 24 lanes), 3 true-peak streams of unequal length (K9 and K3 at
     S = 3), a scalable-demix pair; a 44.1 kHz and a reconfigured stream
     are refused;
 14. reconfigure at full width: the Opus sample followed by 30 s of 7.1.4
     PCM, one stream -> J at batch_frames=128, against the CPU run, its
     first segment against the golden less its last delay_size samples,
     one entry under stats["segments"];
 15. MP4: the Opus sample muxed into MP4 and fMP4 (tools/mp4builder.py),
     from_mp4 -> J at batch_frames=8 against the golden, and with
     start_sec=0.1 against the CPU run of the same file;
 16. the frame-serial decoder (api.IAMFDecoder, one access unit a call):
     the Opus sample -> J through IAMFDecoder() (its default device, the
     card) against the CPU serial decode (<= 1 LSB) and the golden (the JAX
     package's batched decode; <= 2 LSB, the JAX package's own
     serial-vs-batched bound); three cells at full width, 30 s of 7.1.4
     PCM -> J (960-sample frames, limiter on), the same content with
     headphones rendering mode 1 -> binaural (M2B: K8) and phase 9's
     AAC-LC content -> J (1024-sample frames), each against the CPU serial
     run (the AAC one on its first 400 access units) and against the card's
     batched decode_all of the same stream (<= 1 LSB), with its realtime
     factor (median of 3), the device's busy share from one torch.profiler
     trace, and K3's and K8's launches per decode checked against the
     frames that reach the limiter and the HRTF renderer; a short true-peak
     run (K9 once a frame); a configure(None) re-target mid-stream (J,
     5.1, binaural); the port's player (-o2 -s9, and -i1 on the sample
     in MP4) on the card against the CPU player's WAV;
 17. the CELT device entropy stages on the Opus sample: the native decoder
     taps its 7,751 PVQ leaves and the band records of its 32 mono frames
     once (tools/celt_taps.py); the path a user calls,
     device_leaf.reconstruct (K11 then K12, one launch each) on every
     leaf and device_bands.run_frame (K13, the 32 frames in one launch)
     on band_pack's packed tables, runs with the launch counts set to 0
     just before it and is held to the taps (leaves rel 1e-5 of the tap's
     first 32 coefficients, spectra rel 2e-5 of each frame's peak, the
     emitted end seeds and the collapse masks equal); then K11 bit for
     bit against its twin and the native walk (also walk order and
     n_max = 24), and so on the random corpus (4,096 leaves) and the
     edges of the CPU tests (cwrsi_corpus), K12 within rel 1e-6 of each row's peak of its twin
     (the normalization alone and the LCG entries bit for bit), K13
     within rel 2e-5 with equal seeds and collapse masks and equal to its
     F = 1 calls bit for bit, each with its times, its twin's, its bound
     and, for the rotations, one torch.bmm of the gathered bank; then K12
     in its apply_rotations mode on the same 833 rows against that bmm
     (like for like: both take the normalized rows), within rel 1e-6 of
     each row's peak of its twin and of bmm, with both times.
Each phase prints its wall.
Every kernel's launch count in the kernels line comes from the run of the
path it serves (K1/K2/K3 the Opus decode, K8 the binaural, K10 the
resampled one, K7 the AAC one, K9 the true-peak one, K11-K13 phase 17's
path; K12's count sums its three entries), with the counts set
to 0 just before that run; its
bound_ms is the larger of bytes over 3.35 TB/s and operations over the
peak of their type (H100 SXM), from the row's own inputs, counting the
fewest operations the function needs (K8: an FFT convolution; K3: a
sliding window max; K1 and K7: FFT IMDCTs; K9: its distinct products).
A device time comes from a torch.profiler trace; where the trace missed
events or recorded none, a line names the measurement and its stand-in.
A device launch count is the kernel nodes of a CUDA graph captured from
one call.
The last line is {"ok": true, "device": {...}}. Any failed check raises, and
the script exits non-zero without that line; so does a machine without a
visible CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# the port stands alone: any reach into JAX or the JAX package fails loudly
sys.modules["jax"] = None
sys.modules["iamf_tpu"] = None

import torch  # noqa: E402

B_MAIN = 128   # the bench's batch_frames
B_OPUS = 8     # the Opus cell's batch_frames
LANES = 12     # 7.1.4 lanes
FRAME = 960

# H100 SXM peaks (NVIDIA's data sheet, dense, 700 W) for the bounds: the
# least time the card could take for a call's work is the larger of its
# bytes (each input read once, each output written once) over the memory
# rate and its operations over the peak rate of their type
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12    # CUDA cores
TF32_FLOPS = 495e12   # tensor cores

# K3's gain walk in its first design (one warp, a shuffle and IEEE
# divisions per step), device ms per 122,880-sample batch (PERF.md §6: H100
# 80GB HBM3, 700 W): engaged on the binaural content, idle at C = 12
OLD_WALK_MS = {"engaged": 26.8, "idle": 0.30}


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warm: int = 2) -> float:
    """Mean device time of fn() in ms (CUDA events over `reps` calls)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _device_trace(fn, reps: int):
    """({name: (device us, events)}, complete) of every kernel, memset and
    copy in a torch.profiler trace of `reps` calls of fn() after a
    warm-up; complete when every name's events are a multiple of reps (a
    trace may lose a window's first events, or all of them, the more
    often the more the process has traced). The profiler's own warm-up
    step (one call, not reported) lets the tracing start before the
    reported calls. Traced again, up to five times, while it holds no
    event; ({}, False) if every trace was empty."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        per = {ev.key: (ev.self_device_time_total, ev.count)
               for ev in prof.key_averages() if ev.self_device_time_total > 0}
        if per:
            return per, all(n % reps == 0 for _, n in per.values())
    return {}, False


def device_ms(fn, label: str, reps: int = 20) -> tuple[float, dict]:
    """Device time per call of fn() in ms from a torch.profiler trace of
    `reps` calls after a warm-up: the total over every kernel and memset,
    and the time of each by name. Where the trace missed events, each
    name's mean event times its events a call, rounded (at least one);
    where no trace records anything, the time of calls queued back to
    back (queued_ms). Either stand-in is printed, under `label`."""
    trace, complete = _device_trace(fn, reps)
    if not trace:
        ms = queued_ms(fn)
        print(f"{label}: torch.profiler recorded nothing in five traces; "
              f"its device time is queued_ms, {ms:.4f} ms (CUDA events "
              "around queued calls, launch gaps included)")
        return ms, {"queued calls (CUDA events)": ms}
    if not complete:
        short = sorted(k[:40] for k, (_, n) in trace.items() if n % reps)
        print(f"{label}: the trace missed events of {short}; their device "
              "time is the mean event x its events a call, rounded")
    per = {k: us / n * max(1, round(n / reps)) / 1e3
           for k, (us, n) in trace.items()}
    return sum(per.values()), per


def device_launches(fn) -> int:
    """Device kernel launches per call of fn(): the kernel nodes of a CUDA
    graph captured from one call. Exact, where a torch.profiler trace is
    not: in a process that has traced many times, traces lose a window's
    first events, or all of them."""
    rt = ctypes.CDLL("libcudart.so.12")
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    check(rt.cudaGraphGetNodes(graph, None, ctypes.byref(n)) == 0,
          "cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(rt.cudaGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0,
          "cudaGraphGetNodes failed")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        check(rt.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)) == 0,
              "cudaGraphNodeGetType failed")
        kernels += kind.value == 0  # cudaGraphNodeTypeKernel
    return kernels


def queued_ms(fn, reps: int = 50) -> float:
    """Device time per call of fn() in ms by CUDA events around `reps`
    calls queued behind a spin kernel, so that they run back to back:
    each call's kernels and the gaps between launches."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms: the host queues meanwhile
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def host_ms(fn) -> tuple[float, object]:
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, out


def timed(fn, reps: int) -> list:
    """Wall seconds of `reps` calls of fn (decode_all synchronizes)."""
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t)
    return walls


def _ms(walls) -> str:
    w = sorted(1e3 * x for x in walls)
    return f"{np.median(w):.1f} (min {w[0]:.1f}, max {w[-1]:.1f})"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, ops: float, rate: float) -> dict:
    """bound_ms / bound_by for a call that moves n_bytes and does `ops`
    operations of a type whose peak is `rate` per second."""
    t_bytes, t_ops = n_bytes / HBM_BPS, ops / rate
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# --- phase 2: kernels vs plain twins ----------------------------------------

def sass_counts(lib, kernel: str, opcodes) -> dict:
    """How many instructions of each opcode the named kernel's SASS holds
    (cuobjdump of the built library)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs = [f for f in sass.split("Function : ")[1:]
             if kernel in f.split(None, 1)[0]]
    check(len(funcs) == 1, f"{kernel}: {len(funcs)} SASS functions")
    return {op: len(re.findall(rf"\b{op}\b", funcs[0])) for op in opcodes}


def fft_imdct_flops(n: int) -> float:
    """The fewest fp32 operations of an n-output IMDCT: an n/4-point
    complex FFT (5 (n/4) log2(n/4) flops) with pre- and post-twiddles (12
    flops a point)."""
    q = n // 4
    return 5 * q * math.log2(q) + 12 * q


def k1_ops(trans) -> float:
    """The fewest fp32 operations of K1's function on these rows, on K7's
    rule (imdct_ops): a 1920-output FFT IMDCT per long row, eight
    240-output ones per short row; then a multiply and an add per sample
    of the 120-sample window overlap and of the 60-sample tail."""
    short = int(trans.sum())
    rows = trans.numel()
    return ((rows - short) * fft_imdct_flops(2 * FRAME)
            + short * 8 * fft_imdct_flops(2 * FRAME // 8)
            + rows * 2 * (120 + 60))


def k1_phase(dev, tag, lib):
    from iamf_tpu_torch.codecs.opus import imdct

    counts = sass_counts(lib, "k1_product", ("HGMMA", "UTMALDG"))
    print(f"K1 product kernel SASS: {counts}")
    check(all(counts.values()), f"K1 misses tensor cores or TMA: {counts}")
    mats = imdct.FusedMats().to(dev)
    row = dict(name="k1_imdct_tdac", max_abs_err=0.0)
    for B in (B_MAIN, B_OPUS):
        rng = np.random.RandomState(0)
        # the packed [B, L, 973] buffer read in place, as the decode path
        # does; spectra at the scale of tests/test_opus_pallas.py
        buf = torch.from_numpy(rng.randn(B, LANES, FRAME + 13).astype(
            np.float32) * 1000.0).to(dev)
        freq = buf[..., :FRAME]
        trans = torch.from_numpy(rng.rand(B, LANES) < 0.3).to(dev)
        tail0 = torch.from_numpy(
            rng.randn(LANES, 60).astype(np.float32) * 1024.0).to(dev)
        y, tail = imdct.imdct_overlap_cuda(mats, freq, trans, tail0)
        y_p, tail_p = imdct.imdct_overlap_plain(mats, freq, trans, tail0)
        torch.cuda.synchronize()
        err = max(float((y - y_p).abs().max()),
                  float((tail - tail_p).abs().max()))
        print(f"K1 imdct [B={B}, L={LANES}]: max|diff| {err:.3e} "
              "(bound 0.25)")
        check(err < 0.25, f"K1 disagrees with its plain twin: {err}")
        ms = cuda_ms(lambda: imdct.imdct_overlap_cuda(mats, freq, trans,
                                                      tail0))
        plain = cuda_ms(lambda: imdct.imdct_overlap_plain(mats, freq, trans,
                                                          tail0))
        dev_ms, per = device_ms(lambda: imdct.imdct_overlap_cuda(
            mats, freq, trans, tail0), f"K1 [B={B}]")
        prod = sum(v for k, v in per.items() if "k1_product" in k)
        dev_plain, _ = device_ms(lambda: imdct.imdct_overlap_plain(
            mats, freq, trans, tail0), f"K1's twin [B={B}]")
        gflop = B * LANES * FRAME * (FRAME + 60) * 2 / 1e9
        print(f"K1 time [B={B}] {ms:.4f} ms per call ({gflop / ms:.2f} "
              f"TFLOP/s of useful fp32-equivalent work, split-TF32 tensor "
              f"cores), plain twin (torch.matmul fp32, both modes) "
              f"{plain:.4f} ms; device time per call {dev_ms:.4f} ms "
              f"(product kernel {prod:.4f} ms), twin {dev_plain:.4f} ms "
              f"{tag}")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if B == B_MAIN:
            # the fewest operations (FFT IMDCTs), as K7's bound counts them
            ops = k1_ops(trans)
            b = bound(nbytes(freq, trans, tail0, y, tail), ops, FP32_FLOPS)
            print(f"K1 bound [B={B}] {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']}; {ops / 1e6:.1f} M flops by FFT "
                  f"IMDCTs); the dense split-TF32 product's: "
                  f"{3 * gflop / TF32_FLOPS * 1e12:.4f} ms at the TF32 "
                  f"peak; yardstick: the twin's torch.matmul (cuBLAS fp32) "
                  f"{dev_plain:.4f} ms of device time")
            row.update(ms=ms, plain_ms=plain, library_ms=dev_plain, **b)
    return row


def _comb_params(rng, B, L):
    """Legal random comb parameters with period/gain changes between
    frames: periods 15..1024, gains 0.09375*(1..8) times a tapset row."""
    taps = np.load(os.path.join(
        ROOT, "iamf_tpu_torch", "data",
        "opus_tables.npz"))["gains"].astype(np.float32).reshape(3, 3)
    per = rng.randint(15, 1025, size=(B + 1, L))
    keep = rng.rand(B + 1, L) < 0.5   # about half the frames hold the period
    for b in range(1, B + 1):
        per[b] = np.where(keep[b], per[b - 1], per[b])
    g = (np.float32(0.09375) * rng.randint(1, 9, size=(B + 1, L))).astype(
        np.float32)[..., None] * taps[rng.randint(0, 3, size=(B + 1, L))]
    g[rng.rand(B + 1, L) < 0.2] = 0.0   # post-filter off in some frames
    pk = np.zeros((B, L, 13), np.float32)
    pk[..., 1] = per[:-1]      # t_old: the previous frame's period
    pk[..., 2] = per[:-1]      # t_cur
    pk[..., 3] = per[1:]       # t_new
    pk[..., 4:7] = g[:-1]
    pk[..., 7:10] = g[:-1]
    pk[..., 10:13] = g[1:]
    return pk


def _sample_params():
    """The Opus sample's packed per-frame parameters [16, 12, 13], from the
    port's host entropy decode."""
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

    data = open(os.path.join(ROOT, "iamf_tpu", "data",
                             "sample_opus_714.iamf"), "rb").read()
    d = BatchedStreamDecoder(data, sound_system=9, batch_frames=8,
                             device="cpu")
    e = d.elems[0]
    packets = [d.frames_per_substream[s] for s in e.substream_ids]
    return np.concatenate([d._opus_entropy(e, packets, s, 8, 8)[..., FRAME:]
                           for s in (0, 8)])


# K2's first design (one block of two warps a lane, the de-emphasis one
# thread's serial walk), ms per call at [12, 128·960] (PERF.md §6: H100
# 80GB HBM3, 700 W)
OLD_K2_MS = 1.5722


def k2_inputs(dev):
    """K2's inputs at [12, 128·960]: the packed buffers of the two
    parameter sets (by name), and the spectra y, hist, demem and window
    they share."""
    from iamf_tpu_torch.codecs.opus import synth

    rng = np.random.RandomState(1)
    B, L = B_MAIN, LANES
    sets = {"random": _comb_params(rng, B, L),
            "sample": np.tile(_sample_params(), (B // 16, 1, 1))}
    bufs = {}
    for name, pk in sets.items():
        buf = np.zeros((B, L, FRAME + 13), np.float32)
        buf[..., FRAME:] = pk
        bufs[name] = torch.from_numpy(buf).to(dev)
    y = torch.from_numpy(
        rng.randn(B, L, FRAME).astype(np.float32) * 3000.0).to(dev)
    hist = torch.from_numpy(
        rng.randn(L, synth.HIST).astype(np.float32) * 3000.0).to(dev)
    demem = torch.from_numpy(rng.randn(L).astype(np.float32) * 100.0).to(dev)
    window = torch.from_numpy(synth.window120().copy()).to(dev)
    return bufs, y, hist, demem, window


def k2_phase(dev, tag):
    """K2 at [12, 128·960] on two parameter sets: uniform random periods
    15..1024 with 20 % zero gains, and the Opus sample's 16 frames of
    parameters tiled to 128 (a quarter of its lane-frames have lags under
    100); random spectra for both. Against the twin: PCM <= 1 LSB, hist'
    equal, demem' within 1e-6 of the largest |demem'|; phase A's steps per
    lane as synth.comb_steps counts them. Device time of each phase
    (torch.profiler) and ns per dependent step of phase A's slowest lane."""
    from iamf_tpu_torch.codecs.opus import synth

    B, L = B_MAIN, LANES
    bufs, y, hist, demem, window = k2_inputs(dev)
    scratch = torch.empty(L * B * FRAME + L, device=dev)
    row = dict(name="k2_comb_deemph_s16", max_abs_err=0.0, library_ms=None)
    for name, buf in bufs.items():
        pk = buf[..., FRAME:].cpu().numpy()

        def k2():
            return synth.comb_deemph_cuda(window, y, buf, hist, demem,
                                          scratch)

        pcm, h2, m2 = k2()
        steps = scratch[L * B * FRAME:].view(torch.int32).cpu().numpy()
        want = synth.comb_steps(pk)
        plain_ms, (pcm_p, h2_p, m2_p) = host_ms(
            lambda: synth.comb_deemph_plain(window, y, buf, hist, demem))
        d = ((pcm - pcm_p) * 32768.0).abs()
        err = float(d.max())
        m_err = float((m2 - m2_p).abs().max())
        m_tol = 1e-6 * max(1.0, float(m2_p.abs().max()))
        print(f"K2 {name} [{L}, {B}*960]: max|diff| {err:.0f} s16 LSB, "
              f"{int((d > 0).sum())} of {d.numel()} samples differ (bound 1 "
              f"LSB); hist' equal {torch.equal(h2, h2_p)}; demem' max|diff| "
              f"{m_err:.3e} (bound {m_tol:.3e}); phase A steps per lane "
              f"{steps.tolist()}, the schedule's {want.tolist()}")
        check(err <= 1.0, f"K2 disagrees with its plain twin: {err} LSB")
        check(torch.equal(h2, h2_p), "K2's comb history differs")
        check(m_err <= m_tol, f"K2's de-emphasis memory differs: {m_err}")
        check(np.array_equal(steps, want), "K2's phase A steps differ")
        ms = cuda_ms(k2)
        dev_ms, per = device_ms(k2, f"K2 {name}")
        a = sum(v for k, v in per.items() if "comb_kernel" in k)
        b_ = sum(v for k, v in per.items() if "deemph_kernel" in k)
        print(f"K2 {name} time {ms:.4f} ms per call (the first design: "
              f"{OLD_K2_MS} ms), device {dev_ms:.4f} ms: phase A (comb) "
              f"{a:.4f} ms, phase B (de-emphasis + s16) {b_:.4f} ms; phase "
              f"A's slowest lane {steps.max()} dependent steps (mean "
              f"{steps.mean():.1f}), {a * 1e6 / steps.max():.1f} ns a step; "
              f"plain twin (chunked comb + blocked de-emphasis, torch ops on "
              f"the card) {plain_ms:.1f} ms {tag}")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if name == "random":
            # a comb of 3 taps x 2 (old and new filter, cross-faded) and
            # the de-emphasis: ~16 flops a sample
            b = bound(nbytes(y, buf[..., FRAME:], hist, demem, window, pcm,
                             h2, m2), 16 * y.numel(), FP32_FLOPS)
            print(f"K2 bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
            row.update(ms=ms, plain_ms=plain_ms, **b)
    return row


def _loud_pcm(n_total, nch, bursts):
    """Sine bed at 0.4 FS with a +4 dB burst over each [lo, hi) of
    `bursts` (the _loud_pcm pattern of tests/test_sharded_decoder.py):
    int PCM [n_total, nch]."""
    from iamf_tpu_torch.tools import streams

    pcm = streams.sine_pcm(n_total, nch, 48000, amp=0.4, bits=16, seed=3)
    for lo, hi in bursts:
        burst = streams.sine_pcm(hi - lo, nch, 48000, amp=1.45, bits=16,
                                 seed=4)
        pcm[lo:hi] = np.clip(burst, -32768, 32767)
    return pcm


def _loud_planar(n_total, nch, burst_lo, burst_hi):
    """_loud_pcm with one burst, planar float32 [nch, n_total] at full
    scale 1.0."""
    pcm = _loud_pcm(n_total, nch, [(burst_lo, burst_hi)])
    return (pcm.T / 32768.0).astype(np.float32)


def _limiter_calls(dev, stream, kw):
    """(cfg, state, x) of every limiter call in a card decode of `stream` at
    batch_frames=128: the main path's batches as they are, with the stream
    axis of one decoder (S = 1)."""
    from iamf_tpu_torch.core import pipeline as ppipe
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

    calls = []
    real = ppipe.limit_quantize

    def spy(cfg, state, x, bits, frame):
        calls.append((cfg, {k: v.clone() for k, v in state.items()},
                      x.clone()))
        return real(cfg, state, x, bits, frame)

    ppipe.limit_quantize = spy
    try:
        BatchedStreamDecoder(stream, batch_frames=B_MAIN, device=dev,
                             **kw).decode_all()
    finally:
        ppipe.limit_quantize = real
    return calls


def k3_check(label, cfg, state, x, plain_ms=None):
    """K3 against its twin (on a CPU copy: its per-sample loop on the card
    would be a launch per sample, which is what K3 replaces) from the same
    state: the output and the new state must be equal bit for bit. Returns
    (max |diff| in LSB, the twin's host ms, the twin's new state)."""
    from iamf_tpu_torch.dsp import limiter

    new_d, q_d = limiter.limit_quantize_cuda(cfg, state, x, 16)
    st_c = {k: v.cpu() for k, v in state.items()}
    t = time.perf_counter()
    new_p, q_p = limiter.limit_quantize(cfg, st_c, x.cpu(), 16, FRAME)
    twin_ms = (time.perf_counter() - t) * 1e3
    err = int((q_d.cpu().to(torch.int32) - q_p.to(torch.int32)).abs().max())
    env_d = new_d["env"].cpu().numpy().view(np.int32)
    env_p = new_p["env"].numpy().view(np.int32)
    same = all(torch.equal(new_d[k].cpu(), new_p[k])
               for k in ("delay_data", "peak_data", "entry_index"))
    print(f"K3 {label}: int16 max|diff| {err} (bound 0), env bit-equal "
          f"{bool((env_d == env_p).all())}, env {new_p['env'].tolist()}, "
          f"delay line and ring equal {same}")
    check(err == 0 and (env_d == env_p).all() and same,
          f"K3 disagrees with its plain twin ({label})")
    return err, twin_ms, new_p


def k3_phase(dev, tag, lib):
    from iamf_tpu_torch.dsp import limiter
    from iamf_tpu_torch.tools import streams

    counts = sass_counts(lib, "gain_walk", ("MUFU.RCP", "UBLKCP", "SYNCS"))
    print(f"K3 gain_walk SASS: {counts}")
    check(counts["MUFU.RCP"] == 0, f"a division is left in the walk: {counts}")

    N = B_MAIN * FRAME
    row = dict(name="k3_limiter_quantize", max_abs_err=0.0)
    # a burst across the edge between two [12, N] batches: attack in the
    # first, release (200 ms) running on into the second
    x = torch.from_numpy(_loud_planar(2 * N, LANES, N - 4 * FRAME,
                                      N + 2 * FRAME)[None]).to(dev)
    cfg = limiter.LimiterConfig(channels=LANES)
    st = {k: v[None] for k, v in limiter.init_state(cfg, dev).items()}
    err, _, st1 = k3_check("[12, N] attack batch", cfg, st, x[..., :N])
    err2, _, _ = k3_check("[12, N] release batch", cfg,
                          {k: v.to(dev) for k, v in st1.items()},
                          x[..., N:])
    row["max_abs_err"] = float(max(err, err2))

    L714 = streams.ChannelLayout.L714
    cases = {
        # the binaural 30 s cell's second limiter batch: C = 2, retriggering
        # every ~1.6 samples
        "engaged": _limiter_calls(dev, streams.build_pcm_layout_stream(
            L714, n_frames=2 * B_MAIN, amp=0.5, hrm=1)[0],
            dict(binaural=True))[1],
        # the PCM 30 s cell's second batch: C = 12, below the threshold
        "idle": _limiter_calls(dev, streams.build_pcm_layout_stream(
            L714, n_frames=2 * B_MAIN, amp=0.5)[0], dict(sound_system=9))[1],
    }
    for name, (cfg, st, x) in cases.items():
        C = x.shape[1]
        err, twin_ms, new_p = k3_check(f"{name} [{C}, {N}]", cfg, st, x)
        check((float(new_p["env"][0, 3]) != -1.0) == (name == "engaged"),
              f"K3 {name}: the envelope is {new_p['env'].tolist()}")
        row["max_abs_err"] = max(row["max_abs_err"], float(err))
        ms = cuda_ms(lambda: limiter.limit_quantize_cuda(cfg, st, x, 16))
        dev_ms, per = device_ms(
            lambda: limiter.limit_quantize_cuda(cfg, st, x, 16), f"K3 {name}")
        walk = sum(v for k, v in per.items() if "gain_walk" in k)
        out = torch.empty((N, C), dtype=torch.int16)
        D = cfg.delay_size
        # bytes: x, the state in and out, the int16 output; operations: per
        # sample the channel max, 3 for the sliding window max (van Herk /
        # Gil-Werman: a prefix and a suffix max per block of D, then one max
        # of the two), ~10 for the recurrence, 3 per output sample for the
        # quantize
        b = bound(nbytes(x, out) + 2 * (4 * C * D + 4 * D + 4 + 16),
                  N * (2 * C + 3 + 10 + 3 * C), FP32_FLOPS)
        print(f"K3 {name} [{C}, {N}]: {ms:.4f} ms per call, device "
              f"{dev_ms:.4f} ms, gain walk {walk:.4f} ms (the first design's "
              f"walk: {OLD_WALK_MS[name]} ms); bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}); plain twin on the host CPU "
              f"{twin_ms:.1f} ms {tag}")
        if name == "engaged":
            row.update(ms=ms, plain_ms=twin_ms, library_ms=None, **b)
    return row


# --- phase 3 / 4: the decode path ----------------------------------------------

def opus_phase(dev, tag, kernels):
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

    data = open(os.path.join(ROOT, "iamf_tpu", "data",
                             "sample_opus_714.iamf"), "rb").read()
    golden = np.load(os.path.join(ROOT, "iamf_tpu_torch", "data",
                                  "sample_opus_714_ssJ.npz"))["pcm"]

    def decode():
        return BatchedStreamDecoder(data, sound_system=9, batch_frames=8,
                                    device=dev).decode_all()

    decode()  # warm-up
    for k in kernels:
        k.reset()
    out = decode()
    launches = {k.symbol: k.launches for k in kernels}
    plain = {k.symbol: k.plain_on_cuda for k in kernels}
    walls = timed(decode, 7)
    d = np.abs(out.astype(np.int32) - golden.astype(np.int32))
    secs = out.shape[0] / 48000.0
    print(f"opus sample -> ssJ: shape {out.shape}, max|diff| vs golden "
          f"{int(d.max())} LSB ({int((d > 0).sum())} samples differ); "
          f"launches {launches}; plain twins on CUDA {plain}")
    print(f"opus sample realtime factor {secs / np.median(walls):.2f}x "
          f"(median of {len(walls)}; {secs:.3f} s audio in "
          f"{_ms(walls)} ms wall, batch_frames=8) {tag}")
    check(out.shape == golden.shape and int(d.max()) <= 1,
          f"opus decode disagrees with the golden: {int(d.max())} LSB")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path did not launch: {launches}")
    check(not any(plain.values()), f"a plain twin ran on CUDA: {plain}")
    return launches


def pcm_phase(dev, tag):
    from iamf_tpu_torch.tools import streams
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

    L714 = streams.ChannelLayout.L714

    def run(stream, device, bf):
        return BatchedStreamDecoder(stream, sound_system=9, batch_frames=bf,
                                    device=device).decode_all()

    n30 = 1500  # 30 s of 960-sample frames
    stream, _ = streams.build_pcm_layout_stream(
        L714, n_frames=n30, amp=0.5)
    got = run(stream, dev, B_MAIN)  # also the warm-up
    walls = timed(lambda: run(stream, dev, B_MAIN), 5)
    want = run(stream, "cpu", B_MAIN)
    d = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    secs = got.shape[0] / 48000.0
    print(f"pcm 7.1.4 30 s -> ssJ: shape {got.shape}, max|diff| vs CPU run "
          f"{d} LSB")
    print(f"pcm 30 s realtime factor {secs / np.median(walls):.2f}x "
          f"(median of {len(walls)}; {secs:.3f} s audio in {_ms(walls)} ms "
          f"wall, batch_frames={B_MAIN}) {tag}")
    check(got.shape == want.shape and d <= 1, f"pcm decode: {d} LSB")

    n_loud = 40
    # burst across the edge of the 16-frame batches at frame 16
    loud = (_loud_planar(n_loud * FRAME, 12, 14 * FRAME, 18 * FRAME).T
            * 32768.0).round().astype(np.int64)
    stream, _ = streams.build_pcm_layout_stream(
        L714, n_frames=n_loud, pcm_override=loud)
    got = run(stream, dev, 16)
    want = run(stream, "cpu", 16)
    d = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    peak = int(np.abs(want.astype(np.int32)).max())
    print(f"pcm loud stream (limiter engaged, peak {peak}): max|diff| vs "
          f"CPU run {d} LSB")
    check(got.shape == want.shape and d <= 1, f"loud pcm decode: {d} LSB")
    check(28000 <= peak < 29300, f"limiter did not engage: peak {peak}")


# --- phase 5: the output paths' kernels --------------------------------------

def _twin_times(tag, name, fast, plain, reps=20, plain_reps=20):
    ms = cuda_ms(fast, reps=reps)
    plain_ms = cuda_ms(plain, reps=plain_reps, warm=1)
    dev_ms, _ = device_ms(fast, name, reps=reps)
    dev_plain, _ = device_ms(plain, f"{name}'s twin", reps=plain_reps)
    print(f"{name} time {ms:.4f} ms per call, plain twin {plain_ms:.4f} ms; "
          f"device time per call {dev_ms:.4f} ms, twin {dev_plain:.4f} ms "
          f"{tag}")
    return ms, plain_ms


def k8_inputs(C, B, dev):
    """K8's inputs for a C-channel bed (12: 7.1.4, 10: 7.1.2) of B frames:
    (the layout's Hrir for batches of B, x [1, C, B*960], a live carry
    [1, 2, 255]: one stream)."""
    from iamf_tpu_torch.tools import streams
    from iamf_tpu_torch.dsp import binaural

    layout = {12: streams.ChannelLayout.L714,
              10: streams.ChannelLayout.L712}[C]
    rng = np.random.RandomState(C * 1000 + B)
    h = binaural.hrir_for_batch(binaural.hrir_bank(layout), B, FRAME, dev)
    x = torch.from_numpy((rng.randn(1, C, B * FRAME) * 0.3).astype(
        np.float32)).to(dev)
    ov = torch.from_numpy((rng.randn(1, 2, 255) * 0.1).astype(
        np.float32)).to(dev)
    return h, x, ov


def k8_phase(dev, tag):
    from iamf_tpu_torch.dsp import binaural

    row = dict(name="k8_hrtf_conv", max_abs_err=0.0)
    for C in (12, 10):
        for B in (B_MAIN, 3):
            h, x, ov = k8_inputs(C, B, dev)
            y, o = binaural.hrtf_conv_cuda(h, x, ov)
            y_p, o_p = binaural.hrtf_conv_plain(h, x, ov)
            torch.cuda.synchronize()
            err = max(float((y - y_p).abs().max()),
                      float((o - o_p).abs().max()))
            print(f"K8 hrtf conv [C={C}, B={B}]: max|diff| {err:.3e} "
                  "(bound 1e-4, unit scale)")
            check(err <= 1e-4, f"K8 disagrees with its plain twin: {err}")
            ms, plain = _twin_times(
                tag, f"K8 [C={C}, B={B}]",
                lambda: binaural.hrtf_conv_cuda(h, x, ov),
                lambda: binaural.hrtf_conv_plain(h, x, ov))
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if (C, B) == (LANES, B_MAIN):
                ops = fft_conv_ops(C, 2, B * FRAME, 256)
                b = bound(nbytes(x, h.bank, ov, y, o), ops, FP32_FLOPS)
                lib_ms = k8_library(tag, h, x, ov, y_p, o_p)
                print(f"K8 bound [C={C}, B={B}] {b['bound_ms']:.4f} ms "
                      f"({b['bound_by']}; {ops / 1e6:.1f} M flops by FFT, "
                      f"{4 * C * 256 * B * FRAME / 1e6:.1f} M direct)")
                row.update(ms=ms, plain_ms=plain, library_ms=lib_ms, **b)
    return row


def fft_conv_ops(c_in, c_out, n, taps):
    """The fewest fp32 operations of the convolution of c_in channels of n
    samples with c_in x c_out filters of `taps` taps, summed into c_out
    outputs: overlap-save with real FFTs of F points (2.5 F log2 F each),
    one per input and output block, a complex multiply-add (8) per bin,
    input channel and output, and the filters' own transforms once; the
    least over F."""
    best = math.inf
    for k in range(int(math.log2(taps)) + 1, 17):
        F = 1 << k
        fft = 2.5 * F * k
        blocks = math.ceil(n / (F - taps + 1))
        best = min(best, c_in * c_out * fft + blocks * (
            (c_in + c_out) * fft + 8 * c_in * c_out * (F // 2 + 1)))
    return best


def k8_library(tag, h, x, ov, y_p, o_p):
    """The one PyTorch call computing K8's convolution: F.conv1d (cuDNN,
    fp32, TF32 off) of the bed with the time-reversed HRIR bank, padded by
    taps - 1 on both sides; the carried overlap is added to its head.
    Checked against K8's twin first; returns its ms per call (CUDA
    events)."""
    import torch.nn.functional as F

    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    taps = h.bank.shape[2]
    w = h.bank.flip(-1).contiguous()
    full = F.conv1d(x, w, padding=taps - 1)
    full[..., :taps - 1] += ov
    N = x.shape[2]
    err = max(float((full[..., :N] - y_p).abs().max()),
              float((full[..., N:] - o_p).abs().max()))
    print(f"F.conv1d yardstick for K8: max|diff| vs twin {err:.3e} "
          f"(bound 1e-4)")
    check(err <= 1e-4, f"F.conv1d disagrees with K8's twin: {err}")
    ms = cuda_ms(lambda: F.conv1d(x, w, padding=taps - 1))
    dev, per = device_ms(lambda: F.conv1d(x, w, padding=taps - 1),
                         "F.conv1d for K8")
    top = max(per, key=per.get) if per else "none"
    print(f"F.conv1d [{x.shape[1]} -> 2, {N}]: {ms:.4f} ms per call, "
          f"device {dev:.4f} ms ({top[:60]}) {tag}")
    return ms


def k10_inputs(rate, secs, dev):
    """K10's inputs: (the rate's plan, x [12, rate * secs] at 0.3 RMS)."""
    from iamf_tpu_torch.dsp import resample

    rng = np.random.RandomState(rate % 1009)
    x = torch.from_numpy((rng.randn(LANES, int(rate * secs)) * 0.3).astype(
        np.float32)).to(dev)
    return resample.ResamplePlan(rate, 48000, device=dev), x


# K10's output at 44.1 kHz, 30 s x 12 ch, from a tree that
# `perf/k8_k10.py times --tree DIR --save` timed (e.g. the parent commit)
K10_PARENT = os.path.join(ROOT, "perf", "build", "k10_parent.pt")


def k10_library(tag, plan, x, y_p):
    """The one PyTorch call computing K10's function: F.conv1d (cuDNN,
    fp32, TF32 off) with stride num of the zero-padded input, channels as
    the batch, into den output channels, one per output phase r, each
    holding its bank row at a_r = num*r // den (the output is periodic:
    y[c, den*m + r] = sum_f xz[c, num*m + D + a_r + f] bank[(num*r) % den,
    f]); a transpose and the clip follow, untimed. Checked against K10's
    twin first; returns its ms per call (CUDA events)."""
    import torch.nn.functional as F

    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    num, den, N = plan.num, plan.den, plan.N
    a = num * np.arange(den) // den
    w = np.zeros((den, 1, int(a.max()) + N), np.float32)
    bank = plan.bank.cpu().numpy()
    for r in range(den):
        w[r, 0, a[r]:a[r] + N] = bank[(num * r) % den]
    w = torch.from_numpy(w).to(x.device)
    C, T = x.shape
    n = y_p.shape[1]
    m = -(-n // den)
    right = max(0, num * (m - 1) + plan.lead + w.shape[2] - T)
    xz = F.pad(x, (-plan.lead, right))[:, None]  # plan.lead < 0

    def conv():
        return F.conv1d(xz, w, stride=num)

    y = conv().transpose(1, 2).reshape(C, -1)[:, :n].clamp(-1.0, 1.0)
    err = float((y - y_p).abs().max())
    print(f"F.conv1d yardstick for K10 [{den} phases x {w.shape[2]} taps, "
          f"stride {num}]: max|diff| vs twin {err:.3e} (bound 1e-5)")
    check(err <= 1e-5, f"F.conv1d disagrees with K10's twin: {err}")
    ms = cuda_ms(conv)
    dev_ms, per = device_ms(conv, "F.conv1d for K10")
    top = max(per, key=per.get) if per else "none"
    print(f"F.conv1d [{C}, {T}] -> [{C}, {den}, {m}]: {ms:.4f} ms per "
          f"call, device {dev_ms:.4f} ms ({top[:60]}) {tag}")
    return ms


def k10_k3_phase(dev, tag):
    from iamf_tpu_torch.dsp import limiter, resample

    row = dict(name="k10_resample", max_abs_err=0.0)
    for rate, secs in ((44100, 30.0), (16000, 0.5), (32000, 0.5),
                       (96000, 0.5), (22050, 0.5), (11025, 0.5),
                       (88200, 0.5)):
        plan, x = k10_inputs(rate, secs, dev)
        n_in = x.shape[1]
        y = resample.resample_cuda(plan, x)
        y_p = resample.resample_plain(plan, x)
        torch.cuda.synchronize()
        err = float((y - y_p).abs().max())
        print(f"K10 resample {rate} -> 48000 [{LANES}, {n_in}] -> "
              f"{y.shape[1]} (N={plan.N}): max|diff| {err:.3e} "
              "(bound 1e-5)")
        check(err <= 1e-5, f"K10 disagrees with its plain twin: {err}")
        main = rate == 44100
        ms, plain = _twin_times(
            tag, f"K10 [{rate}, {secs} s]",
            lambda: resample.resample_cuda(plan, x),
            lambda: resample.resample_plain(plan, x),
            plain_reps=5 if main else 20)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if main:
            # bytes: the input, the output and the per-phase bank; 64 taps
            # a phase: a multiply-add per tap and output
            b = bound(nbytes(x, y, plan.bank), 2 * plan.N * y.numel(),
                      FP32_FLOPS)
            lib_ms = k10_library(tag, plan, x, y_p)
            print(f"K10 bound [{rate}, {secs} s] {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']})")
            if os.path.exists(K10_PARENT):
                y0 = torch.load(K10_PARENT).to(dev)
                print(f"K10 [{rate}, {secs} s] equal to the output of "
                      f"perf/k8_k10.py's other tree: {torch.equal(y, y0)} "
                      f"(max|diff| {float((y - y0).abs().max()):.3e})")
            row.update(ms=ms, plain_ms=plain, library_ms=lib_ms, **b)

    # K3 over a whole resampled stream, as the resample tail calls it:
    # 30 s at 48 kHz plus the delay_size drain, one call; a sine bed with a
    # +4 dB burst of 1 s (attack, then a 200 ms release)
    n = 48000 * 30
    xs = torch.from_numpy(np.concatenate(
        [_loud_planar(n, LANES, n // 2, n // 2 + 48000),
         np.zeros((LANES, 240), np.float32)], axis=1))
    cfg = limiter.LimiterConfig(channels=LANES)
    x_d = xs.to(dev)[None]
    st = {k: v[None] for k, v in limiter.init_state(cfg, dev).items()}
    _, plain_ms, _ = k3_check(f"over a 30 s stream [{LANES}, "
                              f"{xs.shape[1]}] with a +4 dB burst", cfg, st,
                              x_d)
    ms = cuda_ms(lambda: limiter.limit_quantize_cuda(cfg, st, x_d, 16),
                 reps=5, warm=1)
    dev_ms, per = device_ms(
        lambda: limiter.limit_quantize_cuda(cfg, st, x_d, 16), "K3 after K10",
        reps=5)
    walk = sum(v for k, v in per.items() if "gain_walk" in k)
    print(f"K3 [{LANES}, {xs.shape[1]}] time {ms:.4f} ms per call, device "
          f"{dev_ms:.4f} ms (gain walk {walk:.4f} ms); plain twin on the "
          f"host CPU {plain_ms:.1f} ms {tag}")
    return row


# --- phase 8: the AAC filterbank and the true-peak meter ---------------------

K7_CASES = np.array([(q, h, p) for q in range(4) for h in range(2)
                     for p in range(2)], np.int32)


def k7_inputs(B, dev, seed):
    """K7's inputs: spectra [B, 12, 1024] at the scale of the AAC cell's
    (PCM peaks of a few thousand), each row's (sequence, shape, previous
    shape) drawn from all 16 (a quarter of the rows EIGHT_SHORT), a live
    carry."""
    rng = np.random.RandomState(seed)
    spec = torch.from_numpy((rng.randn(B, LANES, 1024) * 3000.0).astype(
        np.float32)).to(dev)
    meta = torch.from_numpy(K7_CASES[rng.randint(16, size=(B, LANES))]).to(
        dev)
    carry = torch.from_numpy((rng.randn(LANES, 1024) * 3000.0).astype(
        np.float32)).to(dev)
    return spec, meta, carry


def imdct_ops(meta) -> float:
    """The fewest fp32 operations of K7's function on these rows: an FFT
    IMDCT (fft_imdct_flops) per long row (n = 2048) and eight per short
    row (n = 256); a multiply per windowed sample, an add per overlapped
    one inside a short frame; an add and 4 for the rounding per output
    sample."""
    short = int((meta[..., 0] == 2).sum())
    rows = meta[..., 0].numel()
    return ((rows - short) * (fft_imdct_flops(2048) + 2048)
            + short * (8 * fft_imdct_flops(256) + 2048 + 7 * 128)
            + rows * 1024 * 5)


def k7_library(tag, tabs, spec):
    """The one PyTorch call K7 is held against: torch.matmul (cuBLAS fp32,
    TF32 off) of the long product, [B*L, 1024] x [1024, 2048], over the
    same rows (the twin's route). Returns its ms per call (CUDA events)."""
    check(not torch.backends.cuda.matmul.allow_tf32, "matmul TF32 is on")
    x, b = spec.reshape(-1, 1024), tabs.b_long()

    def mm():
        return torch.matmul(x, b)

    ms = cuda_ms(mm)
    dev_ms, _ = device_ms(mm, "torch.matmul for K7")
    print(f"torch.matmul yardstick for K7 [{x.shape[0]}, 1024] x [1024, "
          f"2048]: {ms:.4f} ms per call, device {dev_ms:.4f} ms {tag}")
    return ms


def k7_phase(dev, tag, lib):
    from iamf_tpu_torch.codecs.aac import synth as aac

    counts = sass_counts(lib, "k7_synth", ("LDL", "STL"))
    print(f"K7 kernel SASS local memory instructions: {counts}")
    check(not any(counts.values()), f"K7 spills to local memory: {counts}")
    tabs = aac.Tables().to(dev)
    fill = aac.k7_fill(dev)
    row = dict(name="k7_aac_synth", max_abs_err=0.0)
    for B in (B_MAIN, B_OPUS):
        _, _, c_d = k7_inputs(B, dev, B)
        c_p = c_d
        for call in range(2):  # the carry chained from one call to the next
            spec, meta, _ = k7_inputs(B, dev, 10 * B + call)
            n0 = aac.K7.launches
            y, c_d = aac.synthesize_cuda(tabs, spec, meta, c_d)
            check(aac.K7.launches == n0 + 1, "K7 counted other than once")
            y_p, c_p = aac.synthesize_plain(tabs, spec, meta, c_p)
            torch.cuda.synchronize()
            lsb = float((y - y_p).abs().max()) * 32768
            err = float((c_d - c_p).abs().max())
            print(f"K7 aac synth [B={B}, L={LANES}] call {call + 1}: PCM "
                  f"max|diff| {lsb:.0f} LSB (bound 1), unrounded carry "
                  f"max|diff| {err:.3e} at s16 scale (bound 0.25)")
            check(lsb <= 1 and err < 0.25,
                  f"K7 disagrees with its plain twin: {lsb} LSB, {err}")
            row["max_abs_err"] = max(row["max_abs_err"], err)

        def k7():
            return aac.synthesize_cuda(tabs, spec, meta, c_d)

        ms = cuda_ms(k7)
        plain = cuda_ms(lambda: aac.synthesize_plain(tabs, spec, meta, c_d))
        dev_ms, _ = device_ms(k7, f"K7 [B={B}]")
        n_dev = device_launches(k7)
        check(n_dev == 1, f"K7 made {n_dev} device launches a call")
        dev_plain, _ = device_ms(
            lambda: aac.synthesize_plain(tabs, spec, meta, c_d),
            f"K7's twin [B={B}]")
        print(f"K7 time [B={B}] {ms:.4f} ms per call, plain twin "
              f"(torch.matmul fp32, both paths) {plain:.4f} ms; device time "
              f"per call {dev_ms:.4f} ms in {n_dev} launch "
              f"(run {aac.k7_run(B, LANES, fill)} of {fill} warps the card "
              f"holds), twin {dev_plain:.4f} ms {tag}")
        if B == B_MAIN:
            ops = imdct_ops(meta)
            b = bound(nbytes(spec, meta, c_d, y, c_d), ops, FP32_FLOPS)
            R = B * LANES
            mm = 2 * R * 1024 * 2048
            print(f"K7 bound [B={B}] {b['bound_ms']:.4f} ms ({b['bound_by']}"
                  f"; {ops / 1e6:.1f} M flops by FFT IMDCTs); the product "
                  f"as the reference computes it: {mm / 1e9:.2f} GFLOP, "
                  f"{3 * mm / 1e9:.1f} G in split TF32 = "
                  f"{3 * mm / TF32_FLOPS * 1e3:.4f} ms at the TF32 peak")
            lib_ms = k7_library(tag, tabs, spec)
            row.update(ms=ms, plain_ms=plain, library_ms=lib_ms, **b)
    return row


def k9_library(tag, x, hist, pk_p):
    """The one PyTorch call computing K9's FIR: F.conv1d (cuDNN, fp32, TF32
    off) of each channel's history ++ x with the four phases' time-reversed
    taps [4, 1, 12]; the maximum over channels and phases, untimed,
    checked against K9's twin. Returns its ms per call (CUDA events)."""
    import torch.nn.functional as F

    from iamf_tpu_torch.dsp import limiter

    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    w = torch.from_numpy(limiter.truepeak_filters()[:, None, ::-1].copy()
                         ).to(x.device)
    xc = torch.cat([hist, x], dim=2)[0, :, None]  # one stream's channels

    def conv():
        return F.conv1d(xc, w)

    pk = conv().abs().amax(dim=(0, 1))
    err = float((pk - pk_p[0]).abs().max())
    print(f"F.conv1d yardstick for K9 [{x.shape[1]}, 4 phases x 12 taps]: "
          f"max|diff| vs twin {err:.3e} (bound 1e-6)")
    check(err <= 1e-6, f"F.conv1d disagrees with K9's twin: {err}")
    ms = cuda_ms(conv)
    dev_ms, _ = device_ms(conv, "F.conv1d for K9")
    print(f"F.conv1d [{x.shape[1]}, {x.shape[2]}]: {ms:.4f} ms per call, "
          f"device {dev_ms:.4f} ms {tag}")
    return ms


def truepeak_ops(C: int, N: int) -> float:
    """The fewest fp32 operations of K9's function on [C, N]: per sample
    and channel, a multiply per nonzero tap of each phase whose taps are
    not another phase's reversed (a reversed phase's products are those
    of its mirror at other samples), an add per nonzero tap of each
    phase but its first, and a maximum per phase. From the tap table:
    23 multiplies, 42 adds, 4 maxima."""
    from iamf_tpu_torch.dsp import limiter

    h = limiter.truepeak_filters()
    nz = (h != 0).sum(axis=1)
    mirrored = [any(np.array_equal(h[p].view(np.uint32),
                                   h[q, ::-1].view(np.uint32))
                    for q in range(p)) for p in range(len(h))]
    muls = sum(int(n) for n, m in zip(nz, mirrored) if not m)
    adds = int((nz - 1).sum())
    return float((muls + adds + len(h)) * C * N)


def k9_inputs(C, dev):
    """K9's inputs for one stream at [1, C, 128·960]: a nonzero history
    [1, C, 11] and two batches."""
    from iamf_tpu_torch.dsp import limiter

    rng = np.random.RandomState(C)
    hist = torch.from_numpy((rng.randn(1, C, limiter.TP_HIST) * 0.5
                             ).astype(np.float32)).to(dev)
    xs = [torch.from_numpy((rng.randn(1, C, B_MAIN * FRAME) * 0.3).astype(
        np.float32)).to(dev) for _ in range(2)]
    return hist, xs


def k9_phase(dev, tag, lib):
    from iamf_tpu_torch.dsp import limiter

    counts = sass_counts(lib, "k9_truepeak", ("LDL", "STL", "FMUL", "FADD",
                                              "FFMA"))
    print(f"K9 kernel SASS: {counts}")
    check(not (counts["LDL"] or counts["STL"] or counts["FFMA"]),
          f"K9 spills to local memory or fuses a multiply-add: {counts}")

    row = dict(name="k9_truepeak", max_abs_err=0.0)
    N = B_MAIN * FRAME
    for C in (LANES, 2):
        hist, xs = k9_inputs(C, dev)
        h_d = h_p = hist
        for call, x in enumerate(xs):  # the history chained from batch 1
            pk, h_d = limiter.truepeak_cuda(x, h_d)
            pk_p, h_p = limiter.truepeak_plain(x, h_p)
            torch.cuda.synchronize()
            err = float((pk - pk_p).abs().max())
            tol = float(pk_p.abs().max()) * 2.0 ** -23
            print(f"K9 true peak [C={C}, N={N}] batch {call + 1}: max|diff| "
                  f"{err:.3e} (bound {tol:.3e}, one rounding), bit-equal "
                  f"{torch.equal(pk, pk_p)}, history equal "
                  f"{torch.equal(h_d, h_p)}")
            check(err <= tol and torch.equal(h_d, h_p),
                  f"K9 disagrees with its plain twin: {err}")
            row["max_abs_err"] = max(row["max_abs_err"], err)
        h0 = h_d
        ms, plain = _twin_times(
            tag, f"K9 [C={C}, N={N}]",
            lambda: limiter.truepeak_cuda(x, h0),
            lambda: limiter.truepeak_plain(x, h0))
        n_dev = device_launches(lambda: limiter.truepeak_cuda(x, h0))
        print(f"K9 [C={C}, N={N}]: {n_dev} device launch a call")
        check(n_dev == 1, f"K9 made {n_dev} device launches a call")
        if C == LANES:
            ops = truepeak_ops(C, N)
            moved = nbytes(x, h0, pk, h_d)
            dense = 2 * limiter.TP_PHASES * limiter.TP_TAPS * C * N / 1e6
            b = bound(moved, ops, FP32_FLOPS)
            print(f"K9 bound [C={C}, N={N}] {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']}; {moved / 1e6:.2f} MB, "
                  f"{ops / 1e6:.1f} M flops "
                  f"of distinct products, sums and maxima; the dense FIR's "
                  f"{dense:.1f} M)")
            lib_ms = k9_library(tag, x, h0, limiter.truepeak_plain(x, h0)[0])
            row.update(ms=ms, plain_ms=plain, library_ms=lib_ms, **b)
    return row


# --- phases 9 / 10: the AAC and true-peak decode paths ------------------------

def aac_phase(dev, tag, kernels, off_path):
    from iamf_tpu_torch.codecs.aac.synth import K7
    from iamf_tpu_torch.dsp.limiter import K3
    from iamf_tpu_torch.tools import streams

    L = streams.ChannelLayout
    t = time.perf_counter()
    stream, _ = streams.build_aac_layout_stream(L.L714, n_frames=1407,
                                                seed=5)
    print(f"aac 7.1.4 30 s stream: {len(stream)} bytes, built in "
          f"{time.perf_counter() - t:.1f} s")
    launches = decode_path(
        dev, tag, "aac 7.1.4 30 s -> ssJ", stream,
        dict(sound_system=9, batch_frames=B_MAIN), kernels, (K7, K3),
        off_path)
    data = streams.build_aac_layout_stream(L.L510, n_frames=40, seed=6,
                                           gain_offset=8)[0]
    decode_path(dev, tag, "aac 5.1 loud (limiter engaged)", data,
                dict(sound_system=1, batch_frames=8), kernels, (K7, K3),
                off_path)
    return launches


def truepeak_phase(dev, tag, kernels, off_path):
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
    from iamf_tpu_torch.dsp.limiter import K3, K9
    from iamf_tpu_torch.tools import streams

    L = streams.ChannelLayout
    stream, _ = streams.build_pcm_layout_stream(
        L.L714, n_frames=1500, pcm_override=streams.isp_tone_pcm(1500, 12))
    kw = dict(sound_system=9, batch_frames=B_MAIN)
    sample = BatchedStreamDecoder(stream, device=dev, **kw).decode_all()
    old = os.environ.get("IAMF_TRUEPEAK")
    os.environ["IAMF_TRUEPEAK"] = "1"
    try:
        launches = decode_path(
            dev, tag, "pcm 7.1.4 30 s true peak -> ssJ", stream, kw,
            kernels, (K9, K3), off_path)
        got = BatchedStreamDecoder(stream, device=dev, **kw).decode_all()
    finally:
        if old is None:
            del os.environ["IAMF_TRUEPEAK"]
        else:
            os.environ["IAMF_TRUEPEAK"] = old
    d = int(np.abs(got.astype(np.int32) - sample.astype(np.int32)).max())
    peak = [int(np.abs(a.astype(np.int32)).max()) for a in (sample, got)]
    print(f"true peak vs sample peak decode: max|diff| {d}; peaks "
          f"{peak[0]} (sample-peak limiter) and {peak[1]} (true-peak)")
    check(d > 500, f"the true-peak meter did not engage: {d}")
    return launches


# --- phases 6 / 7: the binaural and resampled decode paths --------------------

def trace_decode(fn, label):
    """One decode under torch.profiler: wall, device time (every kernel,
    copy and memset), busy share, and the largest device items."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only: a CPU op's device time repeats its kernels'
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    per = sorted(((ev.self_device_time_total / 1e3, ev.key)
                  for ev in prof.key_averages()
                  if ev.self_device_time_total > 0), reverse=True)
    busy = sum(v for v, _ in per)
    top = "; ".join(f"{k[:48]} {v:.3f}" for v, k in per[:8])
    print(f"{label} trace: wall {wall:.1f} ms under the profiler, device "
          f"{busy:.2f} ms, busy {100 * busy / wall:.1f} %; top (ms): {top}")
    return 100 * busy / wall


def decode_path(dev, tag, label, data, kw, kernels, must, must_not=()):
    """Decode `data` on the card (warm-up, a counted run, 5 timed runs, a
    traced run) and on the CPU; <= 1 LSB, same shape. Returns the counted
    run's launches."""
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

    def run(device):
        return BatchedStreamDecoder(data, device=device, **kw).decode_all()

    run(dev)  # warm-up
    for k in kernels:
        k.reset()
    got = run(dev)
    launches = {k.symbol: k.launches for k in kernels}
    plain = {k.symbol: k.plain_on_cuda for k in kernels}
    want = run("cpu")
    d = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    secs = got.shape[0] / 48000.0
    print(f"{label}: shape {got.shape}, max|diff| vs CPU run {d} LSB, peak "
          f"{int(np.abs(want.astype(np.int32)).max())}; launches {launches}; "
          f"plain twins on CUDA {plain}")
    check(got.shape == want.shape and d <= 1, f"{label}: {d} LSB")
    check(all(launches[k.symbol] > 0 for k in must),
          f"{label}: a kernel of the path did not launch: {launches}")
    check(all(launches[k.symbol] == 0 for k in must_not),
          f"{label}: an off-path kernel launched: {launches}")
    check(not any(plain.values()), f"{label}: a plain twin ran on CUDA")
    if secs >= 10:
        walls = timed(lambda: run(dev), 5)
        print(f"{label} realtime factor {secs / np.median(walls):.2f}x "
              f"(median of {len(walls)}; {secs:.3f} s audio in "
              f"{_ms(walls)} ms wall, batch_frames="
              f"{kw['batch_frames']}) {tag}")
        trace_decode(lambda: run(dev), label)
    return launches


def binaural_phase(dev, tag, kernels):
    from iamf_tpu_torch.tools import streams
    from iamf_tpu_torch.dsp.binaural import K8
    from iamf_tpu_torch.dsp.limiter import K3
    from iamf_tpu_torch.dsp.resample import K10

    L = streams.ChannelLayout
    stream, _ = streams.build_pcm_layout_stream(L.L714, n_frames=1500,
                                                amp=0.5, hrm=1)
    launches = decode_path(
        dev, tag, "binaural 7.1.4 M2B 30 s", stream,
        dict(binaural=True, batch_frames=B_MAIN), kernels, (K8, K3), (K10,))
    short = {
        "binaural FOA H2B": (streams.build_ambisonics_pcm_stream(
            order=1, n_frames=40, target_layouts=(0,), hrm=1)[0], (K8,), ()),
        "binaural two elements M2B + H2B": (streams.build_two_element_stream(
            n_frames=40, gain2_q78=-(3 << 8), hrm=1)[0], (K8,), ()),
        "binaural 5.1 mode 0 (matrix)": (streams.build_pcm_51_stream(
            n_frames=40)[0], (K3,), (K8,)),
    }
    for label, (data, must, must_not) in short.items():
        decode_path(dev, tag, label, data,
                    dict(binaural=True, batch_frames=16), kernels, must,
                    must_not)
    return launches


def resample_phase(dev, tag, kernels):
    from iamf_tpu_torch.tools import streams
    from iamf_tpu_torch.dsp.binaural import K8
    from iamf_tpu_torch.dsp.limiter import K3
    from iamf_tpu_torch.dsp.resample import K10

    L = streams.ChannelLayout
    stream, _ = streams.build_pcm_layout_stream(
        L.L714, n_frames=1378, amp=0.5, rate=44100)
    launches = decode_path(
        dev, tag, "pcm 7.1.4 44.1 kHz 30 s -> ssJ", stream,
        dict(sound_system=9, batch_frames=B_MAIN), kernels, (K10, K3), (K8,))
    data = streams.build_pcm_51_stream(n_frames=40, rate=44100)[0]
    decode_path(dev, tag, "pcm 5.1 44.1 kHz, normalization -10 dB", data,
                dict(sound_system=1, batch_frames=16,
                     normalization_db=-10.0), kernels, (K10, K3))
    decode_path(dev, tag, "pcm 5.1 44.1 kHz, no limiter", data,
                dict(sound_system=1, batch_frames=16, limiter=False),
                kernels, (K10,), (K3,))
    return launches


# --- phase 11: the stream axis of K3, K9 and K8; the lane fold of K1, K2, K7

S_FLEET = 4  # the full-width fleets' streams


def _k3_stream_case(dev, tag, name, calls):
    """K3 at S = 4 on four consecutive batches of a decode (each stream
    with the state its decode carried in) against four S = 1 calls on the
    card: 0 LSB and an equal state (the envelope bit for bit); device
    times side by side."""
    from iamf_tpu_torch.dsp import limiter

    cfg = calls[0][0]
    st = {k: torch.cat([c[1][k] for c in calls]) for k in calls[0][1]}
    x = torch.cat([c[2] for c in calls])
    S, C, N = x.shape
    new, q = limiter.limit_quantize_cuda(cfg, st, x, 16)
    worst, same = 0, True
    for s, (_, st1, x1) in enumerate(calls):
        new1, q1 = limiter.limit_quantize_cuda(cfg, st1, x1, 16)
        worst = max(worst, int((q[s:s + 1].int() - q1.int()).abs().max()))
        same &= all(torch.equal(new[k][s:s + 1].view(torch.int32),
                                new1[k].view(torch.int32)) for k in new)
    idle = [float(e) == -1.0 for e in new["env"][:, 3]]
    print(f"K3 {name} [{S}, {C}, {N}] against {S} S = 1 calls: int16 "
          f"max|diff| {worst} (bound 0), states bit-equal {same}; idle "
          f"after the batch {idle}")
    check(worst == 0 and same, f"K3 {name}: S = {S} differs from S = 1")
    check(not any(idle) if name == "engaged" else all(idle),
          f"K3 {name}: envelopes {new['env'].tolist()}")

    def k3_s():
        return limiter.limit_quantize_cuda(cfg, st, x, 16)

    def k3_1():
        return limiter.limit_quantize_cuda(cfg, calls[0][1], calls[0][2], 16)

    ms_s, ms_1 = cuda_ms(k3_s), cuda_ms(k3_1)
    dev_s, per_s = device_ms(k3_s, f"K3 {name} S={S}")
    dev_1, per_1 = device_ms(k3_1, f"K3 {name} S=1")
    walk_s = sum(v for k, v in per_s.items() if "gain_walk" in k)
    walk_1 = sum(v for k, v in per_1.items() if "gain_walk" in k)
    D = cfg.delay_size
    b = bound(nbytes(x, q) + 2 * S * (4 * C * D + 4 * D + 4 + 16),
              S * N * (2 * C + 3 + 10 + 3 * C), FP32_FLOPS)
    n_dev = device_launches(k3_s)
    print(f"K3 {name} S={S}: {ms_s:.4f} ms per call, device {dev_s:.4f} ms "
          f"(gain walk {walk_s:.4f} ms) in {n_dev} device launches; S=1: "
          f"{ms_1:.4f} ms per call, device {dev_1:.4f} ms (walk "
          f"{walk_1:.4f} ms); S={S} / S=1 device {dev_s / dev_1:.2f}x; bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {S}x the bytes of one "
          f"stream); the walk's latency floor is one stream's chain (the S "
          f"walks run side by side) {tag}")
    check(n_dev == 4, f"K3 made {n_dev} device launches at S = {S}")


def stream_axis_phase(dev, tag):
    """K3, K9 and K8 take S = 4 streams in one launch; K1, K2 and K7 take
    them folded into 48 lanes (batch_decoder.lane_synth). Each against S
    separate calls on the card."""
    from iamf_tpu_torch.codecs.aac import synth as aac
    from iamf_tpu_torch.codecs.opus import synth
    from iamf_tpu_torch.codecs.opus.imdct import K1
    from iamf_tpu_torch.core.batch_decoder import lane_synth
    from iamf_tpu_torch.dsp import binaural, limiter
    from iamf_tpu_torch.tools import streams

    L714 = streams.ChannelLayout.L714
    S, N = S_FLEET, B_MAIN * FRAME
    n = (S + 1) * B_MAIN
    _k3_stream_case(dev, tag, "engaged", _limiter_calls(
        dev, streams.build_pcm_layout_stream(L714, n_frames=n, amp=0.5,
                                             hrm=1)[0],
        dict(binaural=True))[1:S + 1])
    _k3_stream_case(dev, tag, "idle", _limiter_calls(
        dev, streams.build_pcm_layout_stream(L714, n_frames=n, amp=0.5)[0],
        dict(sound_system=9))[1:S + 1])

    # K9: four streams' batches and histories at [12, N]
    rng = np.random.RandomState(9)
    x = torch.from_numpy((rng.randn(S, LANES, N) * 0.3).astype(
        np.float32)).to(dev)
    hist = torch.from_numpy((rng.randn(S, LANES, limiter.TP_HIST) * 0.5
                             ).astype(np.float32)).to(dev)
    pk, h = limiter.truepeak_cuda(x, hist)
    same = all(torch.equal(pk[s:s + 1], p1) and torch.equal(h[s:s + 1], h1)
               for s in range(S) for p1, h1 in [limiter.truepeak_cuda(
                   x[s:s + 1], hist[s:s + 1])])
    print(f"K9 [{S}, {LANES}, {N}] against {S} S = 1 calls: bit-equal "
          f"{same}")
    check(same, "K9: S = 4 differs from S = 1")
    k9_s = (lambda: limiter.truepeak_cuda(x, hist))
    k9_1 = (lambda: limiter.truepeak_cuda(x[:1], hist[:1]))
    dev_s, _ = device_ms(k9_s, f"K9 S={S}")
    dev_1, _ = device_ms(k9_1, "K9 S=1")
    b = bound(nbytes(x, hist, pk, h), truepeak_ops(S * LANES, N), FP32_FLOPS)
    n_dev = device_launches(k9_s)
    print(f"K9 S={S}: {cuda_ms(k9_s):.4f} ms per call, device {dev_s:.4f} "
          f"ms in {n_dev} device launch; S=1: "
          f"{cuda_ms(k9_1):.4f} ms per call, device {dev_1:.4f} ms; bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}) {tag}")
    check(n_dev == 1, f"K9 made {n_dev} device launches at S = {S}")

    # K8: four streams' 7.1.4 beds, one bank
    hr, _, _ = k8_inputs(LANES, B_MAIN, dev)
    x = torch.from_numpy((rng.randn(S, LANES, N) * 0.3).astype(
        np.float32)).to(dev)
    ov = torch.from_numpy((rng.randn(S, 2, 255) * 0.1).astype(
        np.float32)).to(dev)
    y, o = binaural.hrtf_conv_cuda(hr, x, ov)
    y_p, o_p = binaural.hrtf_conv_plain(hr, x, ov)
    err = max(float((y - y_p).abs().max()), float((o - o_p).abs().max()))
    d1 = 0.0
    for s in range(S):
        y1, o1 = binaural.hrtf_conv_cuda(hr, x[s:s + 1], ov[s:s + 1])
        d1 = max(d1, float((y[s:s + 1] - y1).abs().max()),
                 float((o[s:s + 1] - o1).abs().max()))
    print(f"K8 [{S}, {LANES}, {N}]: max|diff| vs twin {err:.3e} (bound "
          f"1e-4; 1.55e-6 at S = 1 in PERF.md), vs {S} S = 1 calls "
          f"{d1:.3e}")
    check(err <= 1e-4 and d1 == 0.0, f"K8 at S = {S}: {err}, {d1}")
    k8_s = (lambda: binaural.hrtf_conv_cuda(hr, x, ov))
    k8_1 = (lambda: binaural.hrtf_conv_cuda(hr, x[:1], ov[:1]))
    dev_s, _ = device_ms(k8_s, f"K8 S={S}")
    dev_1, _ = device_ms(k8_1, "K8 S=1")
    b = bound(nbytes(x, hr.bank, ov, y, o),
              S * fft_conv_ops(LANES, 2, N, 256), FP32_FLOPS)
    n_dev = device_launches(k8_s)
    print(f"K8 S={S}: {cuda_ms(k8_s):.4f} ms per call, device {dev_s:.4f} "
          f"ms in {n_dev} device launch; S=1: "
          f"{cuda_ms(k8_1):.4f} ms per call, device {dev_1:.4f} ms; bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}) {tag}")
    check(n_dev == 1, f"K8 made {n_dev} device launches at S = {S}")

    # K1 + K2 and K7 with the streams folded into S * 12 lanes
    cs = synth.celt_synth(dev)
    pk = np.stack([_comb_params(rng, B_MAIN, LANES) for _ in range(S)])
    buf = np.zeros((S, B_MAIN, LANES, FRAME + 13), np.float32)
    buf[..., :FRAME] = rng.randn(S, B_MAIN, LANES, FRAME) * 1000.0
    buf[..., FRAME] = rng.rand(S, B_MAIN, LANES) < 0.3  # transient
    buf[..., FRAME + 1:] = pk[..., 1:]
    buf = torch.from_numpy(buf).to(dev)
    carry = synth.SynthCarry(*(torch.from_numpy(
        (rng.randn(*shape) * 1000.0).astype(np.float32)).to(dev)
        for shape in ((S, LANES, 60), (S, LANES, synth.HIST), (S, LANES))))
    fn = lambda b, c: synth.synthesize_packed(cs, b, c)  # noqa: E731
    n1, n2 = K1.launches, synth.K2.launches
    pcm, c2 = lane_synth(fn, (buf,), carry)
    check(K1.launches == n1 + 1 and synth.K2.launches == n2 + 1,
          "K1/K2 launched other than once for the folded streams")
    lsb = 0.0
    for s in range(S):
        p1, c1 = fn(buf[s], synth.SynthCarry(*(t[s] for t in carry)))
        lsb = max(lsb, float((pcm[s] - p1).abs().max()) * 32768)
        check(torch.equal(c2.hist[s], c1.hist),
              "K2's comb history differs between the fold and one stream")
    print(f"K1 + K2 at {S} x {LANES} lanes [B={B_MAIN}] against {S} calls "
          f"of {LANES} lanes: PCM max|diff| {lsb:.0f} LSB (bound 1), comb "
          f"histories equal")
    check(lsb <= 1, f"K1/K2 fold: {lsb} LSB")
    _fold_times(tag, "K1 + K2", ("k1_", "partition_rows", "comb_kernel",
                                 "deemph_kernel"),
                lambda: lane_synth(fn, (buf,), carry),
                lambda: fn(buf[0], synth.SynthCarry(*(t[0] for t in carry))))
    tabs = aac.Tables().to(dev)
    spec = torch.from_numpy((rng.randn(S, B_MAIN, LANES, 1024) * 3000.0
                             ).astype(np.float32)).to(dev)
    meta = torch.from_numpy(K7_CASES[rng.randint(16, size=(
        S, B_MAIN, LANES))]).to(dev)
    ac = torch.from_numpy((rng.randn(S, LANES, 1024) * 3000.0).astype(
        np.float32)).to(dev)
    fn7 = lambda sp, me, c: aac.synthesize(tabs, sp, me, c)  # noqa: E731
    n7 = aac.K7.launches
    y7, c7 = lane_synth(fn7, (spec, meta), ac)
    check(aac.K7.launches == n7 + 1, "K7 launched other than once")
    same = all(torch.equal(y7[s], y1) and torch.equal(c7[s], c1)
               for s in range(S) for y1, c1 in [fn7(spec[s], meta[s], ac[s])])
    fill = aac.k7_fill(dev)
    print(f"K7 at {S} x {LANES} lanes [B={B_MAIN}] against {S} calls of "
          f"{LANES} lanes: bit-equal {same}; run {aac.k7_run(B_MAIN, S * LANES, fill)}"
          f" at {S * LANES} lanes, {aac.k7_run(B_MAIN, LANES, fill)} at "
          f"{LANES} ({fill} warps the card holds)")
    check(same, "K7 fold differs from one stream's calls")
    _fold_times(tag, "K7", ("k7_synth",),
                lambda: lane_synth(fn7, (spec, meta), ac),
                lambda: fn7(spec[0], meta[0], ac[0]))


def _fold_times(tag, name, kernels, fold, one):
    """Device time of the named kernels in a call with the streams folded
    into S_FLEET * 12 lanes and in one stream's 12-lane call."""
    ms = []
    for label, fn in ((f"{S_FLEET * LANES} lanes", fold), (f"{LANES} lanes",
                                                           one)):
        _, per = device_ms(fn, f"{name} at {label}")
        ms.append(sum(v for k, v in per.items()
                      if any(n in k for n in kernels)))
    ratio = f"{ms[0] / ms[1]:.2f}x" if ms[1] else "not in the trace"
    print(f"{name} device time at {S_FLEET * LANES} lanes {ms[0]:.4f} ms, at "
          f"{LANES} lanes {ms[1]:.4f} ms ({ratio}) {tag}")


# --- phases 12 / 13: fleets through the multi-stream server -----------------

def _calls(d) -> int:
    """The decode calls of one stream's fetch=False decode: the head-trim
    warm-up call and one per batch."""
    return (1 if d.cfg.head_trim else 0) + -(-d.n_frames // d.batch_frames)


def fleet_path(dev, tag, label, fleet, kw, kernels, must, n_buckets,
               timing=True):
    """Serve `fleet` on the card with MultiStreamServer and hold each stream
    to its own BatchedStreamDecoder(...).decode_all(fetch=False) on the
    card: <= 1 LSB (the count of streams at 0 printed). Each kernel's
    launches in the fleet decode equal the sum, over the buckets, of those
    of the bucket's longest member's own decode (the same number of
    calls). With timing: the aggregate realtime factor (all streams' audio
    seconds over the wall of the server's construction and decode, median
    of 3 after a warm-up) and a trace. Returns the fleet run's launches."""
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
    from iamf_tpu_torch.core.serving import MultiStreamServer

    def serve():
        srv = MultiStreamServer(fleet, device=dev, **kw)
        return srv, srv.decode_all()

    if timing:
        serve()  # warm-up
    for k in kernels:
        k.reset()
    srv, outs = serve()
    launches = {k.symbol: k.launches for k in kernels}
    plain = {k.symbol: k.plain_on_cuda for k in kernels}
    check(srv.n_buckets == n_buckets,
          f"{label}: {srv.n_buckets} buckets, want {n_buckets}")
    longest = {max(idxs, key=lambda i: _calls(srv.decs[i]))
               for idxs in srv._groups.values()}
    own = dict.fromkeys(launches, 0)
    diffs = []
    for i, stream in enumerate(fleet):
        for k in kernels:
            k.reset()
        mine = BatchedStreamDecoder(stream, device=dev,
                                    **kw).decode_all(fetch=False)
        if i in longest:
            for k in kernels:
                own[k.symbol] += k.launches
        check(len(mine) == len(outs[i]), f"{label}: stream {i} batches")
        diffs.append(max((int((a.int() - b.int()).abs().max())
                          for a, b in zip(outs[i], mine)), default=0))
    secs = sum(d.n_frames * d.frame_size - d.lead - d.tail
               for d in srv.decs) / 48000.0
    shown = [k for k in launches if launches[k] or own[k]]
    print(f"{label}: {len(fleet)} streams, {srv.n_buckets} buckets, "
          f"{secs:.3f} s of audio; max|diff| per stream vs its own card "
          f"decode {diffs} LSB ({diffs.count(0)} of {len(diffs)} at 0); "
          f"launches {({k: launches[k] for k in shown})}, the longest "
          f"members' own decodes {({k: own[k] for k in shown})}; plain twins "
          f"on CUDA {sum(plain.values())}")
    check(max(diffs) <= 1, f"{label}: {max(diffs)} LSB")
    check(launches == own, f"{label}: fleet launches {launches} != {own}")
    check(all(launches[k.symbol] > 0 for k in must),
          f"{label}: a kernel of the path did not launch: {launches}")
    check(not any(plain.values()), f"{label}: a plain twin ran on CUDA")
    if timing:
        walls = timed(serve, 3)
        print(f"{label} aggregate realtime factor "
              f"{secs / np.median(walls):.2f}x (median of {len(walls)}; "
              f"{secs:.3f} s audio in {_ms(walls)} ms wall, batch_frames="
              f"{kw['batch_frames']}) {tag}")
        trace_decode(serve, label)
    return launches


def fleets_phase(dev, tag, kernels):
    """Fleets at full width (batch_frames=128): 4 x 30 s of 7.1.4 PCM -> J
    (one bucket, like the JAX bench's BENCH_STREAMS=4 aggregate); 4 x 30 s
    binaural M2B (K8 and K3 engaged at S = 4); and a mixed fleet of 30 s and
    22 s of 7.1.4 PCM with the Opus sample and its first 12 temporal units
    (two buckets: K1, K2 and K3)."""
    from iamf_tpu_torch.codecs.opus.imdct import K1
    from iamf_tpu_torch.codecs.opus.synth import K2
    from iamf_tpu_torch.dsp.binaural import K8
    from iamf_tpu_torch.dsp.limiter import K3
    from iamf_tpu_torch.tools import streams

    L714 = streams.ChannelLayout.L714
    n30 = 1500
    pcm = [streams.build_pcm_layout_stream(L714, n_frames=n30,
                                           amp=0.2 + 0.1 * s, seed=s)[0]
           for s in range(S_FLEET)]
    fleet_path(dev, tag, "fleet pcm 4 x 7.1.4 30 s -> ssJ", pcm,
               dict(sound_system=9, batch_frames=B_MAIN), kernels, (K3,), 1)
    binaural = [streams.build_pcm_layout_stream(L714, n_frames=n30,
                                                amp=0.2 + 0.1 * s, seed=s,
                                                hrm=1)[0]
                for s in range(S_FLEET)]
    fleet_path(dev, tag, "fleet binaural 4 x 7.1.4 M2B 30 s", binaural,
               dict(binaural=True, batch_frames=B_MAIN), kernels, (K8, K3), 1)
    sample = open(os.path.join(ROOT, "iamf_tpu", "data",
                               "sample_opus_714.iamf"), "rb").read()
    desc, units = streams.split_into_units(sample)
    hetero = [pcm[0], streams.build_pcm_layout_stream(
        L714, n_frames=1100, amp=0.4, seed=7)[0], sample,
        desc + b"".join(units[:12])]
    fleet_path(dev, tag, "fleet hetero pcm 30 s + 22 s + opus sample + cut",
               hetero, dict(sound_system=9, batch_frames=B_MAIN), kernels,
               (K1, K2, K3), 2)


def short_fleets_phase(dev, tag, kernels):
    """Short fleets at batch_frames=16, checked as the full-width ones but
    untimed: 2 AAC-LC 7.1.4 streams (K7 at 24 lanes), 3 true-peak streams of
    unequal length (IAMF_TRUEPEAK=1: K9 and K3 at S = 3), a scalable-demix
    pair; then the refusals."""
    from iamf_tpu_torch.codecs.aac.synth import K7
    from iamf_tpu_torch.core.serving import MultiStreamServer
    from iamf_tpu_torch.dsp.limiter import K3, K9
    from iamf_tpu_torch.tools import streams

    L = streams.ChannelLayout
    kw = dict(sound_system=9, batch_frames=16)
    aac = [streams.build_aac_layout_stream(L.L714, n_frames=40, seed=s)[0]
           for s in (5, 6)]
    fleet_path(dev, tag, "fleet aac 2 x 7.1.4", aac, kw, kernels, (K7, K3),
               1, timing=False)
    tp = [streams.build_pcm_layout_stream(
        L.L714, n_frames=n, pcm_override=streams.isp_tone_pcm(n, 12))[0]
        for n in (40, 29, 17)]
    old = os.environ.get("IAMF_TRUEPEAK")
    os.environ["IAMF_TRUEPEAK"] = "1"
    try:
        fleet_path(dev, tag, "fleet true peak 3 x 7.1.4 (40, 29, 17 frames)",
                   tp, kw, kernels, (K9, K3), 1, timing=False)
    finally:
        if old is None:
            del os.environ["IAMF_TRUEPEAK"]
        else:
            os.environ["IAMF_TRUEPEAK"] = old
    scal = [streams.build_scalable_pcm_stream(
        n_frames=40, demix_modes=[f % 3 for f in range(40)],
        recon_gains=[(200, 180), (255, 255), (120, 90)], amp=a)[0]
        for a in (0.3, 0.5)]
    fleet_path(dev, tag, "fleet scalable demix 2 x 5.1 -> 5.1", scal,
               dict(sound_system=1, batch_frames=16), kernels, (K3,), 1,
               timing=False)
    ok = streams.build_pcm_layout_stream(L.L714, n_frames=8)[0]
    bad = {"44.1 kHz": streams.build_pcm_51_stream(n_frames=8,
                                                   rate=44100)[0],
           "reconfigured": ok + streams.build_pcm_51_stream(n_frames=8)[0]}
    for what, stream in bad.items():
        try:
            MultiStreamServer([ok, stream], device=dev, **kw)
        except ValueError as e:
            print(f"fleet with a {what} stream refused: {e}")
        else:
            raise AssertionError(f"a {what} stream was served")


# --- phases 14 / 15: reconfigure segments and MP4 ---------------------------

def _golden():
    return np.load(os.path.join(ROOT, "iamf_tpu_torch", "data",
                                "sample_opus_714_ssJ.npz"))["pcm"]


def reconfigure_phase(dev, tag, kernels):
    """The Opus sample, then 30 s of 7.1.4 PCM, one stream -> J at
    batch_frames=128: against the CPU run, its first segment against the
    golden without its last delay_size samples (the reference's
    reconfigure never emits them), one entry under stats["segments"]."""
    from iamf_tpu_torch.codecs.opus.imdct import K1
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
    from iamf_tpu_torch.dsp.limiter import K3
    from iamf_tpu_torch.tools import streams

    sample = open(os.path.join(ROOT, "iamf_tpu", "data",
                               "sample_opus_714.iamf"), "rb").read()
    pcm = streams.build_pcm_layout_stream(streams.ChannelLayout.L714,
                                          n_frames=1500, amp=0.5)[0]
    kw = dict(sound_system=9, batch_frames=B_MAIN)
    decode_path(dev, tag, "reconfigure opus sample + pcm 7.1.4 30 s -> ssJ",
                sample + pcm, kw, kernels, (K1, K3))
    dec = BatchedStreamDecoder(sample + pcm, device=dev, **kw)
    got = dec.decode_all()
    golden = _golden()
    d = 240  # LimiterConfig.delay_size
    n0 = len(golden) - d
    err = int(np.abs(got[:n0].astype(np.int32)
                     - golden[:n0].astype(np.int32)).max())
    print(f"reconfigure: first segment ({n0} samples) vs the golden less its "
          f"last {d}: max|diff| {err} LSB; {len(got) - n0} samples after; "
          f"segments {len(dec.stats.get('segments', []))}, paths "
          f"{[e['path'] for e in dec.stats['elements']]} then "
          f"{[e['path'] for s in dec.stats['segments'] for e in s['elements']]}")
    check(err <= 1, f"reconfigure first segment: {err} LSB")
    check(len(dec.stats["segments"]) == 1, "reconfigure: segments")
    check(len(got) - n0 == 1500 * FRAME, "reconfigure: second segment length")


def mp4_phase(dev, tag, kernels):
    """The Opus sample muxed by the port's mp4builder into MP4 and fMP4:
    from_mp4 -> J at batch_frames=8 against the golden; with start_sec=0.1
    against the CPU run of the same file."""
    from iamf_tpu_torch.codecs.opus.imdct import K1
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
    from iamf_tpu_torch.dsp.limiter import K3
    from iamf_tpu_torch.tools import streams

    sample = open(os.path.join(ROOT, "iamf_tpu", "data",
                               "sample_opus_714.iamf"), "rb").read()
    out_dir = tempfile.mkdtemp()
    golden = _golden()
    for name, data in (("mp4", streams.build_mp4(sample)),
                       ("fmp4", streams.build_fmp4(sample, fragments=3))):
        path = os.path.join(out_dir, f"sample_opus_714.{name}")
        with open(path, "wb") as f:
            f.write(data)
        for k in kernels:
            k.reset()

        def run(device, start=0.0):
            return BatchedStreamDecoder.from_mp4(
                path, start_sec=start, sound_system=9, batch_frames=B_OPUS,
                device=device).decode_all()

        got = run(dev)
        launches = {k.symbol: k.launches for k in kernels}
        err = int(np.abs(got.astype(np.int32)
                         - golden.astype(np.int32)).max())
        walls = timed(lambda: run(dev), 5)
        secs = got.shape[0] / 48000.0
        print(f"{name} opus sample -> ssJ: max|diff| vs golden {err} LSB; "
              f"launches {launches}; realtime factor "
              f"{secs / np.median(walls):.2f}x (median of 5; {_ms(walls)} ms "
              f"wall) {tag}")
        check(got.shape == golden.shape and err <= 1, f"{name}: {err} LSB")
        check(launches[K1.symbol] > 0 and launches[K3.symbol] > 0,
              f"{name}: {launches}")
        seek, want = run(dev, 0.1), run("cpu", 0.1)
        err = int(np.abs(seek.astype(np.int32) - want.astype(np.int32)).max())
        print(f"{name} seek 0.1 s: shape {seek.shape}, max|diff| vs CPU run "
              f"{err} LSB")
        check(seek.shape == want.shape and len(seek) < len(got) and err <= 1,
              f"{name} seek: {err} LSB")
    shutil.rmtree(out_dir)


# --- phase 16: the frame-serial decoder --------------------------------------

def serial_decode(dec, data, ss=None, binaural=False, targets=(),
                  switch_at=0, view=True):
    """The port's player loop (tools/player.py decode_bitstream) through
    an IAMFDecoder: configure, one access unit a decode call, flush.
    `targets` re-targets the output layout (a sound system or "b") every
    `switch_at` output frames through configure(None) with stream reuse.
    Each call gets the rest of the stream as a memoryview; view=False
    slices the bytes as the player does, a copy of the rest a call
    (quadratic in the stream's length). Returns the list of output
    chunks."""
    if binaural:
        dec.set_binaural()
    else:
        dec.set_sound_system(ss)
    if view:
        data = memoryview(data)
    pos = dec.configure(data)
    chunks, frames, k = [], 0, 0
    while pos < len(data):
        if switch_at and frames and frames % switch_at == 0 \
                and k < len(targets):
            t, k = targets[k], k + 1
            dec.set_binaural() if t == "b" else dec.set_sound_system(t)
            dec.configure(None)
        consumed, pcm = dec.decode(data[pos:])
        if consumed == 0 and pcm is None:
            break
        pos += consumed
        if pcm is not None and len(pcm):
            chunks.append(pcm)
            frames += 1
    _, pcm = dec.decode(None)
    if pcm is not None and len(pcm):
        chunks.append(pcm)
    return chunks


def _serial(device, data, **kw):
    from iamf_tpu_torch.api import IAMFDecoder

    dec = IAMFDecoder() if device is None else IAMFDecoder(device=device)
    return np.concatenate(serial_decode(dec, data, **kw))


class _Reach:
    """Counts, beside the kernels' own counters, the frames that reach the
    serial limiter (non-empty) and the HRTF renderer, by wrapping their
    methods for the phase."""

    def __init__(self):
        from iamf_tpu_torch.dsp.binaural import HRTFRenderer
        from iamf_tpu_torch.dsp.limiter import Limiter

        self.n = {"limiter": 0, "hrtf": 0}
        self.saved = [(Limiter, "process", Limiter.process),
                      (HRTFRenderer, "render", HRTFRenderer.render)]
        lim, hrtf = Limiter.process, HRTFRenderer.render

        def process(obj, x, *a):
            self.n["limiter"] += x.shape[1] > 0
            return lim(obj, x, *a)

        def render(obj, x):
            self.n["hrtf"] += 1
            return hrtf(obj, x)

        Limiter.process, HRTFRenderer.render = process, render

    def reset(self):
        self.n = dict.fromkeys(self.n, 0)

    def restore(self):
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)


def _lsb(a, b) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def serial_cell(dev, tag, label, data, kw, bkw, reach, n_frames, frame,
                cpu_units=None):
    """One full-width serial cell: three timed card decodes (the first
    counted), one traced; against the CPU serial run (of the first
    `cpu_units` access units when given: compared on the first
    (cpu_units - 2) frames) and the card's batched decode_all."""
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
    from iamf_tpu_torch.dsp.binaural import K8
    from iamf_tpu_torch.dsp.limiter import K3, K9
    from iamf_tpu_torch.tools import streams

    kernels = (K3, K8, K9)
    walls = []
    for i in range(3):
        if i == 0:
            reach.reset()
            for k in kernels:
                k.reset()
        t = time.perf_counter()
        got = _serial(dev, data, **kw)
        walls.append(time.perf_counter() - t)
        if i == 0:
            launches = {k.symbol: k.launches for k in kernels}
            frames = dict(reach.n)
            plain = {k.symbol: k.plain_on_cuda for k in kernels}
    secs = got.shape[0] / 48000.0
    rtx = secs / np.median(walls)
    batched = BatchedStreamDecoder(data, device=dev, batch_frames=B_MAIN,
                                   **bkw).decode_all()
    d_b = _lsb(got, batched) if got.shape == batched.shape else None
    t = time.perf_counter()
    if cpu_units:
        desc, units = streams.split_into_units(data)
        want = _serial("cpu", desc + b"".join(units[:cpu_units]), **kw)
        n = (cpu_units - 2) * frame
        d_c, what = _lsb(got[:n], want[:n]), f"first {n} samples"
        same = want.shape[1] == got.shape[1] and len(want) > n
    else:
        want = _serial("cpu", data, **kw)
        d_c, what = (_lsb(got, want) if got.shape == want.shape
                     else None), "whole stream"
        same = got.shape == want.shape
    cpu_s = time.perf_counter() - t
    busy = trace_decode(lambda: _serial(dev, data, **kw), label)
    k3, k8 = launches[K3.symbol], launches[K8.symbol]
    print(f"{label}: shape {got.shape}; max|diff| vs CPU serial run "
          f"({what}, {cpu_s:.1f} s) {d_c} LSB, vs batched decode_all on the "
          f"card {d_b} LSB; launches a decode K3 {k3}, K8 {k8}, K9 "
          f"{launches[K9.symbol]} for {n_frames} frames (frames reaching "
          f"the limiter {frames['limiter']}, the HRTF renderer "
          f"{frames['hrtf']}); plain twins on CUDA {plain}")
    print(f"{label} realtime factor {rtx:.2f}x (median of 3; {secs:.3f} s "
          f"audio in {_ms(walls)} ms wall), device busy {busy:.1f} % "
          f"{tag}")
    check(same and d_c is not None and d_c <= 1,
          f"{label}: vs CPU serial run {d_c} LSB")
    check(d_b is not None and d_b <= 1,
          f"{label}: vs batched decode {d_b} LSB, shapes {got.shape} "
          f"{batched.shape}")
    check(k3 == frames["limiter"] == n_frames + 1,
          f"{label}: K3 launches {k3}, frames at the limiter {frames}")
    check(k8 == frames["hrtf"] == (n_frames if kw.get("binaural") else 0),
          f"{label}: K8 launches {k8}, frames at the renderer {frames}")
    check(launches[K9.symbol] == 0 and not any(plain.values()),
          f"{label}: {launches}, plain twins {plain}")
    return dict(realtime_x=rtx, busy=busy, k3=k3, k8=k8)


def serial_syncs(dev, data, n_frames):
    """The serial decoder's host waits on the card (torch's sync debug
    mode, one warning a synchronizing call, tallied by the Python line
    that made it): each frame's only one is the copy of its int PCM back
    (api._to_host), one a frame and one for the drain; the others come
    once a decoder (its set-up), not with the frames."""
    import collections
    import warnings

    for kw in (dict(ss=9), dict(binaural=True)):
        _serial(dev, data, **kw)  # warm
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _serial(dev, data, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sites = collections.Counter(
            f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            for w in caught if "synchroniz" in str(w.message).lower())
        fetch = sum(n for site, n in sites.items()
                    if site.startswith("iamf_tpu_torch/api.py"))
        others = {k: n for k, n in sites.items()
                  if not k.startswith("iamf_tpu_torch/api.py")}
        print(f"serial syncs, {n_frames} frames {kw}: {dict(sites)}")
        check(fetch == n_frames + 1 and len(
            [k for k in sites if k.startswith("iamf_tpu_torch/api.py")]) == 1,
              f"serial syncs: the PCM copies back {fetch}, {dict(sites)}")
        check(max(others.values(), default=0) < n_frames // 4,
              f"serial syncs: a wait a frame besides the copy back: {others}")


def serial_phase(dev, tag, kernels):
    """Phase 16: the frame-serial IAMFDecoder on the card."""
    from iamf_tpu_torch.dsp.binaural import K8
    from iamf_tpu_torch.dsp.limiter import K3, K9
    from iamf_tpu_torch.tools import player, streams

    L = streams.ChannelLayout
    sample = open(os.path.join(ROOT, "iamf_tpu", "data",
                               "sample_opus_714.iamf"), "rb").read()
    reach = _Reach()
    try:
        for k in kernels:
            k.reset()
        got = _serial(None, sample, ss=9)  # IAMFDecoder(): the card
        k3 = K3.launches
        want = _serial("cpu", sample, ss=9)
        golden = _golden()
        d_c = _lsb(got, want) if got.shape == want.shape else None
        d_g = _lsb(got, golden) if got.shape == golden.shape else None
        print(f"serial opus sample -> ssJ (IAMFDecoder()): shape "
              f"{got.shape}; max|diff| vs CPU serial {d_c} LSB, vs golden "
              f"(batched, JAX package) {d_g} LSB; K3 launches {k3}")
        check(d_c is not None and d_c <= 1, f"serial opus vs CPU: {d_c}")
        check(d_g is not None and d_g <= 2, f"serial opus vs golden: {d_g}")
        check(k3 == 17 and K8.launches == 0, f"serial opus: K3 {k3}")

        pcm = streams.build_pcm_layout_stream(L.L714, n_frames=1500,
                                              amp=0.5)[0]
        m2b = streams.build_pcm_layout_stream(L.L714, n_frames=1500,
                                              amp=0.5, hrm=1)[0]
        aac = streams.build_aac_layout_stream(L.L714, n_frames=1407,
                                              seed=5)[0]
        cells = {
            "serial_pcm714_ssJ_30s": serial_cell(
                dev, tag, "serial_pcm714_ssJ_30s", pcm, dict(ss=9),
                dict(sound_system=9), reach, 1500, FRAME),
            "serial_binaural714_m2b_30s": serial_cell(
                dev, tag, "serial_binaural714_m2b_30s", m2b,
                dict(binaural=True), dict(binaural=True), reach, 1500,
                FRAME),
            "serial_aac714_ssJ_30s": serial_cell(
                dev, tag, "serial_aac714_ssJ_30s", aac, dict(ss=9),
                dict(sound_system=9), reach, 1407, 1024, cpu_units=400),
        }
        print("serial cells: " + json.dumps(
            {k: {f: round(v, 3) if isinstance(v, float) else v
                 for f, v in c.items()} for k, c in cells.items()})
              + f" {tag}")
        serial_syncs(dev, streams.build_pcm_layout_stream(
            L.L714, n_frames=40, amp=0.5, hrm=1)[0], 40)

        # true peak: K9 meters every frame before K3
        tp = streams.build_pcm_layout_stream(
            L.L714, n_frames=60, pcm_override=streams.isp_tone_pcm(60, 12))[0]
        old = os.environ.get("IAMF_TRUEPEAK")
        os.environ["IAMF_TRUEPEAK"] = "1"
        try:
            reach.reset()
            for k in kernels:
                k.reset()
            got = _serial(dev, tp, ss=9)
            launches = {k.symbol: k.launches for k in (K3, K9)}
            frames = reach.n["limiter"]
            want = _serial("cpu", tp, ss=9)
        finally:
            if old is None:
                del os.environ["IAMF_TRUEPEAK"]
            else:
                os.environ["IAMF_TRUEPEAK"] = old
        plain = _serial(dev, tp, ss=9)
        d = _lsb(got, want) if got.shape == want.shape else None
        print(f"serial true peak 7.1.4 60 frames: max|diff| vs CPU {d} LSB, "
              f"vs the sample-peak decode {_lsb(got, plain)}; launches "
              f"{launches} for {frames} frames at the limiter")
        check(d is not None and d <= 1, f"serial true peak: {d} LSB")
        check(launches[K9.symbol] == launches[K3.symbol] == frames == 61,
              f"serial true peak launches {launches}, frames {frames}")
        check(_lsb(got, plain) > 500, "serial true peak: meter idle")

        # configure(None): J -> 5.1 -> binaural, every 5 output frames
        kw = dict(ss=9, targets=[1, "b"], switch_at=5)
        from iamf_tpu_torch.api import IAMFDecoder

        g = serial_decode(IAMFDecoder(), sample, **kw)
        w = serial_decode(IAMFDecoder(device="cpu"), sample, **kw)
        d = max(_lsb(a, b) for a, b in zip(g, w))
        print(f"serial configure(None) re-target J -> 5.1 -> binaural: "
              f"{len(g)} chunks, widths {sorted({c.shape[1] for c in g})}, "
              f"max|diff| vs CPU {d} LSB")
        check(len(g) == len(w) and all(a.shape == b.shape
                                       for a, b in zip(g, w)) and d <= 1,
              f"serial re-target: {d} LSB")
        check(sorted({c.shape[1] for c in g}) == [2, 6, 12],
              "serial re-target: layouts")
    finally:
        reach.restore()

    # the player on the card against the CPU player
    out_dir = tempfile.mkdtemp()
    cwd = os.getcwd()
    try:
        paths = {"sample.iamf": sample, "sample.mp4": streams.build_mp4(
            sample)}
        for name, data in paths.items():
            with open(os.path.join(out_dir, name), "wb") as f:
                f.write(data)
        for name, flags in (("sample.iamf", ["-o2", "-s9"]),
                            ("sample.mp4", ["-i1", "-o2", "-s9"])):
            wavs = []
            for device in ("cuda", "cpu"):
                d = os.path.join(out_dir, device + name)
                os.makedirs(d)
                os.chdir(d)
                rc = player.main([*flags, "--device", device,
                                  os.path.join(out_dir, name)])
                check(rc == 0, f"player {name} {device}: rc {rc}")
                wavs.append(open(os.path.join(d, "ss9_sample.wav"),
                                 "rb").read())
            a, b = (np.frombuffer(w[44:], np.int16) for w in wavs)
            d = _lsb(a, b) if a.shape == b.shape else None
            print(f"player {' '.join(flags)} {name} on the card vs the CPU "
                  f"player: {len(wavs[0])} bytes, headers equal "
                  f"{wavs[0][:44] == wavs[1][:44]}, files equal "
                  f"{wavs[0] == wavs[1]}, max|diff| {d} LSB")
            check(wavs[0][:44] == wavs[1][:44] and d is not None and d <= 1,
                  f"player {name}: {d} LSB")
    finally:
        os.chdir(cwd)
        shutil.rmtree(out_dir)


# --- phase 17: the CELT device entropy stages ---------------------------------

INT32_OPS = 16.7e12  # 64 INT32 lanes an SM a clock x 132 SMs x 1.98 GHz


def k11_ops(n) -> float:
    """The fewest integer operations of cwrsi on these leaves: a compare,
    a subtraction and the sign of a coefficient for each dimension the
    walk takes (n - 2 a leaf), and the n = 2 and n = 1 closed forms
    (about ten); the searches' probes are not counted."""
    n = np.asarray(n, np.int64)
    return float(3 * np.maximum(n - 2, 0).sum() + 10 * len(n))


def cwrsi_corpus() -> dict:
    """K11's corpora beside the sample, as numpy (n, k, idx): "random", 4,096
    leaves of celt_taps.random_leaves (numpy seed 11), and "edges",
    celt_taps.edge_leaves; the CPU tests' corpora."""
    from iamf_tpu_torch.tools import celt_taps

    return {"random": celt_taps.random_leaves(np.random.default_rng(11), 4096),
            "edges": celt_taps.edge_leaves()}


def _k13_need(bt, lt):
    """What K13's function needs of these frames (numpy): for each frame
    and band, whether it is present and whether it folds; for each slot,
    whether it is active, a q0 slot or a PVQ slot."""
    from iamf_tpu_torch.codecs.opus import device_bands as db

    b = {key: bt[key].cpu().numpy() for key in db.BT_KEYS}
    k = lt["k"].cpu().numpy()
    present = b["present"] > 0
    return dict(b=b, present=present, fold=present & (b["has_lb"] > 0),
                active=k > -2, q0=(k > -2) & (k <= 0), pvq=k > 0,
                n=lt["n"].cpu().numpy())


def k13_bytes(bt, lt) -> int:
    """K13's bytes on these frames, counting what their data need: the
    band fields, each slot's k (which says whether it is active), an
    active slot's n, off, b_leaf and cm_shift, a q0 slot's gain and fill
    map, a PVQ slot's n leaf coefficients, the seeds; of the configuration
    banks, once for each (band, configuration) the frames select, the pre
    matrix where the band folds and the post matrix, cm row and B-mask
    where it is present, and sqrt(N); out the spectra, seeds and collapse
    masks."""
    from iamf_tpu_torch.codecs.opus import device_bands as db

    d = _k13_need(bt, lt)
    F = d["present"].shape[0]
    sizes = db.band_sizes().astype(np.int64)
    band = np.broadcast_to(np.arange(db.NBANDS), d["present"].shape)
    cfg = d["b"]["cfg_id"]
    pre = set(zip(band[d["fold"]], cfg[d["fold"]]))
    post = set(zip(band[d["present"]], cfg[d["present"]]))
    mats = sum(int(sizes[i]) ** 2 * 4 for i, _ in pre) + sum(
        int(sizes[i]) ** 2 * 4 + (16 + 1) * 4 for i, _ in post)
    slots = (len(db.BT_KEYS) * F * db.NBANDS + d["active"].size
             + (len(db.LT_INTS) - 1) * int(d["active"].sum())
             + (1 + 16) * int(d["q0"].sum())
             + int(np.minimum(d["n"], db.W)[d["pvq"]].sum()) + F) * 4
    return slots + mats + db.NBANDS * 4 + F * (db.NBINS + 1 + db.NBANDS) * 4


def k13_ops(bt, lt) -> float:
    """K13's fewest fp32 operations on these frames: the [N, N] pre matvec
    of a band that folds and the post matvec of a band that is present
    (2 N^2 each), and a few operations a bin for the slots' values and
    placement (8 N a present band)."""
    from iamf_tpu_torch.codecs.opus import device_bands as db

    d = _k13_need(bt, lt)
    sizes = db.band_sizes().astype(np.float64)
    return float((2 * sizes ** 2 * d["fold"]).sum()
                 + ((2 * sizes ** 2 + 8 * sizes) * d["present"]).sum())


def sample_taps():
    """The Opus sample's native taps (tools/celt_taps.py): its CELT frames
    and all their PVQ leaves (n, k, idx, gain, spread, blocks, tap X)."""
    from iamf_tpu_torch.tools import celt_taps

    data = open(os.path.join(ROOT, "iamf_tpu", "data",
                             "sample_opus_714.iamf"), "rb").read()
    frames = celt_taps.tap_stream(data)
    return frames, celt_taps.all_leaves(frames)


def celt_inputs(dev) -> dict:
    """The kernel inputs of phase 17 on `dev`, from the sample's taps: the
    leaves' pulses y (int32 [7751, 96], K11's twin) and gains g, the
    rotation plan (cfg int32 [7751], bank [167, 96, 96]), and the 32 mono
    frames' packed tables (bt, lt) on the twins' leaf coefficients, with
    their entry seeds s0."""
    from iamf_tpu_torch import convert
    from iamf_tpu_torch.codecs.opus import band_pack
    from iamf_tpu_torch.codecs.opus import device_bands as db
    from iamf_tpu_torch.codecs.opus import device_cwrsi as dc
    from iamf_tpu_torch.codecs.opus import device_leaf as dl

    frames, (n, k, idx, gain, spread, blocks, _) = sample_taps()
    lb = convert.leaf_batch(n, k, idx, gain, spread, blocks, "cpu")
    cfg, bank = dl.rotation_plan(n, k, spread, blocks)
    vecs = dl.reconstruct(n, k, idx, gain, spread, blocks, device="cpu")
    bts, lts, seeds, off = [], [], [], 0
    for f in frames:
        L = len(f.leaves[0])
        if f.tap_C == 1:
            pf = band_pack.pack_frame(f.recs)
            bt, lt = db.pack_tensors(pf, list(vecs[off:off + L].numpy()))
            bts.append(bt)
            lts.append(lt)
            seeds.append(pf.seed0)
        off += L
    bt, lt = convert.packed_frame(bts, lts, dev)
    return dict(
        y=dc.cwrsi_plain(lb["n"], lb["k"], lb["idx"]).to(dev),
        g=lb["gain"].to(dev), cfg=torch.from_numpy(cfg).to(dev),
        bank=torch.from_numpy(bank).to(dev), bt=bt, lt=lt,
        s0=torch.from_numpy(np.array(seeds, np.uint32)).to(dev))


def celt_phase(dev, tag):
    """The device CELT entropy stages on the Opus sample: the native
    decoder taps its leaves and band records once (tools/celt_taps.py),
    then the path a user calls (device_leaf.reconstruct on all 7,751
    leaves, band_pack.pack_frame and device_bands.pack_tensors on the 32
    mono frames, device_bands.run_frame on all 32 in one call) runs with
    the launch counts set to 0 just before it; then each kernel against
    its plain twin on the card and against the native taps, with its
    times, bound and yardstick."""
    from iamf_tpu_torch import convert
    from iamf_tpu_torch.codecs.opus import band_pack
    from iamf_tpu_torch.codecs.opus import device_bands as db
    from iamf_tpu_torch.codecs.opus import device_cwrsi as dc
    from iamf_tpu_torch.codecs.opus import device_leaf as dl
    from iamf_tpu_torch.tools import celt_taps

    kernels = (dc.K11, *dl.KERNELS, db.K13)
    t = time.perf_counter()
    frames, (n, k, idx, gain, spread, blocks, xo) = sample_taps()
    mono = [f for f in frames if f.tap_C == 1]
    print(f"celt taps: {len(frames)} frames ({len(mono)} mono, "
          f"{sum(f.transient for f in mono)} transient), {len(n)} PVQ "
          f"leaves (n {n.min()}-{n.max()}, k <= {k.max()}), "
          f"{time.perf_counter() - t:.2f} s")
    check(len(n) == 7751 and len(mono) == 32, "the sample's taps changed")

    def path():
        X = dl.reconstruct(n, k, idx, gain, spread, blocks, device=dev)
        vecs = X.cpu().numpy()
        bts, lts, seeds, off = [], [], [], 0
        for f in frames:
            L = len(f.leaves[0])
            if f.tap_C == 1:
                pf = band_pack.pack_frame(f.recs)
                check(db.packable(pf), "a mono frame is not packable")
                bt, lt = db.pack_tensors(pf, list(vecs[off:off + L]))
                bts.append(bt)
                lts.append(lt)
                seeds.append(pf.seed0)
            off += L
        db_in = (bts, lts, seeds)
        return X, db_in, db.run_frame(bts, lts, seeds, device=dev)

    path()  # warm-up: builds the banks on the card
    for kk in kernels:
        kk.reset()
    X, (bts, lts, seeds), (spec, seed, coll) = path()
    torch.cuda.synchronize()
    launches = {kk.symbol: kk.launches for kk in kernels}
    plain = {kk.symbol: kk.plain_on_cuda for kk in kernels}
    print(f"celt path: launches {launches}; plain twins on CUDA {plain}")
    check(launches[dc.K11.symbol] == launches[dl.K12.symbol]
          == launches[db.K13.symbol] == 1,
          f"the celt path's kernels launched other than once: {launches}")
    check(not any(plain.values()), f"a plain twin ran on CUDA: {plain}")
    # the path's result against the native taps
    Xh = X.cpu().numpy()
    W = celt_taps.LEAF_X
    mask = np.arange(W)[None, :] < np.minimum(n, W)[:, None]
    a, b = np.where(mask, xo, 0), np.where(mask, Xh[:, :W], 0)
    rel_leaf = float((np.abs(a - b) / np.maximum(
        np.abs(a).max(axis=1, keepdims=True), 1e-3)).max())
    want = np.stack([f.X[0] for f in mono])
    sh = spec.cpu().numpy()
    rel_tap = float((np.abs(sh - want).max(axis=1)
                     / np.maximum(np.abs(want).max(axis=1), 1e-3)).max())
    seeds_ok = np.array_equal(seed.cpu().numpy(),
                              np.array([f.seed_out for f in mono], np.uint32))
    present = np.stack([bt["present"] for bt in bts]) > 0
    coll_ok = np.array_equal(coll.cpu().numpy()[present],
                             np.stack([f.collapse[0] for f in mono])[present])
    print(f"celt path vs the native taps: leaves rel {rel_leaf:.3e} (bound "
          f"1e-5), spectra rel {rel_tap:.3e} (bound 2e-5), end seeds equal "
          f"{seeds_ok}, collapse masks equal {coll_ok}")
    check(rel_leaf < 1e-5 and rel_tap < 2e-5 and seeds_ok and coll_ok,
          "the celt path disagrees with the native taps")

    rows = []
    # K11
    lb = convert.leaf_batch(n, k, idx, gain, spread, blocks, dev)
    y = dc.cwrsi_cuda(lb["n"], lb["k"], lb["idx"])
    ok = torch.equal(y, dc.cwrsi_plain(lb["n"], lb["k"], lb["idx"]))
    native = np.array_equal(y.cpu().numpy(), dc.host_reference(n, k, idx))
    sel = n <= 24
    lbs = convert.leaf_batch(n[sel], k[sel], idx[sel], gain[sel],
                             spread[sel], blocks[sel], dev)
    lay = [torch.equal(dc.cwrsi_cuda(lbs["n"], lbs["k"], lbs["idx"], al, 24),
                       dc.cwrsi_plain(lbs["n"], lbs["k"], lbs["idx"], al, 24))
           for al in (True, False)]
    print(f"K11 cwrsi [{len(n)} leaves]: equal to its twin {ok}, to the "
          f"native walk {native}; n_max 24 ({int(sel.sum())} leaves) aligned "
          f"and walk order equal {lay}")
    check(ok and native and all(lay), "K11 disagrees")
    for name, (cn, ck, ci) in cwrsi_corpus().items():
        same = {}
        for n_max in (96, 24):
            sub = cn <= n_max
            a = [torch.from_numpy(v[sub]).to(dev) for v in (cn, ck, ci)]
            for al in (True, False):
                same[n_max, al] = torch.equal(dc.cwrsi_cuda(*a, al, n_max),
                                              dc.cwrsi_plain(*a, al, n_max))
        a = [torch.from_numpy(v).to(dev) for v in (cn, ck, ci)]
        native = np.array_equal(dc.cwrsi_cuda(*a).cpu().numpy(),
                                dc.host_reference(cn, ck, ci))
        print(f"K11 on the {name} corpus [{len(cn)} leaves]: equal to its "
              f"twin at (n_max, aligned) {same}, to the native walk {native}")
        check(all(same.values()) and native, f"K11 disagrees on {name}")
    args = (lb["n"], lb["k"], lb["idx"])
    ms, plain_ms = _twin_times(tag, f"K11 [{len(n)} leaves]",
                               lambda: dc.cwrsi_cuda(*args),
                               lambda: dc.cwrsi_plain(*args), plain_reps=5)
    nd = device_launches(lambda: dc.cwrsi_cuda(*args))
    check(nd == 1, f"K11 made {nd} device launches a call")
    moved = nbytes(*args, dc.rows_on(dev), y)
    ops = k11_ops(n)
    b = bound(moved, ops, INT32_OPS)
    print(f"K11 bound {b['bound_ms']:.5f} ms ({b['bound_by']}; "
          f"{moved / 1e6:.2f} MB, {ops / 1e6:.2f} M integer operations)")
    rows.append(dict(name="k11_cwrsi", max_abs_err=0.0, ms=ms,
                     plain_ms=plain_ms, library_ms=None, **b))

    # K12: normalize and rotate (the path's entry), then the LCG entries
    cfg, bank = dl.rotation_plan(n, k, spread, blocks)
    cfg_t = torch.from_numpy(cfg).to(dev)
    bank_t = torch.from_numpy(bank).to(dev)
    g = lb["gain"]
    got = dl.normalize_rotate(y, g, cfg_t, bank_t)
    ref = dl.normalize_rotate_plain(y, g, cfg_t, bank_t)
    err = float((got - ref).abs().max())
    rel = float(((got - ref).abs().amax(1) / ref.abs().amax(1)).max())
    norm_eq = torch.equal(dl.normalize_pulses(y, g),
                          dl.normalize_rotate_plain(y, g))
    rot = int((cfg >= 0).sum())
    print(f"K12 normalize + rotate [{len(n)} leaves, {rot} rotating, "
          f"{len(bank)} configurations]: rel {rel:.3e} of each row's peak "
          f"(bound 1e-6), max|diff| {err:.3e}; the normalization alone "
          f"bit-equal {norm_eq}")
    check(rel <= 1e-6 and norm_eq, "K12 disagrees with its twin")
    rng = np.random.default_rng(17)
    draws = torch.from_numpy(rng.choice([0, 0, 0, 4, 8, 16, 22, 176],
                                        len(n)).astype(np.int32)).to(dev)
    entry = dl.lcg_leaf_entry_seeds(0xDEADBEEF, draws)
    fill = dl.lcg_noise_fill(entry, draws, 176)
    lcg_ok = (torch.equal(entry.view(torch.int32),
                          dl.lcg_leaf_entry_seeds(0xDEADBEEF, draws.cpu()
                                                  ).view(torch.int32).to(dev))
              and torch.equal(fill.view(torch.int32),
                              dl.lcg_noise_fill(entry.cpu(), None, 176).view(
                                  torch.int32).to(dev)))
    print(f"K12 LCG entry seeds [{len(n)}] and draws [{len(n)}, 176]: equal "
          f"to the twins {lcg_ok}")
    check(lcg_ok, "K12's LCG disagrees with its twin")
    ms, plain_ms = _twin_times(
        tag, f"K12 normalize + rotate [{len(n)} leaves]",
        lambda: dl.normalize_rotate(y, g, cfg_t, bank_t),
        lambda: dl.normalize_rotate_plain(y, g, cfg_t, bank_t), plain_reps=5)
    nd = device_launches(lambda: dl.normalize_rotate(y, g, cfg_t, bank_t))
    check(nd == 1, f"K12 made {nd} device launches a call")
    _twin_times(tag, f"K12 LCG entry seeds [{len(n)}]",
                lambda: dl.lcg_leaf_entry_seeds(0xDEADBEEF, draws),
                lambda: dl.lcg_leaf_entry_seeds(0xDEADBEEF, draws.cpu()),
                plain_reps=5)
    used = np.unique(cfg[cfg >= 0])
    moved = nbytes(y, g, cfg_t, got) + len(used) * bank[0].nbytes
    ops = float(len(n) * 3 * dc.N_MAX + rot * 2 * dl.ROT_W ** 2)
    b = bound(moved, ops, FP32_FLOPS)
    print(f"K12 bound {b['bound_ms']:.5f} ms ({b['bound_by']}; "
          f"{moved / 1e6:.2f} MB, {ops / 1e6:.2f} M flops)")
    sel_t = torch.from_numpy(np.flatnonzero(cfg >= 0)).to(dev)
    mats = bank_t[cfg_t[sel_t].long()]
    xs = dl.normalize_pulses(y, g)[sel_t][:, :, None]
    bmm = torch.bmm(mats, xs)[:, :, 0]
    e = float(((bmm - got[sel_t]).abs().amax(1)
               / got[sel_t].abs().amax(1)).max())
    check(e <= 1e-6, f"torch.bmm disagrees with K12's rotations: {e}")
    lib_ms = cuda_ms(lambda: torch.bmm(mats, xs))
    lib_dev, _ = device_ms(lambda: torch.bmm(mats, xs), "torch.bmm for K12")
    print(f"torch.bmm of the gathered bank [{rot}, 96, 96] x [{rot}, 96, 1] "
          f"(the rotations alone): {lib_ms:.4f} ms per call, device "
          f"{lib_dev:.4f} ms, rel {e:.3e} vs K12 {tag}")
    # like for like: K12 in its apply_rotations mode on the same rows
    xr, cr = xs[:, :, 0].contiguous(), cfg_t[sel_t].contiguous()
    ar = dl.apply_rotations(xr, cr, bank_t)
    aw = dl.apply_rotations(xr.cpu(), cr.cpu(), bank_t.cpu()).to(dev)
    e_ar = float(((ar - aw).abs().amax(1) / aw.abs().amax(1)).max())
    e_bmm = float(((ar - bmm).abs().amax(1) / bmm.abs().amax(1)).max())
    check(e_ar <= 1e-6 and e_bmm <= 1e-6,
          f"K12's apply_rotations disagrees: {e_ar} (twin), {e_bmm} (bmm)")
    ar_ms = cuda_ms(lambda: dl.apply_rotations(xr, cr, bank_t))
    ar_dev, _ = device_ms(lambda: dl.apply_rotations(xr, cr, bank_t),
                          "K12 apply_rotations")
    print(f"K12 apply_rotations [{rot} rows, {len(bank)} configurations]: "
          f"{ar_ms:.4f} ms per call, device {ar_dev:.4f} ms, against "
          f"torch.bmm on the same rows {lib_ms:.4f} / {lib_dev:.4f} ms; rel "
          f"{e_ar:.3e} vs its twin, {e_bmm:.3e} vs bmm {tag}")
    rows.append(dict(name="k12_leaf", max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, library_ms=lib_ms, **b))

    # K13: the 32 frames in one launch against the twin and F = 1 calls
    bt, lt = convert.packed_frame(bts, lts, dev)
    s0 = torch.from_numpy(np.array(seeds, np.uint32)).to(dev)
    sp, kp, cp = db.run_frames_plain(bt, lt, s0)
    sc, kc, cc = db.run_frames_cuda(bt, lt, s0)
    err = float((sc - sp).abs().max())
    rel = float(((sc - sp).abs().amax(1) / sp.abs().amax(1)).max())
    exact = (torch.equal(kc.view(torch.int32), kp.view(torch.int32))
             and torch.equal(cc.view(torch.int32), cp.view(torch.int32)))
    one = all(torch.equal(db.run_frame(bts[j], lts[j], seeds[j],
                                       device=dev)[0], sc[j])
              for j in (0, 7, 31))
    print(f"K13 band walk [{len(bts)} frames]: spectra rel {rel:.3e} of each "
          f"frame's peak vs its twin (bound 2e-5), max|diff| {err:.3e}; seeds "
          f"and collapse masks equal {exact}; frames 0, 7, 31 as F = 1 calls "
          f"bit-equal {one}")
    check(rel < 2e-5 and exact and one, "K13 disagrees with its twin")
    ms, plain_ms = _twin_times(tag, f"K13 [{len(bts)} frames]",
                               lambda: db.run_frames_cuda(bt, lt, s0),
                               lambda: db.run_frames_plain(bt, lt, s0),
                               plain_reps=3)
    nd = device_launches(lambda: db.run_frames_cuda(bt, lt, s0))
    check(nd == 1, f"K13 made {nd} device launches a call")
    moved = k13_bytes(bt, lt)
    ops = k13_ops(bt, lt)
    b = bound(moved, ops, FP32_FLOPS)
    print(f"K13 bound {b['bound_ms']:.5f} ms ({b['bound_by']}; "
          f"{moved / 1e6:.2f} MB, {ops / 1e6:.2f} M flops)")
    rows.append(dict(name="k13_bands", max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, library_ms=None, **b))
    return rows, {dc.K11.symbol: launches[dc.K11.symbol],
                  dl.K12.symbol: sum(launches[kk.symbol]
                                     for kk in dl.KERNELS),
                  db.K13.symbol: launches[db.K13.symbol]}


# --- phase 18: the multi-device decoders --------------------------------------

def multidevice_phase(dev, tag, kernels):
    """ShardedStreamDecoder (4 shards, over the visible cards) on each
    content against the card's batched decode, with the path's launches
    and both realtime factors; PipelinedStreamDecoder on the sample; the
    scaling rows at 1/2/4 shards."""
    from iamf_tpu_torch.codecs.aac.synth import K7
    from iamf_tpu_torch.codecs.opus.imdct import K1
    from iamf_tpu_torch.codecs.opus.synth import K2
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
    from iamf_tpu_torch.dsp.limiter import K3
    from iamf_tpu_torch.parallel.pp_decoder import PipelinedStreamDecoder
    from iamf_tpu_torch.parallel.sharded_decoder import ShardedStreamDecoder
    from iamf_tpu_torch.tools import scaling_bench, streams

    L = streams.ChannelLayout
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n30 = 1500  # 30 s of 960-sample frames; 4 shards of 375
    sample = scaling_bench.content("opus")
    # bursts over frames [b - 2, b + 2) of each shard boundary b: the
    # limiter's curve is live where its state crosses to the next shard
    loud = streams.build_pcm_layout_stream(
        L.L714, n_frames=n30, pcm_override=_loud_pcm(
            n30 * FRAME, 12, [((b - 2) * FRAME, (b + 2) * FRAME)
                              for b in (375, 750, 1125)]))[0]
    aac = streams.build_aac_layout_stream(L.L714, n_frames=1407, seed=5)[0]
    two = streams.build_two_element_stream(n_frames=n30,
                                           gain2_q78=-(3 << 8))[0]
    print(f"multi-device: {len(cards)} visible card(s), the shards "
          f"{'on the one card' if len(cards) == 1 else 'in blocks over them'}"
          f" {tag}")

    def counted(fn):
        fn()  # warm-up
        for k in kernels:
            k.reset()
        out = fn()
        return (out, {k.symbol: k.launches for k in kernels},
                {k.symbol: k.plain_on_cuda for k in kernels})

    cases = (  # label, stream, sound system, the batched decode's B, mesh,
        # the path's kernels
        ("pcm 7.1.4 30 s loud", loud, 9, B_MAIN, dict(n_devices=4), (K3,)),
        ("opus sample", sample, 9, B_OPUS, dict(n_devices=4), (K1, K2, K3)),
        ("aac 7.1.4 30 s", aac, 9, B_MAIN, dict(n_devices=4), (K7, K3)),
        ("two-element 30 s, (frames, elements) 2 x 2", two, 0, B_MAIN,
         dict(n_devices=4, element_axis=2), (K3,)),
        ("opus sample, (frames, substreams) 2 x 2", sample, 9, B_OPUS,
         dict(n_devices=4, substream_axis=2), (K1, K2, K3)),
    )
    for label, data, ss, bf, mesh, must in cases:
        def sharded():
            return ShardedStreamDecoder(data, sound_system=ss, device=dev,
                                        **mesh).decode_all()

        def batched():
            return BatchedStreamDecoder(data, sound_system=ss,
                                        batch_frames=bf,
                                        device=dev).decode_all()

        got, launches, plain = counted(sharded)
        want = batched()
        d = _lsb(got, want)
        peak = int(np.abs(want.astype(np.int32)).max())
        print(f"sharded {label}: shape {got.shape}, max|diff| vs the card's "
              f"batched decode {d} LSB, peak {peak}; launches {launches}")
        check(got.shape == want.shape and d <= 1, f"sharded {label}: {d} LSB")
        check(all(launches[k.symbol] > 0 for k in must),
              f"sharded {label}: a kernel of the path did not launch")
        check(not any(plain.values()), f"sharded {label}: a twin on CUDA")
        ws, wb = [], []
        for _ in range(3):  # in turns
            ws += timed(sharded, 1)
            wb += timed(batched, 1)
        secs = got.shape[0] / 48000.0
        print(f"sharded {label}: realtime {secs / np.median(ws):.2f}x "
              f"({_ms(ws)} ms), batched (B={bf}) {secs / np.median(wb):.2f}x "
              f"({_ms(wb)} ms), median of 3 each {tag}")
        if secs >= 10:
            trace_decode(sharded, f"sharded {label}")
            trace_decode(batched, f"batched {label}")

    pp_devs = [cards[0], cards[min(1, len(cards) - 1)]]
    got, launches, plain = counted(lambda: PipelinedStreamDecoder(
        sample, devices=pp_devs, sound_system=9,
        batch_frames=B_OPUS).decode_all())
    want = BatchedStreamDecoder(sample, sound_system=9, batch_frames=B_OPUS,
                                device=dev).decode_all()
    d = _lsb(got, want)
    print(f"pipelined opus sample on {[str(x) for x in pp_devs]}: max|diff| "
          f"vs the batched decode {d} LSB (equal: {np.array_equal(got, want)})"
          f"; launches {launches}")
    check(got.shape == want.shape and d <= 1, f"pipelined: {d} LSB")
    check(all(launches[k.symbol] > 0 for k in (K1, K2, K3)),
          "pipelined: a kernel of the path did not launch")
    check(not any(plain.values()), "pipelined: a twin on CUDA")

    for kind in ("pcm", "opus"):
        for r in scaling_bench.rows(scaling_bench.content(kind, n30), dev,
                                    shards=(1, 2, 4)):
            print(f"scaling {kind}: {json.dumps(r)} {tag}")


def main() -> int:
    from iamf_tpu_torch import require_cuda
    from iamf_tpu_torch.codecs.aac.synth import K7
    from iamf_tpu_torch.codecs.opus.device_bands import K13
    from iamf_tpu_torch.codecs.opus.device_cwrsi import K11
    from iamf_tpu_torch.codecs.opus.device_leaf import K12
    from iamf_tpu_torch.codecs.opus.imdct import K1
    from iamf_tpu_torch.codecs.opus.synth import K2
    from iamf_tpu_torch.dsp.binaural import K8
    from iamf_tpu_torch.dsp.limiter import K3, K9
    from iamf_tpu_torch.dsp.resample import K10
    from iamf_tpu_torch.kernels import build as kbuild

    dev = require_cuda()
    card = card_line()
    tag = f"[{card}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}")

    path, secs = kbuild.build(verbose=True)
    print(f"build: {secs:.2f} s for {len(kbuild.sources())} sources -> "
          f"{os.path.relpath(path, ROOT)}")

    t_all = time.perf_counter()

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t:.1f} s wall")
        return out

    kernels = (K1, K2, K3, K7, K8, K9, K10)
    rows = [phase("2 K1", k1_phase, dev, tag, path),
            phase("2 K2", k2_phase, dev, tag),
            phase("2 K3", k3_phase, dev, tag, path)]
    launches = phase("3 opus", opus_phase, dev, tag, (K1, K2, K3))
    phase("4 pcm", pcm_phase, dev, tag)
    rows += [phase("5 K8", k8_phase, dev, tag),
             phase("5 K10 K3", k10_k3_phase, dev, tag)]
    launches[K8.symbol] = phase("6 binaural", binaural_phase, dev, tag,
                                kernels)[K8.symbol]
    launches[K10.symbol] = phase("7 resampled", resample_phase, dev, tag,
                                 kernels)[K10.symbol]
    rows += [phase("8 K7", k7_phase, dev, tag, path),
             phase("8 K9", k9_phase, dev, tag, path)]
    launches[K7.symbol] = phase("9 aac", aac_phase, dev, tag, kernels,
                                (K1, K2, K8, K9, K10))[K7.symbol]
    launches[K9.symbol] = phase("10 true peak", truepeak_phase, dev, tag,
                                kernels, (K1, K2, K7, K8, K10))[K9.symbol]
    phase("11 stream axis", stream_axis_phase, dev, tag)
    phase("12 fleets", fleets_phase, dev, tag, kernels)
    phase("13 short fleets", short_fleets_phase, dev, tag, kernels)
    phase("14 reconfigure", reconfigure_phase, dev, tag, kernels)
    phase("15 mp4", mp4_phase, dev, tag, kernels)
    phase("16 serial", serial_phase, dev, tag, kernels)
    celt_rows, celt_launches = phase("17 celt device stages", celt_phase,
                                     dev, tag)
    rows += celt_rows
    launches.update(celt_launches)
    phase("18 multi-device", multidevice_phase, dev, tag, kernels)
    print(f"phases 2-18: {time.perf_counter() - t_all:.1f} s wall")

    meta = {
        "k1_imdct_tdac": ("iamf_tpu_torch/csrc/imdct.cu",
                          "iamf_tpu/codecs/opus/pallas_imdct.py:145", K1),
        "k2_comb_deemph_s16": ("iamf_tpu_torch/csrc/comb_deemph.cu",
                               "iamf_tpu/codecs/opus/tpu_synth.py:208", K2),
        "k3_limiter_quantize": ("iamf_tpu_torch/csrc/limiter.cu",
                                "iamf_tpu/core/pipeline.py:336", K3),
        "k8_hrtf_conv": ("iamf_tpu_torch/csrc/hrtf_conv.cu",
                         "iamf_tpu/core/pipeline.py:267", K8),
        "k10_resample": ("iamf_tpu_torch/csrc/resample.cu",
                         "iamf_tpu/dsp/resample.py:248", K10),
        "k7_aac_synth": ("iamf_tpu_torch/csrc/aac_synth.cu",
                         "iamf_tpu/codecs/aac/tpu_synth.py:148", K7),
        "k9_truepeak": ("iamf_tpu_torch/csrc/truepeak.cu",
                        "iamf_tpu/dsp/limiter.py:132", K9),
        "k11_cwrsi": ("iamf_tpu_torch/csrc/celt_cwrsi.cu",
                      "iamf_tpu/codecs/opus/device_cwrsi.py:84", K11),
        "k12_leaf": ("iamf_tpu_torch/csrc/celt_leaf.cu",
                     "iamf_tpu/codecs/opus/device_leaf.py:86", K12),
        "k13_bands": ("iamf_tpu_torch/csrc/celt_bands.cu",
                      "iamf_tpu/codecs/opus/device_bands.py:263", K13),
    }
    table = []
    for r in rows:
        src, rep, k = meta[r["name"]]
        table.append({"name": r["name"], "route": "cuda", "source": src,
                      "replaces": rep, "launches": launches[k.symbol],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"]})
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
