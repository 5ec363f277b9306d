#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (iamf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from iamf_tpu_torch/csrc, then:
  1. build: compiles the kernel library with nvcc and reports the seconds;
  2. kernels: K1 (IMDCT+TDAC), K2 (comb+de-emphasis+s16) and K3
     (limiter+quantize) at the main path's batch shape against their plain
     PyTorch twins, with each one's time and its twin's; K1 also at the
     Opus cell's batch of 8, with its device time (torch.profiler), and
     its product kernel's SASS must hold tensor-core (HGMMA) and TMA
     (UTMALDG) instructions;
  3. Opus end to end: iamf_tpu/data/sample_opus_714.iamf -> sound system J
     at batch_frames=8 against the stored golden (the JAX package's decode),
     with the kernels' launch counts from that run;
  4. PCM at the bench's size: 30 s of 7.1.4 PCM -> sound system J at
     batch_frames=128, and a short loud stream that engages the limiter,
     each against this package's own CPU run; realtime factors.
The last line is {"ok": true, "device": {...}}. Any failed check raises, and
the script exits non-zero without that line; so does a machine without a
visible CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
sys.modules["jax"] = None  # the port must run without JAX: fail loudly

import torch  # noqa: E402

B_MAIN = 128   # the bench's batch_frames
B_OPUS = 8     # the Opus cell's batch_frames
LANES = 12     # 7.1.4 lanes
FRAME = 960


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


def device_ms(fn, reps: int = 20) -> tuple[float, dict]:
    """Device time per call of fn() in ms from a torch.profiler trace of
    `reps` calls after a warm-up: the total over every kernel and memset,
    and the time of each by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {ev.key: ev.self_device_time_total / reps / 1e3
           for ev in prof.key_averages() if ev.self_device_time_total > 0}
    return sum(per.values()), per


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
            mats, freq, trans, tail0))
        prod = sum(v for k, v in per.items() if "k1_product" in k)
        dev_plain, _ = device_ms(lambda: imdct.imdct_overlap_plain(
            mats, freq, trans, tail0))
        gflop = B * LANES * FRAME * (FRAME + 60) * 2 / 1e9
        print(f"K1 time [B={B}] {ms:.4f} ms per call ({gflop / ms:.2f} "
              f"TFLOP/s of useful fp32-equivalent work, split-TF32 tensor "
              f"cores), plain twin (torch.matmul fp32, both modes) "
              f"{plain:.4f} ms; device time per call {dev_ms:.4f} ms "
              f"(product kernel {prod:.4f} ms), twin {dev_plain:.4f} ms "
              f"{tag}")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if B == B_MAIN:
            row.update(ms=ms, plain_ms=plain)
    return row


def _comb_params(rng, B, L):
    """Legal random comb parameters with period/gain changes between
    frames: periods 15..1024, gains 0.09375*(1..8) times a tapset row."""
    taps = np.load(os.path.join(
        ROOT, "iamf_tpu", "codecs", "opus", "data",
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


def k2_phase(dev, tag):
    from iamf_tpu_torch.codecs.opus import synth

    rng = np.random.RandomState(1)
    B, L = B_MAIN, LANES
    buf = np.zeros((B, L, FRAME + 13), np.float32)
    buf[..., FRAME:] = _comb_params(rng, B, L)
    buf = torch.from_numpy(buf).to(dev)
    y = torch.from_numpy(
        rng.randn(B, L, FRAME).astype(np.float32) * 3000.0).to(dev)
    hist = torch.from_numpy(
        rng.randn(L, synth.HIST).astype(np.float32) * 3000.0).to(dev)
    demem = torch.from_numpy(rng.randn(L).astype(np.float32) * 100.0).to(dev)
    window = torch.from_numpy(synth.window120().copy()).to(dev)
    pcm, h2, m2 = synth.comb_deemph_cuda(window, y, buf, hist, demem)
    plain_ms, (pcm_p, h2_p, m2_p) = host_ms(
        lambda: synth.comb_deemph_plain(window, y, buf, hist, demem))
    d = ((pcm - pcm_p) * 32768.0).abs()
    err = float(d.max())
    n_diff = int((d > 0).sum())
    hist_err = float((h2 - h2_p).abs().max())
    print(f"K2 comb+deemph [{L}, {B}*960]: max|diff| {err:.0f} s16 LSB, "
          f"{n_diff} of {d.numel()} samples differ (bound 1 LSB); comb "
          f"history max|diff| {hist_err:.3e}")
    check(err <= 1.0, f"K2 disagrees with its plain twin: {err} LSB")
    ms = cuda_ms(lambda: synth.comb_deemph_cuda(window, y, buf, hist, demem),
                 reps=5, warm=1)
    print(f"K2 time {ms:.4f} ms, plain twin (chunked comb + blocked "
          f"de-emphasis, torch ops on the card) {plain_ms:.1f} ms {tag}")
    return dict(name="k2_comb_deemph_s16", max_abs_err=err, ms=ms,
                plain_ms=plain_ms)


def _loud_planar(n_total, nch, burst_lo, burst_hi):
    """Sine bed at 0.4 FS with a +4 dB burst over [burst_lo, burst_hi)
    (the _loud_pcm pattern of tests/test_sharded_decoder.py), planar
    float32 [nch, n_total] at full scale 1.0."""
    import vectors

    pcm = vectors.sine_pcm(n_total, nch, 48000, amp=0.4, bits=16, seed=3)
    burst = vectors.sine_pcm(burst_hi - burst_lo, nch, 48000, amp=1.45,
                             bits=16, seed=4)
    pcm[burst_lo:burst_hi] = np.clip(burst, -32768, 32767)
    return (pcm.T / 32768.0).astype(np.float32)


def k3_phase(dev, tag):
    from iamf_tpu_torch.dsp import limiter

    N = B_MAIN * FRAME
    C = LANES
    # burst spans the edge between two batches: attack in the first,
    # release (200 ms) running on into the second
    x = _loud_planar(2 * N, C, N - 4 * FRAME, N + 2 * FRAME)
    cfg = limiter.LimiterConfig(channels=C)
    xa, xb = torch.from_numpy(x[:, :N]), torch.from_numpy(x[:, N:])

    st = limiter.init_state(cfg, dev)
    st1, pa = limiter.limit_quantize_cuda(cfg, st, xa.to(dev), 16)
    st2, pb = limiter.limit_quantize_cuda(cfg, st1, xb.to(dev), 16)
    # plain twin on a CPU copy: its per-sample loop on the card would be a
    # launch per sample, which is what K3 replaces
    sc = limiter.init_state(cfg, "cpu")
    t = time.perf_counter()
    sc1, qa = limiter.limit_quantize(cfg, sc, xa, 16, FRAME)
    plain_ms = (time.perf_counter() - t) * 1e3
    sc2, qb = limiter.limit_quantize(cfg, sc1, xb, 16, FRAME)
    got = torch.cat([pa, pb]).cpu().numpy().astype(np.int32)
    want = torch.cat([qa, qb]).numpy().astype(np.int32)
    err = int(np.abs(got - want).max())
    env_err = float((st2["env"].cpu() - sc2["env"]).abs().max())
    engaged = int(np.abs(want).max())
    print(f"K3 limiter+quantize [{C}, 2x{N}] with a +4 dB burst across the "
          f"batch edge: int16 max|diff| {err} (bound 1), envelope state "
          f"max|diff| {env_err:.3e}, output peak {engaged}")
    check(err <= 1, f"K3 disagrees with its plain twin: {err} LSB")
    check(engaged < 29300 and float(sc1["env"][3]) != -1.0,
          "the limiter did not engage")
    xa_d = xa.to(dev)
    ms = cuda_ms(lambda: limiter.limit_quantize_cuda(cfg, st, xa_d, 16),
                 reps=10, warm=1)
    print(f"K3 time {ms:.4f} ms per {B_MAIN}-frame batch (attack batch), "
          f"plain twin on the host CPU {plain_ms:.1f} ms {tag}")
    return dict(name="k3_limiter_quantize", max_abs_err=float(err), ms=ms,
                plain_ms=plain_ms)


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
    import vectors
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

    L714 = vectors.ChannelLayout.L714

    def run(stream, device, bf):
        return BatchedStreamDecoder(stream, sound_system=9, batch_frames=bf,
                                    device=device).decode_all()

    n30 = 1500  # 30 s of 960-sample frames
    stream, _ = vectors.build_pcm_layout_stream(
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
    stream, _ = vectors.build_pcm_layout_stream(
        L714, n_frames=n_loud, pcm_override=loud)
    got = run(stream, dev, 16)
    want = run(stream, "cpu", 16)
    d = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    peak = int(np.abs(want.astype(np.int32)).max())
    print(f"pcm loud stream (limiter engaged, peak {peak}): max|diff| vs "
          f"CPU run {d} LSB")
    check(got.shape == want.shape and d <= 1, f"loud pcm decode: {d} LSB")
    check(28000 <= peak < 29300, f"limiter did not engage: peak {peak}")


def main() -> int:
    from iamf_tpu_torch import require_cuda
    from iamf_tpu_torch.codecs.opus.imdct import K1
    from iamf_tpu_torch.codecs.opus.synth import K2
    from iamf_tpu_torch.dsp.limiter import K3
    from iamf_tpu_torch.kernels import build as kbuild

    dev = require_cuda()
    card = card_line()
    tag = f"[{card}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}")

    path, secs = kbuild.build(verbose=True)
    print(f"build: {secs:.2f} s for {len(kbuild.sources())} sources -> "
          f"{os.path.relpath(path, ROOT)}")

    rows = [k1_phase(dev, tag, path), k2_phase(dev, tag), k3_phase(dev, tag)]
    kernels = (K1, K2, K3)
    launches = opus_phase(dev, tag, kernels)
    pcm_phase(dev, tag)

    meta = {
        "k1_imdct_tdac": ("iamf_tpu_torch/csrc/imdct.cu",
                          "iamf_tpu/codecs/opus/pallas_imdct.py:145", K1),
        "k2_comb_deemph_s16": ("iamf_tpu_torch/csrc/comb_deemph.cu",
                               "iamf_tpu/codecs/opus/tpu_synth.py:208", K2),
        "k3_limiter_quantize": ("iamf_tpu_torch/csrc/limiter.cu",
                                "iamf_tpu/core/pipeline.py:336", K3),
    }
    table = []
    for r in rows:
        src, rep, k = meta[r["name"]]
        table.append({"name": r["name"], "route": "cuda", "source": src,
                      "replaces": rep, "launches": launches[k.symbol],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"]})
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
