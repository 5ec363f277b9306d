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
     each against this package's own CPU run; realtime factors;
  5. kernels of the output paths: K8 (HRTF convolution) at B=128 and B=3
     with 12- and 10-channel beds and a live overlap carry, K10 (resampler)
     over 30 s of 12 channels at 44.1 kHz and on short 16/32/96 kHz inputs,
     and K3 over the whole resampled stream, against their plain twins,
     with times per call (CUDA events) and device times (torch.profiler);
  6. binaural at full width: 30 s of 7.1.4 PCM with headphones rendering
     mode 1 (M2B, 12-channel bed) at batch_frames=128, limiter on, against
     the CPU run, with its realtime factor, K8's launches and a profiler
     trace; short H2B (FOA), two-element and mode-0 (matrix, no K8) runs;
  7. resampled at full width: 30 s of 7.1.4 PCM at 44.1 kHz -> sound
     system J at batch_frames=128, limiter on, likewise (K10 and K3); short
     5.1 runs with normalization, limiter on and off.
Every kernel's launch count in the kernels line comes from the run of the
path it serves (K1/K2/K3 the Opus decode, K8 the binaural, K10 the
resampled one), with the counts set to 0 just before that run.
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


# --- phase 5: the output paths' kernels --------------------------------------

def _twin_times(tag, name, fast, plain, reps=20, plain_reps=20):
    ms = cuda_ms(fast, reps=reps)
    plain_ms = cuda_ms(plain, reps=plain_reps, warm=1)
    dev_ms, _ = device_ms(fast, reps=reps)
    dev_plain, _ = device_ms(plain, reps=plain_reps)
    print(f"{name} time {ms:.4f} ms per call, plain twin {plain_ms:.4f} ms; "
          f"device time per call {dev_ms:.4f} ms, twin {dev_plain:.4f} ms "
          f"{tag}")
    return ms, plain_ms


def k8_phase(dev, tag):
    import vectors
    from iamf_tpu_torch.dsp import binaural

    L = vectors.ChannelLayout
    row = dict(name="k8_hrtf_conv", max_abs_err=0.0)
    for C, layout in ((12, L.L714), (10, L.L712)):
        bank = binaural.hrir_bank(layout)
        for B in (B_MAIN, 3):
            rng = np.random.RandomState(C * 1000 + B)
            h = binaural.hrir_for_batch(bank, B, FRAME, dev)
            x = torch.from_numpy((rng.randn(C, B * FRAME) * 0.3).astype(
                np.float32)).to(dev)
            ov = torch.from_numpy((rng.randn(2, 255) * 0.1).astype(
                np.float32)).to(dev)
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
            gfma = 2 * C * 256 * B * FRAME / 1e9
            print(f"K8 [C={C}, B={B}]: {gfma / ms:.2f} T FMA/s per call")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if (C, B) == (LANES, B_MAIN):
                row.update(ms=ms, plain_ms=plain)
    return row


def k10_k3_phase(dev, tag):
    from iamf_tpu_torch.dsp import limiter, resample

    row = dict(name="k10_resample", max_abs_err=0.0)
    for rate, secs in ((44100, 30.0), (16000, 0.5), (32000, 0.5),
                       (96000, 0.5)):
        rng = np.random.RandomState(rate % 1009)
        n_in = int(rate * secs)
        x = torch.from_numpy((rng.randn(LANES, n_in) * 0.3).astype(
            np.float32)).to(dev)
        plan = resample.ResamplePlan(rate, 48000, device=dev)
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
            row.update(ms=ms, plain_ms=plain)

    # K3 over a whole resampled stream, as the resample tail calls it:
    # 30 s at 48 kHz plus the delay_size drain, one call; a sine bed with a
    # +4 dB burst of 1 s (attack, then a 200 ms release)
    n = 48000 * 30
    xs = torch.from_numpy(np.concatenate(
        [_loud_planar(n, LANES, n // 2, n // 2 + 48000),
         np.zeros((LANES, 240), np.float32)], axis=1))
    cfg = limiter.LimiterConfig(channels=LANES)
    x_d = xs.to(dev)
    st = limiter.init_state(cfg, dev)
    _, q = limiter.limit_quantize_cuda(cfg, st, x_d, 16)
    t = time.perf_counter()
    _, q_p = limiter.limit_quantize(cfg, limiter.init_state(cfg, "cpu"),
                                    xs, 16, FRAME)
    plain_ms = (time.perf_counter() - t) * 1e3
    err = int((q.cpu().to(torch.int32) - q_p.to(torch.int32)).abs().max())
    print(f"K3 over a 30 s stream [{LANES}, {xs.shape[1]}] with a +4 dB "
          f"burst: int16 max|diff| {err} (bound 1)")
    check(err <= 1, f"K3 on the whole stream: {err} LSB")
    ms = cuda_ms(lambda: limiter.limit_quantize_cuda(cfg, st, x_d, 16),
                 reps=5, warm=1)
    dev_ms, per = device_ms(
        lambda: limiter.limit_quantize_cuda(cfg, st, x_d, 16), reps=5)
    walk = sum(v for k, v in per.items() if "gain_walk" in k)
    print(f"K3 [{LANES}, {xs.shape[1]}] time {ms:.4f} ms per call, device "
          f"{dev_ms:.4f} ms (gain walk {walk:.4f} ms); plain twin on the "
          f"host CPU {plain_ms:.1f} ms {tag}")
    return row


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
    import vectors
    from iamf_tpu_torch.dsp.binaural import K8
    from iamf_tpu_torch.dsp.limiter import K3
    from iamf_tpu_torch.dsp.resample import K10

    L = vectors.ChannelLayout
    stream, _ = vectors.build_pcm_layout_stream(L.L714, n_frames=1500,
                                                amp=0.5, hrm=1)
    launches = decode_path(
        dev, tag, "binaural 7.1.4 M2B 30 s", stream,
        dict(binaural=True, batch_frames=B_MAIN), kernels, (K8, K3), (K10,))
    short = {
        "binaural FOA H2B": (vectors.build_ambisonics_pcm_stream(
            order=1, n_frames=40, target_layouts=(0,), hrm=1)[0], (K8,), ()),
        "binaural two elements M2B + H2B": (vectors.build_two_element_stream(
            n_frames=40, gain2_q78=-(3 << 8), hrm=1)[0], (K8,), ()),
        "binaural 5.1 mode 0 (matrix)": (vectors.build_pcm_51_stream(
            n_frames=40)[0], (K3,), (K8,)),
    }
    for label, (data, must, must_not) in short.items():
        decode_path(dev, tag, label, data,
                    dict(binaural=True, batch_frames=16), kernels, must,
                    must_not)
    return launches


def resample_phase(dev, tag, kernels):
    import vectors
    from iamf_tpu_torch.dsp.binaural import K8
    from iamf_tpu_torch.dsp.limiter import K3
    from iamf_tpu_torch.dsp.resample import K10

    L = vectors.ChannelLayout
    stream, _ = vectors.build_pcm_layout_stream(
        L.L714, n_frames=1378, amp=0.5, rate=44100)
    launches = decode_path(
        dev, tag, "pcm 7.1.4 44.1 kHz 30 s -> ssJ", stream,
        dict(sound_system=9, batch_frames=B_MAIN), kernels, (K10, K3), (K8,))
    data = vectors.build_pcm_51_stream(n_frames=40, rate=44100)[0]
    decode_path(dev, tag, "pcm 5.1 44.1 kHz, normalization -10 dB", data,
                dict(sound_system=1, batch_frames=16,
                     normalization_db=-10.0), kernels, (K10, K3))
    decode_path(dev, tag, "pcm 5.1 44.1 kHz, no limiter", data,
                dict(sound_system=1, batch_frames=16, limiter=False),
                kernels, (K10,), (K3,))
    return launches


def main() -> int:
    from iamf_tpu_torch import require_cuda
    from iamf_tpu_torch.codecs.opus.imdct import K1
    from iamf_tpu_torch.codecs.opus.synth import K2
    from iamf_tpu_torch.dsp.binaural import K8
    from iamf_tpu_torch.dsp.limiter import K3
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

    rows = [k1_phase(dev, tag, path), k2_phase(dev, tag), k3_phase(dev, tag)]
    kernels = (K1, K2, K3, K8, K10)
    launches = opus_phase(dev, tag, (K1, K2, K3))
    pcm_phase(dev, tag)
    rows += [k8_phase(dev, tag), k10_k3_phase(dev, tag)]
    launches[K8.symbol] = binaural_phase(dev, tag, kernels)[K8.symbol]
    launches[K10.symbol] = resample_phase(dev, tag, kernels)[K10.symbol]

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
