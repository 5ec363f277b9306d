"""The yardstick of the kernels' roofline shares, frozen.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W), as
chip_smoke.py:185-189 states them. A function's bound is the larger of
its bytes over the memory rate (each input read once, each output written
once) and its fewest operations over the peak of their type
(chip_smoke.bound, chip_smoke.py:355). The counts are those of
chip_smoke.py's phases (K1 :385 and :440, K2 :571, K3 :703, K8 :849 and
fft_conv_ops :857), taken over the work the cell's streams need: every
frame of every stream once, no batch padding, no flush.
"""

from __future__ import annotations

import math

HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
FRAME = 960
OVERLAP_HALF = 60


def bound_s(n_bytes: float, ops: float, rate: float = FP32_FLOPS) -> float:
    """The least seconds a call of n_bytes and `ops` operations can take."""
    return max(n_bytes / HBM_BPS, ops / rate)


def fft_imdct_flops(n: int) -> float:
    """The fewest fp32 operations of an n-output IMDCT: an n/4-point
    complex FFT with pre- and post-twiddles."""
    q = n // 4
    return 5 * q * math.log2(q) + 12 * q


def k1_bound(frames: int, lanes: int) -> float:
    """IMDCT + TDAC of `frames` frames of `lanes` channel lanes: spectra
    and the transient flags in, samples out, the 60-sample tails in and out
    a lane; the fewest operations (every frame as eight short blocks, the
    cheaper form) and the window overlap's multiply-adds."""
    rows = frames * lanes
    n_bytes = rows * (FRAME * 4 + 1 + FRAME * 4) + 2 * lanes * OVERLAP_HALF * 4
    ops = rows * (8 * fft_imdct_flops(2 * FRAME // 8) + 2 * (120 + 60))
    return bound_s(n_bytes, ops)


def k2_bound(frames: int, lanes: int) -> float:
    """Comb post-filter + de-emphasis + s16 of `frames` frames of `lanes`
    lanes: IMDCT output and 13 parameters a frame in, samples out, the
    1032-sample history and the de-emphasis memory in and out a lane;
    about 16 operations a sample."""
    rows = frames * lanes
    n_bytes = (rows * (FRAME * 4 + 13 * 4 + FRAME * 4)
               + 2 * lanes * (1032 + 1) * 4 + 120 * 4)
    return bound_s(n_bytes, 16 * rows * FRAME)


def k3_bound(samples: int, channels: int, delay: int = 240) -> float:
    """Limiter + quantize of one stream's `samples` x `channels` mix:
    float32 in, int16 out, the delay line and peak ring in and out; per
    sample the channel max, 3 for the sliding window max, about 10 for the
    gain recurrence, 3 a channel for the quantize."""
    n_bytes = (samples * channels * (4 + 2)
               + 2 * (4 * channels * delay + 4 * delay + 4 + 16))
    return bound_s(n_bytes, samples * (2 * channels + 3 + 10 + 3 * channels))


def fft_conv_ops(c_in: int, c_out: int, n: int, taps: int) -> float:
    """The fewest fp32 operations of convolving c_in channels of n samples
    with c_in x c_out filters summed into c_out outputs: overlap-save with
    real FFTs of F points, the least over F."""
    best = math.inf
    for k in range(int(math.log2(taps)) + 1, 17):
        F = 1 << k
        fft = 2.5 * F * k
        blocks = math.ceil(n / (F - taps + 1))
        best = min(best, c_in * c_out * fft + blocks * (
            (c_in + c_out) * fft + 8 * c_in * c_out * (F // 2 + 1)))
    return best


def k8_bound(samples: int, channels: int, taps: int = 256) -> float:
    """The HRTF convolution of one stream's bed [channels, samples] to two
    ears: the bed, the bank and the overlap in, the ears and the overlap
    out."""
    n_bytes = (samples * channels * 4 + 2 * channels * taps * 4
               + 2 * 2 * (taps - 1) * 4 + samples * 2 * 4)
    return bound_s(n_bytes, fft_conv_ops(channels, 2, samples, taps))
