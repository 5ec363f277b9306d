"""The IAMF decoder's look-ahead peak limiter and s16 output, plain NumPy.

Reference: libiamf audio_effect_peak_limiter.c (process_block,
compute_target_gain, curve_accel) and IAMF_decoder.c's planar-to-stride
output. Per sample k of a stream's mix x [C, S] (gain-1 samples before it
and silence after):
- the peak ring holds max_c |x| of the last D = 240 samples; the window
  peak at step k is the largest of x[k - D .. k - 1];
- the gain follows a parabolic attack (1 ms) toward threshold / peak and
  a parabolic release (200 ms) back to 1, retriggered whenever
  peak * gain exceeds the threshold (-1 dBFS);
- the output at step k is x[k - D] * gain_k.

The gain recurrence runs in float32 in the reference's operation order
(the C code's floats), so its gains are those of the specification. It is
evaluated from a table of the envelope's times: after a trigger its time
advances by 1/48000 a step, so its value depends only on the steps since
the trigger.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.ndimage import maximum_filter1d

from . import DELAY, RATE

THRESHOLD_DB = -1.0
ATTACK_S = 0.001
RELEASE_S = 0.200

f32 = np.float32


def _curve_accel(v: np.ndarray) -> np.ndarray:
    d = v - f32(1.0)
    return np.where(v > f32(1.0), f32(1.0),
                    np.where(v < f32(0.0), f32(0.0), f32(1.0) - d * d))


@functools.lru_cache(maxsize=None)
def tables():
    """(coef [M + 1], M, A): the envelope times tc = T[m], m steps after a
    trigger (T[0] = 0, T[m + 1] = T[m] + 1/48000 in float32, up to the
    first at or past release + attack), and the curve's value at each:
    -curve(T[m] / attack) for the A attack steps, curve((T[m] - attack) /
    release) for the release ones."""
    atk, rel, inc = f32(ATTACK_S), f32(RELEASE_S), f32(1.0) / f32(RATE)
    t = [f32(0.0)]
    while t[-1] < rel + atk:
        t.append(f32(t[-1] + inc))
    T = np.array(t, np.float32)
    M = len(T) - 1
    A = int(np.count_nonzero(T < atk))
    attack = np.arange(M) < A
    v = np.where(attack, T[1:] / atk, (T[1:] - atk) / rel).astype(np.float32)
    c = _curve_accel(v).astype(np.float32)
    coef = np.zeros(M + 1, np.float32)
    coef[1:] = np.where(attack, -c, c)
    return coef, M, A


def gains(window_peaks: np.ndarray) -> np.ndarray:
    """float32 gains [S] for window peaks [S] (float32), from the idle
    envelope (gain 1): a scalar walk from each trigger until the envelope
    settles, then a search for the next peak over the threshold."""
    coef, M, A = tables()
    thr = f32(10.0 ** (THRESHOLD_DB / 20.0))
    one = f32(1.0)
    S = len(window_peaks)
    c = list(coef)
    w = list(window_peaks.astype(np.float32))
    g = [one] * S
    over = np.flatnonzero(window_peaks > thr)
    k = int(over[0]) if len(over) else S
    while k < S:
        # a trigger at step k: its own gain is the one before the test
        tsg, teg = g[k], thr / w[k]
        d_att, d_rel = tsg - teg, one - teg
        m, j = 0, k + 1
        while j < S:
            m += 1
            if m > M:
                break  # settled at gain 1
            gj = tsg + c[m] * d_att if m <= A else teg + c[m] * d_rel
            g[j] = gj
            if w[j] * gj > thr:
                tsg, teg, m = gj, thr / w[j], 0
                d_att, d_rel = tsg - teg, one - teg
            j += 1
        i = int(np.searchsorted(over, j))
        k = int(over[i]) if i < len(over) else S
    return np.array(g, np.float32)


def limit_s16(x: np.ndarray, want: int) -> np.ndarray:
    """The limited s16 output [want, C] of the mix x [C, S] (float, full
    scale 1.0; what x holds past `want`, such as a filter's tail, feeds
    the look-ahead, silence past S): steps D .. D + want - 1 of the
    limiter, which emit x[0 .. want - 1]."""
    C = x.shape[0]
    steps = DELAY + want
    # the delay line's zeros, x, then silence: xs[D + i] = x[i]
    xs = np.zeros((C, steps + DELAY), np.float32)
    n = min(want + DELAY, x.shape[1])
    xs[:, DELAY:DELAY + n] = x[:, :n]
    # the window peak at step k (x[k - D] .. x[k - 1]) is the max of
    # |xs[k .. k + D - 1]|
    mag = np.abs(xs).max(axis=0)
    win = maximum_filter1d(mag, size=DELAY, origin=-(DELAY // 2),
                           mode="constant")[:steps]
    g = gains(win.astype(np.float32))
    y = xs[:, :steps] * g[None, :]
    return quantize_s16(y[:, DELAY:])


def quantize_s16(y: np.ndarray) -> np.ndarray:
    """[C, S] float -> interleaved s16 [S, C]: scale by 32768, saturate,
    round half to even."""
    v = np.clip(np.asarray(y, np.float32) * f32(32768.0), -32768.0, 32767.0)
    return np.rint(v).astype(np.int16).T.copy()
