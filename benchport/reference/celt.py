"""Plain CELT synthesis: the time-domain half of an Opus CELT decoder
(RFC 6716 §4.3.5-§4.3.7; libopus celt_decoder.c celt_synthesis,
comb_filter, deemphasis) for 20 ms frames of 960 samples, in float64.

Input: one stream's entropy output per frame and channel lane, as the
Opus entropy decoder exports it (denormalised MDCT spectra at the s16
scale, the transient flag, and the post-filter's periods and per-tap gains
at the frame's start, as decoded last frame and as decoded this frame).
Output: the decoder's s16 samples / 32768, [lanes, frames * 960].

The steps, each as the specification states it:
- the IMDCT of each frame (one 1920-point transform, or eight 240-point
  ones interleaved when the frame is transient) and the TDAC overlap-add
  of CELT's low-overlap window (120 samples);
- the pitch post-filter, in place, cross-fading from the old to the new
  filter over the first 120 samples of each of its two passes;
- the de-emphasis y[n] = x[n] + 0.85 y[n - 1];
- rounding to s16 with saturation.

``tf32=True`` rounds both operands of the IMDCT's product to TF32 (a
10-bit mantissa) before multiplying: the correctness check's control.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from scipy.signal import lfilter

N = 960          # samples a frame
OVERLAP = 120    # CELT's window overlap
SHORT = 120      # a short block's coefficients
BLOCKS = N // SHORT
HIST = 1032      # the post-filter's look-back (max period 1024 + 2)
MINPERIOD = 15   # the post-filter's least period
DEEMPH = float(np.float32(0.85))


@functools.lru_cache(maxsize=None)
def window() -> np.ndarray:
    """CELT's overlap window: sin(pi/2 sin^2(pi (i + 1/2) / 240))."""
    i = np.arange(OVERLAP, dtype=np.float64)
    s = np.sin(0.5 * np.pi * (i + 0.5) / OVERLAP)
    return np.sin(0.5 * np.pi * s * s)


@functools.lru_cache(maxsize=None)
def basis(n: int) -> np.ndarray:
    """[n, n] raw IMDCT: t[m] = sum_k X[k] cos(2 pi / 2n (m + n + 1/2)
    (k + 1/2)), m < n (the folded half; TDAC restores the rest)."""
    m = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(np.pi / n * (m + n + 0.5) * (k + 0.5))


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float64 values to TF32 (8-bit exponent, 10-bit mantissa),
    to nearest, ties away from zero as the tensor cores' conversion."""
    f = x.to(torch.float32).contiguous()
    bits = f.view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(torch.float64)


def _product(x: torch.Tensor, b: np.ndarray, tf32: bool) -> torch.Tensor:
    bt = torch.from_numpy(b.T.copy()).to(x.device)
    if tf32:
        return to_tf32(x) @ to_tf32(bt)
    return x @ bt


def imdct_tdac(freq: torch.Tensor, transient: torch.Tensor,
               tf32: bool = False) -> torch.Tensor:
    """freq [F, L, 960] float64 (frames in order), transient [F, L] bool ->
    [F, L, 960] overlap-added IMDCT output, the first frame's overlap
    entering from silence."""
    F, L, n = freq.shape
    w = torch.from_numpy(window()).to(freq.device)
    i = torch.arange(OVERLAP // 2, device=freq.device)
    wl, wr = w[OVERLAP - 1 - i], w[i]
    x = freq.reshape(F * L, n)
    t_long = _product(x, basis(n), tf32).reshape(F, L, n)
    # short blocks: block j holds coefficients j, j + 8, ...
    xs = x.reshape(F * L, SHORT, BLOCKS).transpose(1, 2)
    t_short = _product(xs.reshape(-1, SHORT), basis(SHORT), tf32).reshape(
        F, L, BLOCKS, SHORT)
    trans = transient[..., None]
    h = OVERLAP // 2
    # each frame's raw tail (the last 60 folded samples) feeds the next
    tail = torch.where(trans, t_short[:, :, -1, h:], t_long[..., n - h:])
    tail_in = torch.cat([torch.zeros_like(tail[:1]), tail[:-1]])
    y_long = torch.empty_like(t_long)
    y_long[..., :h] = wl * tail_in - wr * t_long[..., h - 1 - i]
    y_long[..., h:OVERLAP] = (wl.flip(0) * t_long[..., i]
                              + wr.flip(0) * tail_in[..., h - 1 - i])
    y_long[..., OVERLAP:] = t_long[..., h:n - h]
    y_short = torch.empty_like(t_short)
    prev = torch.cat([tail_in[:, :, None], t_short[:, :, :-1, h:]], dim=2)
    y_short[..., :h] = wl * prev - wr * t_short[..., h - 1 - i]
    y_short[..., h:] = (wl.flip(0) * t_short[..., i]
                        + wr.flip(0) * prev[..., h - 1 - i])
    return torch.where(trans, y_short.reshape(F, L, n), y_long)


def _taps(buf, rows, pos, t, g):
    """G(g, t) at positions pos of rows: g0 y[i-t] + g1 (y[i-t+1] +
    y[i-t-1]) + g2 (y[i-t+2] + y[i-t-2])."""
    c = pos - t[:, None]
    return (g[:, 0:1] * buf[rows, c]
            + g[:, 1:2] * (buf[rows, c + 1] + buf[rows, c - 1])
            + g[:, 2:3] * (buf[rows, c + 2] + buf[rows, c - 2]))


def _fade(buf, lanes, lo, t0, t1, g0, g1, fade):
    """The cross-fading post-filter over buf[lanes, lo:lo + 120] in place:
    y[i] = x[i] + (1 - f_i) G(g0, t0) + f_i G(g1, t1), f the squared
    window; runs of (least period - 2) samples read only finished
    output."""
    step = max(1, int(min(t0.min(), t1.min())) - 2)
    rows = lanes[:, None]
    for p in range(0, OVERLAP, step):
        q = min(p + step, OVERLAP)
        pos = lo + np.arange(p, q)[None, :]
        f = fade[None, p:q]
        buf[rows, pos] = (buf[rows, pos] + (1.0 - f) * _taps(buf, rows, pos,
                                                              t0, g0)
                          + f * _taps(buf, rows, pos, t1, g1))


def _const(row, lo, hi, T, g):
    """The post-filter with one period T and gain triple g over row[lo:hi]
    in place: y[i] = x[i] + G(g, T)."""
    g0, g1, g2 = g
    if T > 64:
        # runs of T - 2 samples, each reading finished output only
        for p in range(lo, hi, T - 2):
            q = min(p + T - 2, hi)
            r = p - T
            row[p:q] += (g0 * row[r:r + q - p]
                         + g1 * (row[r + 1:r + 1 + q - p] + row[r - 1:r - 1 + q - p])
                         + g2 * (row[r + 2:r + 2 + q - p] + row[r - 2:r - 2 + q - p]))
        return
    # the IIR filter y[i] - sum a y[i - j] = x[i] (order T + 2), entered
    # with its state from the last T + 2 outputs (scipy's lfiltic for the
    # five taps: zi[m] = -sum_{i > m} a[i] y[m - i])
    a = np.zeros(T + 3)
    a[0] = 1.0
    a[T - 2:T + 3] = (-g2, -g1, -g0, -g1, -g2)
    past = row[lo - T - 2:lo][::-1]
    zi = np.zeros(T + 2)
    for i in range(T - 2, T + 3):
        zi[:i] -= a[i] * past[:i][::-1]
    row[lo:hi] = lfilter([1.0], a, row[lo:hi], zi=zi)[0]


def postfilter(y: np.ndarray, ent: dict) -> np.ndarray:
    """y [F, L, 960] float64 -> the post-filtered signal [L, F * 960]:
    per frame, [0, 120) fades from (t_old, g_old) to (t_cur, g_cur), then
    [120, 960) from (t_cur, g_cur) to (t_new, g_new) over its first 120
    samples (no fade where the two filters are equal, as comb_filter
    skips it); the history before the stream is silence."""
    F, L, n = y.shape
    buf = np.zeros((L, HIST + F * n))
    buf[:, HIST:] = y.transpose(1, 0, 2).reshape(L, F * n)
    fade = window() ** 2
    t = [np.asarray(ent[k], np.int64) for k in ("t_old", "t_cur", "t_new")]
    g = [np.asarray(ent[k], np.float64) for k in ("g_old", "g_cur", "g_new")]
    on = [np.any(x != 0, axis=2) for x in g]
    same = [(t[i] == t[i + 1]) & np.all(g[i] == g[i + 1], axis=2)
            for i in (0, 1)]
    for f in range(F):
        base = HIST + f * n
        # in time order: the first pass ([0, 120): a fade where old and
        # current differ, else a constant filter), then the second pass's
        # fades ([120, 240)), then its constant filter to the frame's end
        for i, lo in ((0, base), (1, base + SHORT)):
            fl = np.flatnonzero(~same[i][f] & (on[i][f] | on[i + 1][f]))
            if len(fl):
                _fade(buf, fl, lo, t[i][f, fl], t[i + 1][f, fl],
                      g[i][f, fl], g[i + 1][f, fl], fade)
            if i == 0:
                for lane in np.flatnonzero(same[0][f] & on[1][f]):
                    _const(buf[lane], base, base + SHORT, int(t[1][f, lane]),
                           g[1][f, lane])
        for lane in np.flatnonzero(on[2][f]):
            lo = base + SHORT + (0 if same[1][f, lane] else OVERLAP)
            _const(buf[lane], lo, base + n, int(t[2][f, lane]), g[2][f, lane])
    return buf[:, HIST:]


def deemphasis_s16(z: np.ndarray) -> np.ndarray:
    """[L, S] -> the decoder's s16 output / 32768, [L, S]."""
    out = lfilter([1.0], [1.0, -DEEMPH], z + 1e-30, axis=1)
    return np.rint(np.clip(out, -32768.0, 32767.0)) / 32768.0


def synthesize(ent: dict, device="cpu", tf32: bool = False) -> np.ndarray:
    """One stream's entropy output (arrays [F, L, ...]: freq, transient,
    t_old, t_cur, t_new, g_old, g_cur, g_new) -> s16 / 32768 [L, F * 960]."""
    freq = torch.as_tensor(np.asarray(ent["freq"]), dtype=torch.float64,
                           device=device)
    trans = torch.as_tensor(np.asarray(ent["transient"]), dtype=torch.bool,
                            device=device)
    y = imdct_tdac(freq, trans, tf32).cpu().numpy()
    return deemphasis_s16(postfilter(y, ent))
