"""A numpy model of K7 (iamf_tpu_torch/csrc/aac_synth.cu) in the kernel's
plan. A warp takes one lane's run of consecutive frames b0 .. b0 + run - 1
and first recomputes frame b0 - 1 (the carry stands in for it at b0 = 0).
Each frame's IMDCT is an inverse complex FFT with the twiddles of
``synth.k7_twiddles``: a long frame one 512-point FFT, a short frame eight
64-point FFTs, both in radix-8 Stockham passes (three and two) with the
kernel's index maps. Each output bin c gives two IMDCT samples, and each
of those two window products (``halves``): a lane of the warp owns the
same 32 positions n in both halves of every frame, so it adds frame b's
first half to frame b-1's second half, which it wrote itself. A short
frame's windows go through shared memory (its lefts and rights, then
the overlap inside the frame, window j-1's right plus window j's left).

The FFTs run in float64 on the stored float32 twiddles (the kernel's fp32
butterflies differ by ~1e-5 at s16 scale); windows, overlaps and the
rounding in float32 as the kernel rounds them.

tests/test_torch_aac.py holds it to the float64 IMDCT and the plain twin on
the CPU, and tests/test_torch_cuda.py holds K7 to it on the card.
"""

import numpy as np

from iamf_tpu_torch.codecs.aac import synth

FRAME = synth.FRAME
f32 = np.float32


def _tw(lo, n):
    t = synth.k7_twiddles()[lo:lo + n].astype(np.float64)
    return t[:, 0] + 1j * t[:, 1]


def dft8(a):
    """Radix-8 butterfly, exponent +2 pi i: a [..., 8] -> [..., 8]."""
    r = np.arange(8)
    return a @ np.exp(2j * np.pi * np.outer(r, r) / 8)


def stockham(x, n):
    """Inverse FFTs of the len(x) / n groups of n points (n = 512 or 64)
    in the kernel's radix-8 passes: butterfly j of a group reads
    x[j + (n/8) r], multiplies by W_(8 Ns)^(r k), k = j mod Ns, and writes
    (j / Ns) 8 Ns + k + Ns r."""
    x = x.reshape(-1, n)
    j = np.arange(n // 8)
    r = np.arange(8)
    Ns = 1
    while Ns < n:
        k = j % Ns
        a = x[:, j[:, None] + (n // 8) * r[None, :]]
        if Ns > 1:
            lo = synth.TW_64 if Ns == 8 else synth.TW_512
            a = a * _tw(lo, 8 * Ns)[(8 * k[:, None] + r[None, :])]
        out = np.empty_like(x)
        out[:, ((j // Ns) * 8 * Ns + k)[:, None] + Ns * r[None, :]] = dft8(a)
        x, Ns = out, 8 * Ns
    return x.ravel()


def imdct_bins(X, n_out):
    """(u, v) for each bin c of the N/4-point FFT of one IMDCT (N =
    n_out): u = t[N/4 + 2c], v = t[3N/4 - 1 - 2c] of the N-point IMDCT of
    the N/2 lines X (float32 in, float64 out)."""
    M, Q = n_out // 2, n_out // 4
    pre, post = ((synth.TW_PRE_L, synth.TW_POST_L) if n_out == 2048 else
                 (synth.TW_PRE_S, synth.TW_POST_S))
    k = np.arange(Q)
    X = X.astype(np.float64)
    v = (X[..., M - 1 - 2 * k] + 1j * X[..., 2 * k]) * _tw(pre, Q)
    W = stockham(v.ravel(), Q).reshape(v.shape) * _tw(post, Q)
    return W.real, -W.imag


def owned(n_out):
    """For each bin c of an n_out-point IMDCT: whether c < N/8, and the
    two positions p0, p1 (of N/2) that its two samples reach, the same in
    the first half and in the second (halves)."""
    M, Q = n_out // 2, n_out // 4
    c = np.arange(Q)
    lo = c < Q // 2
    return (lo, np.where(lo, Q + 2 * c, 2 * c - Q),
            np.where(lo, Q - 1 - 2 * c, M + Q - 1 - 2 * c))


def halves(X, n_out):
    """The unwindowed first and second halves (each n_out / 2) of the
    n_out-point IMDCT of X, put together from the bins as the kernel
    does."""
    M = n_out // 2
    u, v = imdct_bins(X, n_out)
    lo, p0, p1 = owned(n_out)
    first = np.empty(X.shape[:-1] + (M,))
    second = np.empty_like(first)
    # c < N/8: u = t[Q + 2c] is the first half's at p0 (and -u at p1 by
    # t[M/2 - 1 - n] = -t[n]), v the second half's at p1 and p0 (by
    # t[5M/2 - 1 - n] = t[n]); c >= N/8: u the second half's, v the first
    # half's at p1 (+) and p0 (-)
    fa = np.where(lo, u, v)
    sa = np.where(lo, v, u)
    first[..., np.where(lo, p0, p1)] = fa
    first[..., np.where(lo, p1, p0)] = -fa
    second[..., p0] = sa
    second[..., p1] = sa
    return first, second


def frame_halves(spec_row, meta_row):
    """One frame's windowed (first, second) halves, float32 [1024] each."""
    tab = synth.tables()
    seq, shape, prev = (int(v) for v in meta_row)
    if seq != synth.EIGHT_SHORT:
        t0, t1 = halves(spec_row, 2048)
        return (t0.astype(f32) * tab["wl"][seq, prev],
                t1.astype(f32) * tab["wr"][seq, shape])
    t0, t1 = halves(spec_row.reshape(8, 128), 256)  # [8, 128] each
    sl, sl0 = tab["short_half"][shape], tab["short_half"][prev]
    left = t0.astype(f32) * np.stack([sl0] + [sl] * 7)   # lefts L[j]
    right = t1.astype(f32) * sl[::-1]                    # rights R[j]
    frame = np.zeros(2 * FRAME, f32)
    for p in range(448, 1600):
        q = p - 448
        j, o = q >> 7, q & 127
        if j == 0:
            frame[p] = left[0, o]
        elif j == 8:
            frame[p] = right[7, o]
        else:
            frame[p] = right[j - 1, o] + left[j, o]
    return frame[:FRAME], frame[FRAME:]


def windowed_frames(spec, meta):
    """spec [R, 1024] float32, meta [R, 3] -> frames [R, 2048] float32."""
    return np.stack([np.concatenate(frame_halves(s, m))
                     for s, m in zip(spec, meta)])


def synthesize(spec, meta, carry, run=1):
    """spec [B, L, 1024], meta [B, L, 3], carry [L, 1024] -> (pcm / 32768
    [B, L, 1024], carry'), a warp per (lane, run of `run` frames) as K7
    cuts the batch: each run recomputes the frame before it."""
    B, L, _ = spec.shape
    pcm = np.empty((B, L, FRAME), f32)
    carry_out = np.empty((L, FRAME), f32)
    for l in range(L):
        for b0 in range(0, B, run):
            s_prev = (carry[l].astype(f32) if b0 == 0 else
                      frame_halves(spec[b0 - 1, l], meta[b0 - 1, l])[1])
            for b in range(b0, min(b0 + run, B)):
                f, s = frame_halves(spec[b, l], meta[b, l])
                v = f + s_prev
                pcm[b, l] = np.rint(np.clip(v, -32768.0, 32767.0)) * f32(
                    1 / 32768)
                s_prev = s
            if b0 + run >= B:
                carry_out[l] = s_prev
    return pcm, carry_out
