"""numpy model of K8 (iamf_tpu_torch/csrc/hrtf_conv.cu): its plan, in
float32, with the kernel's tables.

The same block geometry (F = 1024 points, the filter in `parts` parts of
lp taps, V = F - lp + 1 outputs a block, part p's window starting at
t0 - (lp - 1) - p * lp), the same channel pairing (z = x_a + i x_b, the
pair's bins P Z[k] + Q conj Z[F - k] from binaural.k8_spectra), the
packed-ear inverse (conj FFT(conj Y): left ear real, right ear imaginary)
and the same FFT: four-step 32 x 32 with radix-2 32-point transforms over
the float32 twiddle table binaural.k8_twiddles. It follows the kernel's
arithmetic in structure, not bit for bit (numpy's complex64 products
round otherwise than the kernel's fmaf, and sums the pairs in another
order); tests/test_torch_binaural.py holds it to float64 and to the twin.
"""

import numpy as np

from iamf_tpu_torch.dsp import binaural

F = binaural.K8_FFT
BREV = np.array([int(f"{i:05b}"[::-1], 2) for i in range(32)])


def _tables():
    tw = binaural.k8_twiddles()
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    return tw[:F].reshape(32, 32), tw[F:]  # [k2, n1] = W^(n1 k2); W_32^k


def fft32(a, w32):
    """32-point DFT over the last axis: radix-2 decimation in time on the
    bit-reversed copy, as csrc/hrtf_conv.cu fft32."""
    b = a[..., BREV]
    lead = b.shape[:-1]
    for s in range(1, 6):
        half = 1 << (s - 1)
        g = b.reshape(lead + (32 // (2 * half), 2, half))
        t = g[..., 1, :] * w32[np.arange(half) << (5 - s)]
        t[..., 0] = g[..., 1, 0]  # the kernel skips its j = 0 product
        b = np.stack([g[..., 0, :] + t, g[..., 0, :] - t], -2).reshape(
            lead + (32,))
    return b


def fft1024(x):
    """F-point DFT over the last axis, four-step as the kernel's one warp:
    32-point transforms over n2 (x[n1 + 32 n2]), the twiddle W^(n1 k2), 32-
    point transforms over n1; X[k2 + 32 k1]."""
    tab, w32 = _tables()
    lead = x.shape[:-1]
    a = x.reshape(lead + (32, 32))                  # [n2, n1]
    a = fft32(np.swapaxes(a, -1, -2), w32)          # [n1, k2]
    a = a * tab.T                                   # W^(n1 k2)
    a = fft32(np.swapaxes(a, -1, -2), w32)          # [k2, k1]
    return np.swapaxes(a, -1, -2).reshape(lead + (F,))  # k1 * 32 + k2


def k8(bank, x, ov):
    """K8's plan on x [C, N] float32 with the carry ov [2, taps-1]:
    (y [2, N], ov' [2, taps-1]) in float32."""
    _, C, taps = bank.shape
    N = x.shape[1]
    parts, lp = binaural.k8_partition(taps)
    V = F - lp + 1
    nb = -(-(N + taps - 1) // V)
    pq = binaural.k8_spectra(bank)                   # [parts, pairs, F, 4]
    P = (pq[..., 0] + 1j * pq[..., 1]).astype(np.complex64)
    Q = (pq[..., 2] + 1j * pq[..., 3]).astype(np.complex64)
    xe = np.zeros((C + C % 2, N), np.float32)
    xe[:C] = x
    # windows [nb, parts, pairs, F]: g = t0 - (lp - 1) - p * lp + j
    g = (np.arange(nb)[:, None, None] * V - (lp - 1)
         - np.arange(parts)[None, :, None] * lp + np.arange(F))
    inside = (g >= 0) & (g < N)
    xs = np.where(inside[:, :, None],
                  xe[:, np.clip(g, 0, N - 1)].transpose(1, 2, 0, 3),
                  np.float32(0))  # [nb, parts, C', F]
    z = (xs[:, :, 0::2] + 1j * xs[:, :, 1::2]).astype(np.complex64)
    Z = fft1024(z)
    Zc = np.conj(Z[..., (-np.arange(F)) % F])
    Y = (P * Z + Q * Zc).astype(np.complex64).sum(axis=(1, 2),
                                                   dtype=np.complex64)
    U = fft1024(np.conj(Y))                          # [nb, F]
    out = np.stack([U.real, -U.imag], 0)[:, :, lp - 1:].reshape(2, -1)
    full = out[:, :N + taps - 1].astype(np.float32)
    full[:, :taps - 1] += ov
    return full[:, :N].copy(), full[:, N:].copy()
