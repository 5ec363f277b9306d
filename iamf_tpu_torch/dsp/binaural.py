"""Binaural HRTF convolution (counterpart of iamf_tpu/dsp/binaural.py).

Host part, a JAX-free copy of the original's: the parametric spherical-head
HRIR model (``spherical_head_hrir``, ``hrir_bank``), measured-set loading
(``load_hrir_bank``) and the segment plan of the batched convolution
(``fft_conv_len``, ``batch_seg_plan``).

Device part: the decode pipeline folds an element's virtual-speaker bed
x [C, N] (N = B*T, one batch) to two ears with an output-overlap carry
ov [2, taps-1] (iamf_tpu/core/pipeline.py:267-320):

    y[e, t]   = sum_c sum_k h[e, c, k] * x[c, t - k]  (+ ov[e, t], t < taps-1)
    ov'[e, j] = sum_c sum_{k > j} h[e, c, k] * x[c, N + j - k]

with x zero before 0 and after N. A batch holds S streams that share the
bank (the multi-stream server's bucket, core/serving.py; S = 1 for one
decoder): x [S, C, N], ov [S, 2, taps-1], y [S, 2, N]. ``hrtf_conv`` runs K8
(csrc/hrtf_conv.cu, an overlap-save FFT convolution written by hand, its
tables from ``k8_spectra`` and ``k8_twiddles``) on a CUDA tensor and the
plain twin on a CPU tensor: the JAX package's segmented overlap-add (rfft
at batch_seg_plan's length, a [2, C] complex contraction, irfft, each
segment's tail added into the next one), stream by stream.

The frame-serial decoder's ``HRTFRenderer`` (core/stream.py's M2B and H2B)
is the same call with B = 1: one frame of T samples a call, the segment is
the frame, so the twin is the JAX package's one-block overlap-save
(_fft_conv_block), and on the card K8 runs once a frame, its overlap carry
[1, 2, taps-1] kept on the device.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..constants import CH, LAYOUT_CHANNELS_RENDER, ChannelLayout

from ..device import resolve_device
from ..kernels.build import I, Kernel, P

SPEED_OF_SOUND = 343.0
HEAD_RADIUS = 0.0875  # m

# (azimuth degrees [left positive], elevation degrees) per channel identity;
# BS.2051 nominal positions.
CHANNEL_DIRECTIONS = {
    CH.MONO: (0.0, 0.0),
    CH.L2: (30.0, 0.0),
    CH.R2: (-30.0, 0.0),
    CH.L3: (30.0, 0.0),
    CH.R3: (-30.0, 0.0),
    CH.L7: (30.0, 0.0),
    CH.R7: (-30.0, 0.0),
    CH.C: (0.0, 0.0),
    CH.LFE: (0.0, -15.0),
    CH.SL5: (110.0, 0.0),
    CH.SR5: (-110.0, 0.0),
    CH.SL7: (90.0, 0.0),
    CH.SR7: (-90.0, 0.0),
    CH.BL7: (135.0, 0.0),
    CH.BR7: (-135.0, 0.0),
    CH.TL: (45.0, 35.0),
    CH.TR: (-45.0, 35.0),
    CH.HL: (45.0, 35.0),
    CH.HR: (-45.0, 35.0),
    CH.HFL: (45.0, 35.0),
    CH.HFR: (-45.0, 35.0),
    CH.HBL: (135.0, 35.0),
    CH.HBR: (-135.0, 35.0),
}

K8 = Kernel("iamf_k8_hrtf_conv", [P, I, I, I, P, P, I, I, I, P, P, P])
K8_FFT = 1024   # FFT length of K8's blocks (csrc/hrtf_conv.cu F)
K8_PART = 512   # K8's longest filter part (MAX_PART)


def spherical_head_hrir(
    azimuth_deg: float,
    elevation_deg: float,
    taps: int = 256,
    rate: int = 48000,
) -> np.ndarray:
    """[2, taps] HRIR pair from a parametric spherical-head model.

    Per ear: Woodworth ITD delay (fractional, windowed-sinc), a first-order
    head-shadow lowpass whose cutoff falls with incidence angle, and a mild
    elevation-dependent pinna notch.
    """
    az = math.radians(azimuth_deg)
    el = math.radians(elevation_deg)
    out = np.zeros((2, taps), dtype=np.float64)

    base_delay = 16  # samples of causal headroom
    for ear, sign in ((0, 1.0), (1, -1.0)):  # 0 = left ear
        # incidence angle between source and ear axis
        x = math.sin(az * sign) * math.cos(el)
        inc = math.acos(max(-1.0, min(1.0, x)))  # 0 = toward this ear
        # Woodworth: delay relative to head center
        if inc <= math.pi / 2:
            dt = -HEAD_RADIUS / SPEED_OF_SOUND * math.cos(inc)
        else:
            dt = HEAD_RADIUS / SPEED_OF_SOUND * (inc - math.pi / 2)
        delay = base_delay + dt * rate + HEAD_RADIUS / SPEED_OF_SOUND * rate

        # fractional-delay sinc impulse, windowed around the delay center
        n = np.arange(taps)
        sinc = np.sinc(n - delay)
        half_w = 32.0
        win = np.where(
            np.abs(n - delay) < half_w,
            0.5 * (1.0 + np.cos(np.pi * (n - delay) / half_w)),
            0.0,
        )
        h = sinc * win

        # head shadow: single-pole lowpass, stronger on the far side
        shadow = 0.5 * (1.0 + math.cos(inc))  # 1 near ear, 0 far
        fc = 1500.0 + 18000.0 * shadow  # Hz
        a = math.exp(-2.0 * math.pi * fc / rate)
        g = 1.0 - a
        y = np.zeros(taps)
        state = 0.0
        for i in range(taps):
            state = g * h[i] + a * state
            y[i] = state
        # near-ear gain boost / far-ear attenuation (ILD)
        y *= 0.7 + 0.3 * shadow

        # elevation pinna cue: small delayed negative reflection
        refl_delay = int(round((6.0 - 3.0 * math.sin(el)) * rate / 48000.0))
        refl = np.zeros(taps)
        if refl_delay + 1 < taps:
            refl[refl_delay] = -0.25 * (1.0 - 0.5 * math.sin(el))
        y = y + np.convolve(y, refl)[:taps]

        out[ear] = y
    return out.astype(np.float32)


@functools.lru_cache(maxsize=None)
def hrir_bank(layout: ChannelLayout, taps: int = 256, rate: int = 48000):
    """[2, n_speakers, taps] HRIR bank for a layout's rendering order."""
    chans = LAYOUT_CHANNELS_RENDER[layout]
    bank = np.stack(
        [
            spherical_head_hrir(*CHANNEL_DIRECTIONS[c], taps=taps, rate=rate)
            for c in chans
        ],
        axis=1,
    )
    # LFE: omnidirectional, reduced level
    for i, c in enumerate(chans):
        if c == CH.LFE:
            lfe = np.zeros((2, taps), dtype=np.float32)
            lfe[:, 16] = 0.5
            bank[:, i] = lfe
    return bank


def load_hrir_bank(path: str, layout: ChannelLayout) -> np.ndarray:
    """Load a measured HRIR set for a layout from an .npz file.

    Accepted forms (all [left, right] ear order, 48 kHz):
      - key "bank": [2, n_speakers, taps] already in the layout's rendering
        channel order (LAYOUT_CHANNELS_RENDER), used as-is;
      - per-direction keys "az<azimuth>_el<elevation>": [2, taps] pairs
        (e.g. "az30_el0"), gathered by each channel's BS.2051 nominal
        direction from CHANNEL_DIRECTIONS.
    """
    z = np.load(path)
    chans = LAYOUT_CHANNELS_RENDER[layout]
    if "bank" in z:
        bank = np.asarray(z["bank"], np.float32)
        if bank.ndim != 3 or bank.shape[0] != 2 or bank.shape[1] != len(chans):
            raise ValueError(
                f"bank shape {bank.shape} != [2, {len(chans)}, taps]")
        return bank
    rows = []
    for c in chans:
        az, el = CHANNEL_DIRECTIONS[c]
        key = f"az{int(round(az))}_el{int(round(el))}"
        if key not in z:
            raise ValueError(f"HRIR set missing direction {key} for {c}")
        rows.append(np.asarray(z[key], np.float32))
    taps = max(r.shape[1] for r in rows)
    bank = np.zeros((2, len(chans), taps), np.float32)
    for i, r in enumerate(rows):
        bank[:, i, : r.shape[1]] = r
    return bank


def fft_conv_len(n: int) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) length >= n (the JAX package's FFT
    length, which the plain twin keeps so both transform alike)."""
    best = 1
    while best < n:
        best *= 2
    m = best  # power of two always works; search smaller smooth sizes
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            k = p35
            while k < max(n, 1):
                k *= 2
            if k >= n and k < m:
                m = k
            p35 *= 3
        p5 *= 5
    return m


def batch_seg_plan(B: int, T: int, taps: int) -> tuple[int, int, int]:
    """Segmented overlap-add plan for the batched HRTF conv:
    (seg, n_fft, n_segs) for a [*, B*T] timeline. seg is the largest
    multiple of T with at most 8 frames that divides B*T; each segment's
    tail (taps-1 samples) adds into the next, the last one is the carry."""
    for g in (8, 4, 2, 1):
        if B % g == 0:
            seg = g * T
            return seg, fft_conv_len(seg + taps - 1), B // g


def k8_partition(taps: int) -> tuple[int, int]:
    """(parts, lp) of K8's plan: the filter cut into `parts` parts of lp <=
    K8_PART taps (zero-padded), so that a block of K8_FFT points yields
    K8_FFT - lp + 1 outputs whatever the filter's length."""
    parts = -(-taps // K8_PART)
    return parts, -(-taps // parts)


@functools.lru_cache(maxsize=None)
def k8_twiddles() -> np.ndarray:
    """K8's twiddles, float32 [K8_FFT + 16, 2] (re, im): W^(n1 k2) at
    32 k2 + n1 (n1, k2 < 32; W = exp(-2 pi i / K8_FFT)), then
    exp(-2 pi i k / 32) for k < 16; computed in float64, then rounded."""
    n = np.arange(32)
    e = np.concatenate([np.outer(n, n).ravel() / K8_FFT, n[:16] / 32])
    w = np.exp(-2j * np.pi * e)
    return np.stack([w.real, w.imag], -1).astype(np.float32)


def k8_spectra(bank: np.ndarray) -> np.ndarray:
    """K8's filter table for a [2, C, taps] bank: float32 [parts,
    ceil(C/2), K8_FFT, 4], per part p and channel pair (a, b) = (2q,
    2q + 1) the bins of P = (G_a - i G_b) / 2F and Q = (G_a + i G_b) / 2F
    as (P.re, P.im, Q.re, Q.im), where G_c is the F-point DFT of part p of
    h_L,c + i h_R,c (zero-padded; G_b = 0 past the last channel).
    Computed in float64, then rounded."""
    _, C, taps = bank.shape
    parts, lp = k8_partition(taps)
    F = K8_FFT
    h = np.zeros((2, C + C % 2, parts * lp))
    h[:, :C, :taps] = bank
    g = np.fft.fft((h[0] + 1j * h[1]).reshape(-1, parts, lp), n=F, axis=2)
    g = g.reshape(-1, 2, parts, F).transpose(2, 0, 1, 3)  # [p, q, a|b, F]
    ga, gb = g[:, :, 0], g[:, :, 1]
    pm, qm = (ga - 1j * gb) / (2 * F), (ga + 1j * gb) / (2 * F)
    return np.stack([pm.real, pm.imag, qm.real, qm.imag], -1).astype(
        np.float32)


@dataclasses.dataclass(frozen=True)
class Hrir:
    """One element's HRIRs on a device: the time-domain bank [2, C, taps],
    K8's tables (``k8_spectra``, ``k8_twiddles``), and the bank's rfft at
    batch_seg_plan's length for the plain twin."""

    bank: torch.Tensor  # float32 [2, C, taps]
    spec: torch.Tensor  # complex64 [2, C, n_fft // 2 + 1]
    seg: int
    n_fft: int
    pq: torch.Tensor  # float32 [parts, ceil(C/2), K8_FFT, 4]
    tw: torch.Tensor  # float32 [K8_FFT + 16, 2]

    @property
    def taps(self) -> int:
        return self.bank.shape[2]


def hrir_for_batch(bank: np.ndarray, B: int, T: int, device,
                   spec: np.ndarray | None = None) -> Hrir:
    """Hrir of a [2, C, taps] bank for batches of B frames of T samples;
    `spec`, when given, is the twin's spectrum as it is (the JAX
    package's, through convert.stream_params)."""
    taps = bank.shape[2]
    seg, n, _ = batch_seg_plan(B, T, taps)
    if spec is None:
        spec = np.fft.rfft(bank, n=n, axis=2)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return Hrir(bank=put(bank, np.float32), spec=put(spec, np.complex64),
                seg=seg, n_fft=n, pq=put(k8_spectra(bank), np.float32),
                tw=put(k8_twiddles(), np.float32))


def hrtf_conv_plain(hrir: Hrir, x, overlap):
    """Plain twin: the JAX package's segmented overlap-add over x [S, C, N]
    (N a multiple of hrir.seg), stream by stream. Returns (y [S, 2, N],
    overlap' [S, 2, taps-1])."""
    K8.note_plain(x)
    outs = [_conv_stream(hrir, x[s], overlap[s]) for s in range(x.shape[0])]
    return (torch.stack([y for y, _ in outs]),
            torch.stack([o for _, o in outs]))


def _conv_stream(hrir: Hrir, x, overlap):
    """hrtf_conv_plain on one stream: x [C, N], overlap [2, taps-1]."""
    C, N = x.shape
    seg, n, taps = hrir.seg, hrir.n_fft, hrir.taps
    S = N // seg
    xs = x.reshape(C, S, seg).transpose(0, 1)  # [S, C, seg]
    X = torch.fft.rfft(xs, n=n, dim=2)  # [S, C, F]
    Y = torch.einsum("ecf,scf->sef", hrir.spec, X)
    y = torch.fft.irfft(Y, n=n, dim=2)  # [S, 2, n]
    main = y[:, :, :seg].clone()
    tails = y[:, :, seg:seg + taps - 1]  # [S, 2, taps-1]
    prev = torch.cat([overlap[None], tails[:-1]], dim=0)
    main[:, :, :taps - 1] += prev
    return main.transpose(0, 1).reshape(2, N), tails[-1].contiguous()


def hrtf_conv_cuda(hrir: Hrir, x, overlap):
    """K8 on the card: x [S, C, N] float32 -> (y [S, 2, N], overlap'), the S
    streams in one launch."""
    bank = hrir.bank
    S, C, N = x.shape
    taps = bank.shape[2]
    if (x.dtype != torch.float32 or bank.dtype != torch.float32
            or tuple(bank.shape[:2]) != (2, C) or taps < 2
            or tuple(overlap.shape) != (S, 2, taps - 1)):
        raise ValueError(
            f"K8 takes float32 x [S, C, N], bank [2, C, taps >= 2] and "
            f"overlap [S, 2, taps-1]; got x {x.dtype} {list(x.shape)}, bank "
            f"{bank.dtype} {list(bank.shape)}, overlap {list(overlap.shape)}")
    parts, lp = k8_partition(taps)
    x = x.contiguous()
    overlap = overlap.contiguous().to(torch.float32)
    y = torch.empty((S, 2, N), dtype=torch.float32, device=x.device)
    ov = torch.empty((S, 2, taps - 1), dtype=torch.float32, device=x.device)
    K8(x, S, C, N, hrir.pq, hrir.tw, taps, parts, lp, overlap, y, ov)
    return y, ov


def hrtf_conv(hrir: Hrir, x, overlap):
    """Fold the beds x [S, C, N] to two ears with the overlap carry: K8
    for a CUDA tensor, the plain twin for a CPU tensor."""
    if x.is_cuda:
        return hrtf_conv_cuda(hrir, x, overlap)
    return hrtf_conv_plain(hrir, x, overlap)


class HRTFRenderer:
    """Streaming binaural renderer for one element (M2B/H2B equivalent;
    counterpart of iamf_tpu/dsp/binaural.py's): frames of `frame_size`
    samples through hrtf_conv, K8 on a CUDA device and the twin on the
    CPU, with the overlap carry on the device."""

    def __init__(self, layout: ChannelLayout, frame_size: int,
                 taps: int = 256, rate: int = 48000,
                 bank: np.ndarray | None = None, device="cuda"):
        self.layout = layout
        self.frame_size = frame_size
        self.device = resolve_device(device)
        if bank is None:
            bank = hrir_bank(layout, taps, rate)  # [2, C, taps]
        else:
            bank = np.asarray(bank, np.float32)  # measured set
        self.taps = bank.shape[2]
        self.hrir = hrir_for_batch(bank, 1, frame_size, self.device)
        self.reset()

    def render(self, x):
        """x: [C, T] speaker feeds (rendering order), T = frame_size, on the
        device -> [2, T] binaural on it."""
        y, self.overlap = hrtf_conv(self.hrir, x[None], self.overlap)
        return y[0]

    def reset(self) -> None:
        self.overlap = torch.zeros((1, 2, self.taps - 1), dtype=torch.float32,
                                   device=self.device)
