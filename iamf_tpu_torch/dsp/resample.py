"""Polyphase sinc resampler to the 48 kHz output rate (counterpart of
iamf_tpu/dsp/resample.py; reference: speexdsp resample.c at quality 4, as
IAMF_decoder.c:57, :3193-3248 use it).

Host part, a JAX-free copy of the original's speexdsp-parity
``Resampler``: the filter design (update_filter, resample.c:530-610:
Kaiser-windowed sinc, direct per-phase bank or oversampled table + cubic
interpolation) and the streaming ``process``/``drain`` state machine
(speex_resampler_process_float :920-970: filt_len-1 samples of history a
channel, last_sample/samp_frac_num stepping, the [-1, 1] clamp), which the
frame-serial decoder (api.py) runs on the host in numpy with float64
accumulators, as the reference's serial decoder does. The batched decode
indexes every output directly instead (below).

Device part: ``ResamplePlan`` is DeviceResampler's host precompute. The
output grid is affine in the output index: a chunk of in_chunk = num*Q
inputs yields out_chunk = den*Q outputs, output o of a chunk reads the
window starting at win_start[o] with the filter row W[o] ([out_chunk, N]).
The JAX package runs it as a scan over chunks whose carry is only the
overlap-save input window, so output j = (s - 1)*out_chunk + o (s =
j // out_chunk + 1) is

    y[c, j] = clip(sum_f xz[c, s*in_chunk - carry_len + win_start[o] + f]
                   * W[o, f], -1, 1)

with xz the input with zeros outside [0, T_in). The row W[o] depends only
on the phase (num*o) % den, so the plan keeps the per-phase bank [den, N]
(``ResamplePlan.bank``), and the output is periodic: with
D = in_chunk - carry_len,

    y[c, j] = clip(sum_f xz[c, floor(num*j / den) + D + f]
                   * bank[(num*j) % den, f], -1, 1)

``resample_stream`` runs K10 (csrc/resample.cu, one launch over the whole
stream) on a CUDA tensor: tiles of K10_R consecutive outputs share one
input window, their rows shifted into it and zero-padded (``k10_tiles``).
On a CPU tensor the plain twin mirrors _resample_scan chunk by chunk
(gather the windows, contract, clip).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..kernels.build import I, Kernel, P

K10 = Kernel("iamf_k10_resample", [P, I, I, P, P, I, I, I, I, I, P, I])
K10_R = 4  # consecutive outputs in a tile of K10 (csrc/resample.cu R)

QUALITY = 4  # the reference's speexdsp quality (IAMF_decoder.c:57)
TARGET_CHUNK = 8192  # inputs per chunk, rounded down to a multiple of num


def _kaiser_table(beta: float, n_entries: int, ovs: int) -> np.ndarray:
    t = np.zeros(n_entries, np.float64)
    for idx in range(n_entries):
        x = (idx - 1) / ovs
        if abs(x) <= 1.0:
            t[idx] = round(
                float(np.i0(beta * math.sqrt(max(0.0, 1 - x * x))) / np.i0(beta)),
                8,
            )
    return t


def _tables():
    k12 = _kaiser_table(12.0, 68, 64)
    k10 = _kaiser_table(10.0, 36, 32)
    k8 = _kaiser_table(8.0, 36, 32)
    k6 = _kaiser_table(6.0, 36, 32)
    # speexdsp hand-smooths the window tails (published speexdsp constants;
    # the analytic window is exactly 0 past x=1)
    k12[65] = 0.0000527734
    k12[66] = 0.00001
    k8[34] = 0.0005
    k6[34] = 0.00752
    return {"k12": (k12, 64), "k10": (k10, 32), "k8": (k8, 32),
            "k6": (k6, 32)}


_WINDOWS = None

# quality -> (base_length, oversample, downsample_bw, upsample_bw, window)
_QUALITY_MAP = {
    0: (8, 4, 0.830, 0.860, "k6"),
    1: (16, 4, 0.850, 0.880, "k6"),
    2: (32, 4, 0.882, 0.910, "k6"),
    3: (48, 8, 0.895, 0.917, "k8"),
    4: (64, 8, 0.921, 0.940, "k8"),
    5: (80, 16, 0.922, 0.940, "k10"),
    6: (96, 16, 0.940, 0.945, "k10"),
    7: (128, 16, 0.950, 0.950, "k10"),
    8: (160, 16, 0.960, 0.960, "k10"),
    9: (192, 32, 0.968, 0.968, "k12"),
    10: (256, 32, 0.975, 0.975, "k12"),
}


def _compute_func(x: float, table: np.ndarray, ovs: int) -> float:
    """Cubic interpolation over the window table (double precision)."""
    y = np.float32(x) * np.float32(ovs)
    ind = int(math.floor(y))
    frac = float(np.float32(y - ind))
    i3 = -0.1666666667 * frac + 0.1666666667 * frac ** 3
    i2 = frac + 0.5 * frac * frac - 0.5 * frac ** 3
    i0c = -0.3333333333 * frac + 0.5 * frac * frac - 0.1666666667 * frac ** 3
    i1 = 1.0 - i3 - i2 - i0c
    return (i0c * table[ind] + i1 * table[ind + 1] + i2 * table[ind + 2]
            + i3 * table[ind + 3])


def _sinc(cutoff: float, x: float, N: int, table, ovs) -> np.float32:
    xx = np.float32(x) * np.float32(cutoff)
    if abs(x) < 1e-6:
        return np.float32(cutoff)
    if abs(x) > 0.5 * N:
        return np.float32(0.0)
    return np.float32(
        cutoff * math.sin(math.pi * float(xx)) / (math.pi * float(xx))
        * _compute_func(abs(2.0 * np.float32(x) / N), table, ovs)
    )


def _cubic_coef(frac: np.ndarray):
    """resample.c cubic_coef (float32)."""
    f = frac.astype(np.float32)
    i0c = np.float32(-0.16667) * f + np.float32(0.16667) * f * f * f
    i1 = f + np.float32(0.5) * f * f - np.float32(0.5) * f * f * f
    i3 = (np.float32(-0.33333) * f + np.float32(0.5) * f * f
          - np.float32(0.16667) * f * f * f)
    i2 = (np.float64(1.0) - i0c - i1 - i3).astype(np.float32)
    return i0c, i1, i2, i3


class Resampler:
    """Streaming rational resampler, speexdsp-parity at a given quality
    (host numpy, a copy of the JAX package's)."""

    def __init__(self, channels: int, in_rate: int, out_rate: int,
                 quality: int = 4):
        global _WINDOWS
        if _WINDOWS is None:
            _WINDOWS = _tables()
        self.channels = channels
        self.in_rate = in_rate
        self.out_rate = out_rate
        g = math.gcd(in_rate, out_rate)
        self.num = in_rate // g
        self.den = out_rate // g
        base_len, ovs, down_bw, up_bw, wname = _QUALITY_MAP[quality]
        table, wovs = _WINDOWS[wname]
        self.oversample = ovs
        if self.num > self.den:  # downsampling
            self.cutoff = float(
                np.float32(np.float32(down_bw) * self.den) / np.float32(self.num))
            fl = (base_len % self.den) * self.num // self.den + (
                base_len // self.den) * self.num
            self.filt_len = ((fl - 1) & ~0x7) + 8
            for k in (2, 4, 8, 16):
                if k * self.den < self.num:
                    self.oversample >>= 1
            self.oversample = max(self.oversample, 1)
        else:
            self.cutoff = up_bw
            self.filt_len = base_len
        N = self.filt_len
        self.direct = N * self.den <= N * self.oversample + 8
        if self.direct:
            bank = np.zeros((self.den, N), np.float32)
            for i in range(self.den):
                for j in range(N):
                    bank[i, j] = _sinc(
                        self.cutoff,
                        (j - N // 2 + 1) - np.float32(i) / self.den,
                        N, table, wovs)
            self.bank = bank
        else:
            n = self.oversample * N + 8
            tab = np.zeros(n, np.float32)
            for i in range(-4, self.oversample * N + 4):
                tab[i + 4] = _sinc(self.cutoff,
                                   i / np.float32(self.oversample) - N // 2,
                                   N, table, wovs)
            self.table = tab

        self.int_advance = self.num // self.den
        self.frac_advance = self.num % self.den
        self.mem = np.zeros((channels, N - 1), np.float32)
        # skip_zeros applied at open, as the decoder does (IAMF_decoder.c:1901)
        self.last_sample = N // 2
        self.samp_frac_num = 0

    @property
    def input_latency(self) -> int:
        return self.filt_len // 2

    @property
    def output_latency(self) -> int:
        return (self.input_latency * self.den + self.samp_frac_num
                ) // self.num

    def process(self, x: np.ndarray) -> np.ndarray:
        """x: [channels, T] float32 -> [channels, T_out] (FLTADJUST clamped)."""
        x = np.asarray(x, np.float32)
        T = x.shape[1]
        buf = np.concatenate([self.mem, x], axis=1)
        N = self.filt_len
        # step positions until last_sample >= T
        ls, frac = self.last_sample, self.samp_frac_num
        positions, fracs = [], []
        while ls < T:
            positions.append(ls)
            fracs.append(frac)
            ls += self.int_advance
            frac += self.frac_advance
            if frac >= self.den:
                frac -= self.den
                ls += 1
        if positions:
            pos = np.asarray(positions)
            idx = pos[:, None] + np.arange(N)[None, :]
            windows = buf[:, idx]  # [C, n, N]
            ph = np.asarray(fracs)
            if self.direct:
                # direct_single: float accumulation (float64 here; <=1 ulp)
                out = np.einsum("cnf,nf->cn", windows.astype(np.float64),
                                self.bank[ph].astype(np.float64))
                out = out.astype(np.float32)
            else:
                # interpolate_single: 4 double accumulators + cubic mix
                offs = ph * self.oversample // self.den
                fr = ((ph * self.oversample) % self.den).astype(
                    np.float32) / np.float32(self.den)
                j = np.arange(N)
                base = 4 + (j[None, :] + 1) * self.oversample - offs[:, None]
                acc = [
                    np.einsum("cnf,nf->cn", windows.astype(np.float64),
                              self.table[base + (k - 2)].astype(np.float64))
                    for k in range(4)
                ]
                c0, c1, c2, c3 = _cubic_coef(fr)
                out = (c0[None] * acc[0] + c1[None] * acc[1]
                       + c2[None] * acc[2] + c3[None] * acc[3]
                       ).astype(np.float32)
            out = np.clip(out, -1.0, 1.0)  # FLTADJUST
        else:
            out = np.zeros((self.channels, 0), np.float32)
        consumed = min(ls, T)
        self.last_sample = ls - consumed
        self.samp_frac_num = frac
        self.mem = buf[:, consumed:consumed + N - 1].copy()
        return out

    def drain(self) -> np.ndarray:
        """Flush latency with zero input (iamf_resample rest_flag==2 path,
        IAMF_decoder.c:3224-3247)."""
        zeros = np.zeros((self.channels, self.input_latency), np.float32)
        return self.process(zeros)


@functools.lru_cache(maxsize=None)
def _chunk_rows(in_rate: int, out_rate: int):
    """DeviceResampler's host precompute (filter design in Python scalar
    loops, so it is kept per rate pair and shared read-only): (host
    design, in_chunk, out_chunk, carry_len, win_start [out_chunk] int32,
    W [out_chunk, N] float32)."""
    host = Resampler(1, in_rate, out_rate, QUALITY)
    N = host.filt_len
    num, den = host.num, host.den
    Q = max(1, TARGET_CHUNK // num)
    in_chunk, out_chunk = num * Q, den * Q
    l = np.arange(out_chunk)
    ph = (num * l) % den
    win_start = ((num * l) // den).astype(np.int32)
    if host.direct:
        W = host.bank[ph]
    else:
        offs = (ph * host.oversample // den).astype(np.int64)
        fr = ((ph * host.oversample) % den).astype(
            np.float32) / np.float32(den)
        j = np.arange(N)
        base = 4 + (j[None, :] + 1) * host.oversample - offs[:, None]
        c0, c1, c2, c3 = _cubic_coef(fr)
        t = host.table.astype(np.float64)
        W = (c0[:, None] * t[base - 2] + c1[:, None] * t[base - 1]
             + c2[:, None] * t[base] + c3[:, None] * t[base + 1])
    # the carry covers the previous chunk plus the filter history the
    # first output window reaches back into
    carry_len = in_chunk + N - 1 - N // 2
    return (host, in_chunk, out_chunk, carry_len, win_start,
            np.asarray(W, np.float32))


def k10_tiles(num: int, den: int, bank: np.ndarray):
    """K10's tiles over a [den, N] per-phase bank. Outputs go in tiles of
    R = K10_R consecutive ones; the pattern repeats every L = lcm(R, den)
    outputs (a super-period), which read num*L/den inputs. Output
    j = L*M + R*u + i reads its window at floor(num*j / den) + D =
    (num*L/den)*M + start[u] + delta[u, i] + D, so tile u's outputs share
    the window at start[u] and each one's row sits in it at its delta:

        rows[u, delta[u, i] + f, i] = bank[(num*(R*u + i)) % den, f]

    zero elsewhere (NE = N + max delta taps). Returns (rows float32
    [L/R, NE, R], start int32 [L/R], inputs per super-period, L)."""
    R = K10_R
    L = R * den // math.gcd(R, den)
    k = np.arange(L).reshape(-1, R)
    a = num * k // den
    start = a[:, 0]
    delta = a - start[:, None]
    N = bank.shape[1]
    rows = np.zeros((L // R, N + int(delta.max()), R), np.float32)
    u, i = np.meshgrid(np.arange(L // R), np.arange(R), indexing="ij")
    f = np.arange(N)
    rows[u[..., None], delta[..., None] + f, i[..., None]] = \
        bank[(num * k) % den]
    return rows, start.astype(np.int32), num * L // den, L


class ResamplePlan:
    """DeviceResampler's host precompute, put on `device`: per-output
    filter rows W [out_chunk, N] and window starts win_start [out_chunk]
    for the plain twin, the chunk geometry, the per-phase bank [den, N]
    (bank[(num*o) % den] = W[o]) and K10's tiles of it (``k10_tiles``)."""

    def __init__(self, in_rate: int, out_rate: int, *, device):
        (self.host_params, self.in_chunk, self.out_chunk, self.carry_len,
         win_start, W) = _chunk_rows(in_rate, out_rate)
        self.num, self.den = self.host_params.num, self.host_params.den
        self.N = self.host_params.filt_len
        self.win_start = torch.from_numpy(win_start).to(device)
        self.W = torch.from_numpy(W).to(device)
        bank = W[:self.den][np.argsort((self.num * np.arange(self.den))
                                       % self.den)]
        self.bank = torch.from_numpy(bank).to(device)
        rows, start, self.tile_inputs, self.tile_outputs = k10_tiles(
            self.num, self.den, bank)
        self.rows = torch.from_numpy(rows).to(device)
        self.tile_start = torch.from_numpy(start).to(device)

    @property
    def lead(self) -> int:
        """D: the first output's window starts D inputs after input 0."""
        return self.in_chunk - self.carry_len

    @property
    def input_latency(self) -> int:
        return self.host_params.input_latency

    def n_out(self, T: int) -> int:
        """Outputs for T inputs with the latency drain: the host
        Resampler's process(x) + drain() count."""
        return -(-T * self.den // self.num)


def resample_plain(plan: ResamplePlan, x):
    """Plain twin: _resample_scan chunk by chunk. x [C, T_in] float32 ->
    [C, n_out(T_in)]."""
    K10.note_plain(x)
    C, T = x.shape
    want = plan.n_out(T)
    n_steps = -(-want // plan.out_chunk) + 1
    ic, cl = plan.in_chunk, plan.carry_len
    # scan step s reads xz[s*ic - cl : (s+1)*ic]; leading zeros are the
    # initial carry, trailing ones the last chunk's pad and the drain
    xz = torch.nn.functional.pad(x.to(torch.float32),
                                 (cl, n_steps * ic - T))
    idx = (plan.win_start[:, None].to(torch.int64)
           + torch.arange(plan.N, device=x.device)[None, :])
    outs = []
    for s in range(1, n_steps):  # step 0 emits nothing
        buf = xz[:, s * ic:s * ic + cl + ic]
        y = torch.einsum("cof,of->co", buf[:, idx], plan.W)
        outs.append(torch.clamp(y, -1.0, 1.0))
    return torch.cat(outs, dim=1)[:, :want]


def resample_cuda(plan: ResamplePlan, x):
    """K10 on the card: x [C, T_in] float32 -> [C, n_out(T_in)]."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"K10 takes float32 [C, T_in], got {x.dtype} "
                         f"{list(x.shape)}")
    C, T = x.shape
    x = x.contiguous()
    want = plan.n_out(T)
    y = torch.empty((C, want), dtype=torch.float32, device=x.device)
    K10(x, C, T, plan.rows, plan.tile_start, plan.rows.shape[0],
        plan.rows.shape[1], plan.tile_inputs, plan.tile_outputs, plan.lead,
        y, want)
    return y


def resample_stream(plan: ResamplePlan, x):
    """x [C, T_in] at the stream rate -> [C, n_out(T_in)] at 48 kHz, latency
    compensated (skip-zeros head drop + zero-input drain), clipped to
    [-1, 1]: K10 for a CUDA tensor, the plain twin for a CPU tensor."""
    if x.is_cuda:
        return resample_cuda(plan, x)
    return resample_plain(plan, x)
