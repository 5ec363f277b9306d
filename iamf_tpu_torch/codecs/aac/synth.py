"""AAC-LC synthesis filterbank on the device (ISO/IEC 14496-3 4.6.11):
the time-domain half of the AAC decoder.

Counterpart of iamf_tpu/codecs/aac/tpu_synth.py. The host native decoder
(codecs/aac/decoder.py, native/src/aac/aac_frame.cc) runs the bit-serial
layers and exports post-TNS spectra [B, L, 1024] with each frame's
(window_sequence, window_shape, previous window_shape) as int32 [B, L, 3];
``synthesize`` turns a batch of them into s16-granular PCM [B, L, 1024]:

- IMDCT: 2048 outputs from 1024 lines for the long sequences, eight
  256-output IMDCTs of 128 lines each for EIGHT_SHORT;
- windows: the four sequences x two shapes (sine / KBD) as half windows,
  the left half gathered by (sequence, previous shape), the right by
  (sequence, shape); short windows overlap-add inside the frame at
  448 + 128 j;
- overlap-add across frames: out[b] = first[b] + second[b-1], with an
  [L, 1024] carry across batches; then clip, rint, / 32768.

CUDA tensors run the hand-written kernel K7 (csrc/aac_synth.cu: one
launch, FFT IMDCTs with the twiddles of ``k7_twiddles``, windows and both
overlaps within each warp); CPU tensors run the plain twin, which follows
the reference: both paths for every row, selected by sequence, matmuls in
fp32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...kernels.build import I, Kernel, P, load

FRAME = 1024
ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3

K7 = Kernel("iamf_k7_aac_synth", [P, P, P, I, I, I] + [P] * 6)


def _kbd_half(n: int, alpha: float) -> np.ndarray:
    """Kaiser-Bessel derived window first half (14496-3 4.6.11.3.3)."""
    j = np.arange(n + 1)
    x = 2.0 * j / n - 1.0
    arg = np.pi * alpha * np.sqrt(np.maximum(1.0 - x * x, 0.0))
    kern = np.i0(arg)
    return np.sqrt(np.cumsum(kern[:n]) / kern.sum())


def _sine_half(n: int) -> np.ndarray:
    return np.sin(np.pi / (2 * n) * (np.arange(n) + 0.5))


def _imdct_basis(n: int) -> np.ndarray:
    """[n/2 lines, n outputs]: (2/n) cos(2pi/n (j + n0)(k + 1/2)),
    n0 = (n/2 + 1)/2, in float64."""
    n0 = (n / 2 + 1) / 2.0
    j = np.arange(n)[:, None]
    k = np.arange(n // 2)[None, :]
    return ((2.0 / n) * np.cos(2.0 * np.pi / n * (j + n0) * (k + 0.5))).T


@functools.lru_cache(maxsize=None)
def tables() -> dict:
    """The filterbank's constants, made in float64 and stored float32 (as
    tpu_synth._tables makes them): half windows wl, wr [4, 2, 1024] by
    (sequence, shape), short halves [2, 128], the IMDCT bases b_long
    [1024, 2048] and b_short [128, 256]."""
    long_half = np.stack([_sine_half(1024), _kbd_half(1024, 4.0)])
    short_half = np.stack([_sine_half(128), _kbd_half(128, 6.0)])
    wl = np.zeros((4, 2, 1024))
    wr = np.zeros((4, 2, 1024))
    for sh in range(2):
        wl[ONLY_LONG, sh] = wl[LONG_START, sh] = long_half[sh]
        wl[LONG_STOP, sh] = np.concatenate(
            [np.zeros(448), short_half[sh], np.ones(448)])
        wr[ONLY_LONG, sh] = wr[LONG_STOP, sh] = long_half[sh][::-1]
        wr[LONG_START, sh] = np.concatenate(
            [np.ones(448), short_half[sh][::-1], np.zeros(448)])
    return {k: np.asarray(v, np.float32) for k, v in dict(
        wl=wl, wr=wr, short_half=short_half, b_long=_imdct_basis(2048),
        b_short=_imdct_basis(256)).items()}


# K7's twiddle table (k7_twiddles), float32 (re, im) rows from these
# offsets: the long (N = 2048) and short (N = 256) IMDCTs' pre- and
# post-twiddles, then the radix-8 passes' W_64^(r k) and W_512^(r k)
TW_PRE_L, TW_POST_L, TW_PRE_S, TW_POST_S, TW_64, TW_512, TW_ROWS = (
    0, 512, 1024, 1088, 1152, 1216, 1728)


@functools.lru_cache(maxsize=None)
def k7_twiddles() -> np.ndarray:
    """K7's twiddles, float32 [TW_ROWS, 2], made in float64. An N-point
    IMDCT (N/2 lines X) is an N/4-point complex inverse FFT (exponent
    +2 pi i) of v[k] = (X[N/2 - 1 - 2k] + i X[2k]) pre[k], then
    W[c] = V[c] post[c]: pre[k] = (2/N) e^(i a_k), post[c] = e^(i a_c),
    a_k = 2 pi (k + 1/8) / N, which folds in the scale 2/N and the phase
    n0 = (N/2 + 1)/2. W[c] gives the outputs t[N/4 + 2c] = Re W[c] and
    t[3N/4 - 1 - 2c] = -Im W[c]; the IMDCT's symmetries give the rest
    (tests/k7_model.py). The radix-8 passes take W_64^(r k) at
    TW_64 + 8 k + r (k < 8) and W_512^(r k) at TW_512 + 8 k + r (k < 64)."""
    def prepost(n):
        a = 2.0 * np.pi * (np.arange(n // 4) + 0.125) / n
        return (2.0 / n) * np.exp(1j * a), np.exp(1j * a)

    def radix8(n):
        k, r = np.meshgrid(np.arange(n // 8), np.arange(8), indexing="ij")
        return np.exp(2j * np.pi * (r * k).ravel() / n)

    w = np.concatenate([*prepost(2048), *prepost(256), radix8(64),
                        radix8(512)])
    assert len(w) == TW_ROWS
    return np.stack([w.real, w.imag], -1).astype(np.float32)


class Tables(torch.nn.Module):
    """The constants as buffers, moved with ``.to(device)``: the windows
    both routes read (wl, wr, short_half), the twin's short basis (b_short)
    and K7's twiddles (tw). The twin's long basis is made at its first use
    (``b_long``), so a decoder on the card never holds it."""

    def __init__(self):
        super().__init__()
        for name, a in tables().items():
            if name != "b_long":
                self.register_buffer(name, torch.from_numpy(a.copy()))
        self.register_buffer("tw", torch.from_numpy(k7_twiddles().copy()))
        self._b_long = None

    def b_long(self) -> torch.Tensor:
        """The long IMDCT basis [1024, 2048] on the tables' device."""
        if self._b_long is None or self._b_long.device != self.wl.device:
            self._b_long = torch.from_numpy(tables()["b_long"]).to(
                self.wl.device)
        return self._b_long


def init_carry(lanes: int, device) -> torch.Tensor:
    return torch.zeros((lanes, FRAME), dtype=torch.float32, device=device)


def windowed_frames(tabs: Tables, spec, meta):
    """Per-frame windowed 2048-sample IMDCT output, before the overlap-add
    (tpu_synth._windowed_frames): spec [B, L, 1024], meta [B, L, 3] int
    -> [B, L, 2048]. Both paths for every row, selected by sequence."""
    B, L, _ = spec.shape
    seq, shape, prev = (meta[..., i].long() for i in range(3))
    tl = (spec.reshape(B * L, FRAME) @ tabs.b_long()).reshape(
        B, L, 2 * FRAME)
    frame_long = torch.cat([tl[..., :FRAME] * tabs.wl[seq, prev],
                            tl[..., FRAME:] * tabs.wr[seq, shape]], dim=-1)
    ts = (spec.reshape(B * L * 8, 128) @ tabs.b_short).reshape(B, L, 8, 256)
    sh_l = tabs.short_half[shape]
    sh_l0 = tabs.short_half[prev]  # window 0's left half
    sh_r = sh_l.flip(-1)
    frame_short = spec.new_zeros((B, L, 2 * FRAME))
    for j in range(8):
        o = 448 + 128 * j
        frame_short[..., o:o + 128] += ts[:, :, j, :128] * (
            sh_l0 if j == 0 else sh_l)
        frame_short[..., o + 128:o + 256] += ts[:, :, j, 128:] * sh_r
    return torch.where((seq == EIGHT_SHORT)[..., None], frame_short,
                       frame_long)


def synthesize_plain(tabs: Tables, spec, meta, carry):
    """Plain twin of K7 (tpu_synth._synthesize)."""
    K7.note_plain(spec)
    frames = windowed_frames(tabs, spec, meta)
    first, second = frames[..., :FRAME], frames[..., FRAME:]
    prev = torch.cat([carry[None], second[:-1]], dim=0)
    s16 = torch.round(torch.clamp(first + prev, -32768.0, 32767.0))
    return s16 * (1.0 / 32768.0), second[-1]


def k7_run(B: int, L: int, fill: int) -> int:
    """Frames a K7 warp takes (and one before them): the fewest that keep
    the L * ceil(B / run) warps within ``fill``, the warps the card holds
    at once (``k7_fill``), so a large batch recomputes few frames and a
    small one still spreads over the card."""
    per_lane = fill // L
    return -(-B // per_lane) if per_lane else B


@functools.cache
def _fill(index: int) -> int:
    fn = load().iamf_k7_fill
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    n = fn(index)
    if n < 1:
        raise RuntimeError(f"iamf_k7_fill: no occupancy for cuda:{index}")
    return n


def k7_fill(dev: torch.device) -> int:
    """Warps of K7 that the card holds at once: its SMs x the CTAs an SM
    holds of the built kernel x warps a CTA (csrc/aac_synth.cu
    iamf_k7_fill)."""
    if dev.type != "cuda":
        raise ValueError(f"K7 runs on a CUDA device, got {dev}")
    return _fill(dev.index if dev.index is not None
                 else torch.cuda.current_device())


def synthesize_cuda(tabs: Tables, spec, meta, carry, run=None):
    """K7 on the card: spec [B, L, 1024] float32, meta [B, L, 3] int32,
    carry [L, 1024] -> (pcm [B, L, 1024], carry'). ``run`` is a hook for
    tests and measurement (frames a warp takes); the decode path leaves it
    None, which takes ``k7_run`` over ``k7_fill``."""
    B, L, n = spec.shape
    if (n != FRAME or tuple(meta.shape) != (B, L, 3)
            or tuple(carry.shape) != (L, FRAME)):
        raise ValueError(
            f"K7 takes spec [B, L, {FRAME}], meta [B, L, 3], carry "
            f"[L, {FRAME}]; got {list(spec.shape)}, {list(meta.shape)}, "
            f"{list(carry.shape)}")
    if (spec.dtype != torch.float32 or carry.dtype != torch.float32
            or meta.dtype != torch.int32):
        raise TypeError("K7 takes float32 spectra and carry, int32 meta")
    spec, meta = spec.contiguous(), meta.contiguous()
    if spec.data_ptr() % 8:  # K7 reads the spectra as float2
        spec = spec.clone()
    carry = carry.contiguous()
    out = torch.empty((B, L, FRAME), dtype=torch.float32, device=spec.device)
    carry_out = torch.empty_like(carry)
    run = run or k7_run(B, L, k7_fill(spec.device))
    K7(spec, meta, carry, B, L, run, tabs.tw, tabs.wl, tabs.wr,
       tabs.short_half, out, carry_out)
    return out, carry_out


def synthesize(tabs: Tables, spec, meta, carry):
    """[B, L, 1024] PCM (s16-quantized, / 32768) and the next carry from a
    batch of B consecutive frames per lane. CUDA tensors run K7; CPU
    tensors run the plain twin."""
    if spec.is_cuda:
        return synthesize_cuda(tabs, spec, meta, carry)
    return synthesize_plain(tabs, spec, meta, carry)
