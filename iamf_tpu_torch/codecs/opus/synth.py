"""CELT synthesis on the device: the time-domain half of the Opus decoder.

Counterpart of iamf_tpu/codecs/opus/tpu_synth.py. The host native decoder
exports denormalised spectra plus 13 per-frame parameters in one packed
buffer [B, L, n + 13] (``pack_params``; frames of n = 120, 240, 480 or 960
samples), a hybrid frame's host-decoded SILK pcm in n more columns
[B, L, 2n + 13]; this module turns a batch of them into s16-granular PCM
[B, L, n]:

- IMDCT + TDAC overlap: K1 (codecs/opus/imdct.py, csrc/imdct.cu);
- comb post-filter + de-emphasis (+ the SILK pcm) + s16 rounding: K2
  (csrc/comb_deemph.cu), two launches: the comb per lane on the schedule of
  ``comb_chunks``, then the de-emphasis per 960-sample block of each lane's
  timeline, as the reference blocks it.

CUDA tensors run the kernels; CPU tensors run the plain twins below, which
follow the reference's own formulation (chunked comb, blocked
lower-triangular de-emphasis). K2's comb is bit-exact with the twin's; its
scanned de-emphasis and the blocked one differ by at most 1 s16 LSB
(tests/k2_model.py models K2's order on the CPU).

The frame size and the hybrid flag are passed, never read from the width:
CELT-960 and hybrid-480 rows are both 973 wide.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ...kernels.build import I, Kernel, P
from .imdct import FRAME, FRAMES, FusedMats, imdct_overlap, window120

HIST = 1032  # > COMBFILTER_MAXPERIOD (1024) + 2, comb look-back window
MINPERIOD = 15
N_PARAMS = 13  # transient + 3x(period) + 3x(gain*taps triple)

# Packed-buffer column layout after the N spectrum columns (tpu_synth.py
# PK_*): written by pack_params, read by unpack and by K2.
PK_TRANSIENT = 0
PK_T_OLD = 1
PK_T_CUR = 2
PK_T_NEW = 3
PK_G_OLD = 4   # 3 columns
PK_G_CUR = 7   # 3 columns
PK_G_NEW = 10  # 3 columns

K2 = Kernel("iamf_k2_comb_deemph",
            [P, P, I, P, P, P, I, I, I, I, P, P, P, P])


def packed_width(n: int, hybrid: bool) -> int:
    """A packed row's width for frames of n: the spectrum, the 13
    parameters, and a hybrid frame's n SILK samples."""
    return n + N_PARAMS + (n if hybrid else 0)


def pack_params(d: dict) -> np.ndarray:
    """Pack the per-frame entropy outputs into one [B, L, 13] float32 block
    (transient, t_old/cur/new, g_old/cur/new[3 each]). Periods are <= 1024
    and gains are Q15-derived, so all are exact in float32."""
    B, L = d["transient"].shape
    out = np.empty((B, L, N_PARAMS), np.float32)
    out[..., PK_TRANSIENT] = d["transient"]
    out[..., PK_T_OLD] = d["t_old"]
    out[..., PK_T_CUR] = d["t_cur"]
    out[..., PK_T_NEW] = d["t_new"]
    out[..., PK_G_OLD:PK_G_OLD + 3] = d["g_old"]
    out[..., PK_G_CUR:PK_G_CUR + 3] = d["g_cur"]
    out[..., PK_G_NEW:PK_G_NEW + 3] = d["g_new"]
    return out


def neutral_rows(shape: tuple, n: int = FRAME,
                 hybrid: bool = False) -> np.ndarray:
    """Packed rows [*shape, packed_width(n, hybrid)] that synthesize
    silence: zero spectra, gains and SILK pcm, legal comb periods
    (MINPERIOD) so the comb never reads before its history. The batch and
    flush padding, and the sharded decoders' rows past the stream's ends
    and padded lanes."""
    z = np.zeros(tuple(shape) + (packed_width(n, hybrid),), np.float32)
    for col in (PK_T_OLD, PK_T_CUR, PK_T_NEW):
        z[..., n + col] = MINPERIOD
    return z


class SynthParams(NamedTuple):
    """Per-frame synthesis inputs, [B] opus frames x [L] channel lanes."""

    freq: torch.Tensor       # [B, L, N] denormalised spectra (32768 scale)
    transient: torch.Tensor  # [B, L] bool
    t_old: torch.Tensor      # [B, L] int32 comb period at frame start
    t_cur: torch.Tensor      # [B, L] int32 comb period decoded last frame
    t_new: torch.Tensor      # [B, L] int32 comb period decoded this frame
    g_old: torch.Tensor      # [B, L, 3] gain*taps at frame start
    g_cur: torch.Tensor      # [B, L, 3] gain*taps decoded last frame
    g_new: torch.Tensor      # [B, L, 3] gain*taps decoded this frame


class SynthCarry(NamedTuple):
    tail: torch.Tensor   # [L, 60] previous block's raw MDCT tail
    hist: torch.Tensor   # [L, HIST] comb-filtered output history
    demem: torch.Tensor  # [L] de-emphasis memory


def init_carry(lanes: int, device) -> SynthCarry:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return SynthCarry(tail=z(lanes, 60), hist=z(lanes, HIST), demem=z(lanes))


def unpack(buf: torch.Tensor, n: int) -> SynthParams:
    """[B, L, >= n+13] packed buffer -> SynthParams (views of buf)."""
    pk = buf[..., n:n + N_PARAMS]
    i32 = torch.int32
    return SynthParams(
        freq=buf[..., :n],
        transient=pk[..., PK_TRANSIENT] != 0,
        t_old=pk[..., PK_T_OLD].to(i32),
        t_cur=pk[..., PK_T_CUR].to(i32),
        t_new=pk[..., PK_T_NEW].to(i32),
        g_old=pk[..., PK_G_OLD:PK_G_OLD + 3],
        g_cur=pk[..., PK_G_CUR:PK_G_CUR + 3],
        g_new=pk[..., PK_G_NEW:PK_G_NEW + 3],
    )


class CeltSynth(torch.nn.Module):
    """Constant tables of the CELT synthesis of frames of n: the folded
    IMDCT matrices (K1) and the 120-tap overlap window (comb crossfade)."""

    def __init__(self, n: int = FRAME):
        super().__init__()
        self.n = n
        self.mats = FusedMats(n)
        self.register_buffer("window", torch.from_numpy(window120().copy()))


@functools.lru_cache(maxsize=None)
def celt_synth(device: torch.device, n: int = FRAME) -> CeltSynth:
    """The constants of frames of n on `device`, built and uploaded once:
    they are read-only, so every decoder on the device shares them (23 MB
    at n = 960 with K1's split-TF32 matrices)."""
    return CeltSynth(n).to(device)


# --- plain twin of K2 -------------------------------------------------------

def comb_coeffs(window: torch.Tensor, p: SynthParams):
    """Per-sample comb lags/coefficients [B, L, N(, 3)] reproducing the
    celt_decoder.c comb schedule (tpu_synth._comb_coeffs): [0,120) fades
    the frame-start set into the current one, [120,240) the current into
    the newly decoded one, [240, N) uses the new set."""
    B, L, n = p.freq.shape
    dev = p.freq.device
    pf = torch.arange(n, device=dev)
    in_a = pf < 120
    in_tr = (pf >= 120) & (pf < 240)
    eq_oc = (p.t_old == p.t_cur) & torch.all(p.g_old == p.g_cur, dim=-1)
    eq_cn = (p.t_cur == p.t_new) & torch.all(p.g_cur == p.g_new, dim=-1)

    f = window * window  # crossfade factor over the transition window
    zeros = functools.partial(torch.zeros, dtype=torch.float32, device=dev)
    fa = torch.cat([f, zeros(n - 120)])[None, None, :]
    fb = torch.cat([zeros(120), f, zeros(max(n - 240, 0))])[None, None, :n]
    go = p.g_old[:, :, None, :]
    gc = p.g_cur[:, :, None, :]
    gn = p.g_new[:, :, None, :]
    xa = in_a & ~eq_oc[..., None]   # [B, L, n]
    xb = in_tr & ~eq_cn[..., None]
    cross_a = xa[..., None]
    cross_b = xb[..., None]
    c1 = torch.where(in_a[:, None],
                     torch.where(cross_a, (1.0 - fa)[..., None] * go, gc),
                     torch.where(cross_b, (1.0 - fb)[..., None] * gc, gn))
    c2 = torch.where(cross_a, fa[..., None] * gc,
                     torch.where(cross_b, fb[..., None] * gn,
                                 torch.zeros_like(gn)))
    to = p.t_old[..., None]
    tc = p.t_cur[..., None]
    tn = p.t_new[..., None]
    lag1 = torch.where(in_a, torch.where(xa, to, tc),
                       torch.where(xb, tc, tn))
    lag2 = torch.where(xa, tc, torch.where(xb, tn, lag1))
    return c1, c2, lag1, lag2


def comb_filter(y, hist, c1, c2, lag1, lag2):
    """Causal comb over the flattened signal y [L, T] with history
    [L, HIST], in chunks of (smallest lag - 2) samples so every read lands
    on finished output (the reference's chunked fori_loop; the chunk size
    does not change any result)."""
    L, T = y.shape
    chunk = max(1, int(min(lag1.min(), lag2.min())) - 2)
    buf = torch.cat([hist, y], dim=1)
    for pos in range(0, T, chunk):
        n = min(chunk, T - pos)
        idx = HIST + pos + torch.arange(n, device=y.device)[None, :]
        l1 = lag1[:, pos:pos + n]
        l2 = lag2[:, pos:pos + n]
        k1 = c1[:, pos:pos + n]
        k2 = c2[:, pos:pos + n]

        def g(lag, d):
            return torch.gather(buf, 1, idx - lag + d)

        # term order matches comb_filter's summation exactly
        out = (buf[:, HIST + pos:HIST + pos + n]
               + k1[..., 0] * g(l1, 0)
               + k1[..., 1] * (g(l1, 1) + g(l1, -1))
               + k1[..., 2] * (g(l1, 2) + g(l1, -2))
               + k2[..., 0] * g(l2, 0)
               + k2[..., 1] * (g(l2, 1) + g(l2, -1))
               + k2[..., 2] * (g(l2, 2) + g(l2, -2)))
        buf[:, HIST + pos:HIST + pos + n] = out
    return buf[:, HIST:]


@functools.lru_cache(maxsize=None)
def _deemph_mats(K: int):
    """Blocked de-emphasis constants (float64 -> f32): PT[r, k] =
    0.85^(k-r) for r <= k, pw_shift[k] = 0.85^k, aK = 0.85^K."""
    k = np.arange(K, dtype=np.float64)
    P_ = np.where(k[:, None] >= k[None, :],
                  0.85 ** (k[:, None] - k[None, :]), 0.0)
    return (np.ascontiguousarray(P_.T).astype(np.float32),
            (0.85 ** k).astype(np.float32),
            float(np.float32(0.85 ** K)))


def deemphasis(z, m0):
    """out[j] = z[j] + 1e-30 + m[j-1]; m[j] = 0.85*out[j], evaluated as the
    reference does (tpu_synth._deemphasis): a blocked lower-triangular
    matmul over blocks of K = 960 samples of each lane's timeline z [L, N]
    (the last block padded), where 0.85^960 underflows to 0 so block
    memories chain by a shift; a call of N < 960 samples is one block of
    K = N entered with m0. Returns (out, the memory at the true last
    sample)."""
    L, N = z.shape
    K = 960 if N % 960 == 0 else min(N, 960)
    PT, pw_shift, _ = _deemph_mats(K)
    b = 0.85 * (z + 1e-30)
    nb = -(-N // K)
    if nb * K != N:
        b = torch.nn.functional.pad(b, (0, nb * K - N))
    u = b.reshape(L, nb, K) @ torch.from_numpy(PT).to(z.device)
    # block entry memories: m0, then each block's zero-entry end memory
    # (exact: a block of 960 forgets its entry; a shorter one is alone)
    e = torch.cat([m0[:, None], u[:, :-1, K - 1]], dim=1)
    u_shift = torch.cat(
        [torch.zeros((L, nb, 1), dtype=z.dtype, device=z.device),
         u[:, :, :-1]], dim=2)
    m_prev = u_shift + torch.from_numpy(pw_shift).to(z.device)[None, None] \
        * e[:, :, None]
    out = (z + 1e-30) + m_prev.reshape(L, nb * K)[:, :N]
    i0, k0 = (N - 1) // K, (N - 1) % K
    demem = u[:, i0, k0] + float(np.float32(0.85 ** (k0 + 1))) * e[:, i0]
    return out, demem


def comb_deemph_plain(window, y, pk_buf, hist, demem, hybrid=False):
    """Plain twin of K2: y [B, L, n] IMDCT output, pk_buf the packed
    buffer [B, L, n + 13] (hybrid: [B, L, 2n + 13], the SILK pcm added
    after the de-emphasis) -> (pcm [B, L, n], hist', demem')."""
    K2.note_plain(y)
    B, L, n = y.shape
    p = unpack(pk_buf, n)
    c1, c2, lag1, lag2 = comb_coeffs(window, p)

    def flat(a):
        return a.transpose(0, 1).reshape((L, B * n) + tuple(a.shape[3:]))

    sig = y.transpose(0, 1).reshape(L, B * n)
    z = comb_filter(sig, hist, flat(c1), flat(c2), flat(lag1), flat(lag2))
    hist2 = z[:, -HIST:] if B * n >= HIST else torch.cat(
        [hist, z], dim=1)[:, -HIST:]
    out, demem2 = deemphasis(z, demem)
    if hybrid:
        # opus_decoder.c "pcm[i] += pcm_silk[i]", at s16 value scale
        out = out + flat(pk_buf[..., n + N_PARAMS:2 * n + N_PARAMS])
    s16 = torch.round(torch.clamp(out, -32768.0, 32767.0))
    pcm = (s16 * (1.0 / 32768.0)).reshape(L, B, n).transpose(0, 1)
    return pcm.contiguous(), hist2.contiguous(), demem2


def segments(n: int = FRAME) -> tuple:
    """K2 phase A's schedule: the segments of a frame of n with one comb
    lag set each, [0,120), [120, min(240, n)), [min(240, n), n); at n = 120
    the last two are empty (the reference runs its first pass only)."""
    m = min(240, n)
    return ((0, 120), (120, m), (m, n))


def comb_chunks(pk: np.ndarray, n: int = FRAME) -> np.ndarray:
    """K2 phase A's per-segment schedule: the chunk of each segment
    (``segments(n)``) of each frame, [..., 3], from the packed parameters
    pk [..., 13]. A segment reads t_old and t_cur (t_cur alone when the
    sets are equal), t_cur and t_new (t_new alone), then t_new; its chunk
    is the smallest of those lags whose gain triple is nonzero, less 2, so
    every read with a nonzero coefficient lands on a finished output. A
    segment whose gains are all zero is one step (an empty one none)."""
    t = pk[..., PK_T_OLD:PK_T_NEW + 1].astype(np.int64)
    g = [pk[..., c:c + 3] for c in (PK_G_OLD, PK_G_CUR, PK_G_NEW)]
    none = np.int64(1 << 30)
    lag = [np.where(np.any(x != 0, axis=-1), t[..., i], none)
           for i, x in enumerate(g)]
    eq_oc = (t[..., 0] == t[..., 1]) & np.all(g[0] == g[1], axis=-1)
    eq_cn = (t[..., 1] == t[..., 2]) & np.all(g[1] == g[2], axis=-1)
    least = (np.where(eq_oc, lag[1], np.minimum(lag[0], lag[1])),
             np.where(eq_cn, lag[2], np.minimum(lag[1], lag[2])),
             lag[2])
    return np.stack([np.where(m == none, max(s1 - s0, 1),
                              np.maximum(m - 2, 1))
                     for m, (s0, s1) in zip(least, segments(n))], axis=-1)


def comb_steps(pk: np.ndarray, n: int = FRAME) -> np.ndarray:
    """Phase A's steps per lane (its dependent chain) for pk [B, L, 13]."""
    lens = np.array([s1 - s0 for s0, s1 in segments(n)])
    return (-(-lens // comb_chunks(pk, n))).sum(axis=(0, 2))


def comb_deemph_cuda(window, y, pk_buf, hist, demem, scratch=None,
                     hybrid=False):
    """K2 on the card; y [B, L, n], pk_buf the packed [B, L, n + 13] (or
    hybrid [B, L, 2n + 13]) buffer, read in place (parameter columns from
    n on, SILK from n + 13). scratch: float32 [L·B·n + L] (allocated when
    None): phase A's comb output z, [L, B·n], then its step count per
    lane (int32), read back by the tests and the smoke."""
    B, L, n = y.shape
    width = packed_width(n, hybrid)
    if (n not in FRAMES or pk_buf.shape[:2] != (B, L)
            or pk_buf.shape[2] < width or hist.shape != (L, HIST)
            or demem.shape != (L,) or window.shape != (120,)):
        raise ValueError(
            f"K2 takes y [B, L, n] (n in {FRAMES}), pk_buf [B, L, >= "
            f"{width}], hist [L, {HIST}], demem [L], window [120]; got "
            f"{[list(t.shape) for t in (y, pk_buf, hist, demem, window)]}")
    if any(t.dtype != torch.float32 for t in (y, pk_buf, hist, demem, window)):
        raise TypeError("K2 takes float32 tensors")
    y = y.contiguous()
    if y.data_ptr() % 16:  # phase A copies rows in 16-byte pieces
        y = y.clone()
    pk = pk_buf[..., n:]
    ld = pk.stride(1)
    if pk.stride(2) != 1 or pk.stride(0) != L * ld:
        pk = pk.contiguous()
        ld = pk.stride(1)
    hist = hist.contiguous()
    demem = demem.contiguous()
    window = window.contiguous()
    if scratch is None:
        scratch = y.new_empty(L * B * n + L)
    elif (scratch.shape != (L * B * n + L,) or scratch.dtype != torch.float32
          or scratch.data_ptr() % 16):
        raise ValueError(f"K2's scratch is float32 [{L * B * n + L}], "
                         "16-byte aligned")
    pcm = torch.empty_like(y)
    hist2 = torch.empty_like(hist)
    demem2 = torch.empty_like(demem)
    K2(y, pk, ld, hist, demem, window, B, L, n, int(hybrid), scratch, pcm,
       hist2, demem2)
    return pcm, hist2, demem2


def comb_deemph(window, y, pk_buf, hist, demem, hybrid=False):
    """Comb post-filter + de-emphasis (+ a hybrid frame's SILK pcm) + s16
    rounding. CUDA tensors run K2; CPU tensors run the plain twin."""
    if y.is_cuda:
        return comb_deemph_cuda(window, y, pk_buf, hist, demem, hybrid=hybrid)
    return comb_deemph_plain(window, y, pk_buf, hist, demem, hybrid)


def shard_stages(synth: CeltSynth, buf, preroll: int):
    """The shard-parallel half of the synthesis (parallel/sharded_decoder.py;
    tpu_synth.shard_stages): K1 over a shard's preroll + F frames of the
    packed buffer [preroll + F, L, n + 13] (n = synth.n) from a zero TDAC
    tail, the preroll rows dropped. The TDAC mirror mixes a block's first
    60 samples with the previous block's raw tail only, so one preroll
    frame makes every kept frame exact. Returns y [F, L, n]; the comb +
    de-emphasis IIRs carry state over the whole timeline and run as a chain
    over the shards (comb_deemph with the packed rows buf[preroll:] and an
    explicit (hist, demem) carry)."""
    n = synth.n
    transient = buf[..., n + PK_TRANSIENT] != 0
    tail0 = buf.new_zeros((buf.shape[1], 60))
    y, _ = imdct_overlap(synth.mats, buf[..., :n], transient, tail0)
    return y[preroll:]


def synthesize_packed(synth: CeltSynth, buf, carry: SynthCarry,
                      n: int | None = None, hybrid: bool = False):
    """One batch of CELT synthesis from the packed buffer [B, L, n + 13]
    (hybrid: [B, L, 2n + 13], the SILK pcm added after the de-emphasis).
    n is the frame size synth was built for (synth.n; passing another
    raises), never the width's. Returns (pcm [B, L, n] float at s16
    granularity, new carry)."""
    if n is None:
        n = synth.n
    if n != synth.n or buf.shape[-1] != packed_width(n, hybrid):
        raise ValueError(
            f"packed rows of {buf.shape[-1]} for n={n}, hybrid={hybrid}, "
            f"with constants for n={synth.n}")
    transient = buf[..., n + PK_TRANSIENT] != 0
    y, tail = imdct_overlap(synth.mats, buf[..., :n], transient, carry.tail)
    pcm, hist, demem = comb_deemph(synth.window, y, buf, carry.hist,
                                   carry.demem, hybrid)
    return pcm, SynthCarry(tail=tail, hist=hist, demem=demem)
