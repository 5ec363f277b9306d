"""K2 as redesigned for the card (csrc/comb_deemph.cu), modelled on the CPU
in numpy float32, in the kernel's own order.

Phase A, the comb: per lane, frame by frame, segment by segment
(synth.comb_chunks), steps of `chunk` samples whose outputs read only
finished outputs; each sample sums its six terms in the reference's order.
Phase B, the de-emphasis: per (frame, lane) one warp; lane k of the warp
runs samples [30k, 30k + 30) serially from a zero memory, a Kogge-Stone scan
over the 32 lanes combines the carries (multipliers 0.85^(30·2^s)), and
each sample's memory is fixed up with 0.85^t times its lane's entry
memory. A frame's entry memory is demem for frame 0, else the zero-entry
memory at the end of frame f-1 (the same scan from 0 over frame f-1).

``inputs(case)`` builds the chains of batches the tests run: the sample's
real spectra and parameters, the shortest lags, frames whose gains are all
zero, a period change across a batch edge, B = 1, uniform random lags.
Used by tests/test_torch_comb.py (against the twin and the JAX package) and
tests/test_torch_cuda.py (the kernel bit for bit against this model).
"""

import os

import numpy as np
import torch

from iamf_tpu_torch.codecs.opus import imdct, synth
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

f32 = np.float32
HIST, FRAME = synth.HIST, synth.FRAME
SEG = 30      # samples a lane of phase B walks serially
LANES = 32    # lanes of a warp: SEG * LANES == FRAME
# fl(0.85^t) for t < 30 and fl(0.85^(30·2^s)) for s < 5, rounded from
# float64 (the kernel holds the same values as literals)
PW = (0.85 ** np.arange(SEG, dtype=np.float64)).astype(np.float32)
PS = (0.85 ** (SEG * 2.0 ** np.arange(5))).astype(np.float32)


def _segment(q, fw, s0, s1):
    """Lags and per-sample coefficients [n, 3] of one segment of a frame
    with parameters q [13], as the kernel derives them."""
    to, tc, tn = (int(q[synth.PK_T_OLD + i]) for i in range(3))
    go, gc, gn = (q[c:c + 3] for c in (synth.PK_G_OLD, synth.PK_G_CUR,
                                       synth.PK_G_NEW))
    eq_oc = to == tc and np.array_equal(go, gc)
    eq_cn = tc == tn and np.array_equal(gc, gn)
    if s0 == 0 and not eq_oc:
        lag1, lag2, g1, g2 = to, tc, go, gc
    elif s0 == 120 and not eq_cn:
        lag1, lag2, g1, g2 = tc, tn, gc, gn
    else:
        lag1 = tc if s0 == 0 else tn
        g1 = gc if s0 == 0 else gn
        n = s1 - s0
        return lag1, lag1, np.tile(g1, (n, 1)), np.zeros((n, 3), f32)
    f = fw[np.arange(s1 - s0)][:, None]
    return lag1, lag2, (f32(1) - f) * g1, f * g2


def comb(window, y, pk, hist):
    """Phase A. y [B, L, 960], pk [B, L, 13], hist [L, HIST] -> (z [L,
    B·960], hist' [L, HIST], steps [L])."""
    B, L, n = y.shape
    fw = window.astype(f32) * window.astype(f32)
    chunks = synth.comb_chunks(pk)
    buf = np.zeros((L, HIST + B * n), f32)
    buf[:, :HIST] = hist
    steps = np.zeros(L, np.int64)
    for l in range(L):
        b = buf[l]
        for f in range(B):
            for k, (s0, s1) in enumerate(synth.segments()):
                lag1, lag2, c1, c2 = _segment(pk[f, l], fw, s0, s1)
                ch = int(chunks[f, l, k])
                for p0 in range(s0, s1, ch):
                    m = min(ch, s1 - p0)
                    j = HIST + f * n + p0 + np.arange(m)
                    k1, k2 = c1[p0 - s0:p0 - s0 + m], c2[p0 - s0:p0 - s0 + m]

                    def tap(lag, d):
                        return b[j - lag + d]

                    out = (y[f, l, p0:p0 + m] + k1[:, 0] * tap(lag1, 0)
                           + k1[:, 1] * (tap(lag1, 1) + tap(lag1, -1))
                           + k1[:, 2] * (tap(lag1, 2) + tap(lag1, -2))
                           + k2[:, 0] * tap(lag2, 0)
                           + k2[:, 1] * (tap(lag2, 1) + tap(lag2, -1))
                           + k2[:, 2] * (tap(lag2, 2) + tap(lag2, -2)))
                    b[j] = out
                    steps[l] += 1
    return buf[:, HIST:], buf[:, -HIST:], steps


def _scan(c, e):
    """The warp's Kogge-Stone scan: c [..., 32] lane carries (zero-entry
    memory after each lane's 30 samples), e [...] the frame's entry memory
    -> X [..., 32], the memory after each lane."""
    x = c.copy()
    x[..., 0] = PS[0] * e + c[..., 0]
    for s in range(5):
        d = 1 << s
        nxt = x.copy()
        nxt[..., d:] = PS[s] * x[..., :-d] + x[..., d:]
        x = nxt
    return x


def deemph(z, demem, B):
    """Phase B. z [L, B·960], demem [L] -> (pcm [B, L, 960] at s16 / 32768,
    demem' [L])."""
    L = z.shape[0]
    zb = z.reshape(L, B, LANES, SEG) + f32(1e-30)
    m = np.zeros(zb.shape[:-1], f32)
    mloc = np.empty_like(zb)  # zero-entry memory after each sample
    for t in range(SEG):
        m = f32(0.85) * (zb[..., t] + m)
        mloc[..., t] = m
    c = mloc[..., -1]
    u_last = _scan(c, np.zeros((L, B), f32))[..., -1]
    e = np.concatenate([demem[:, None].astype(f32), u_last[:, :-1]], axis=1)
    X = _scan(c, e)
    E = np.concatenate([e[..., None], X[..., :-1]], axis=-1)  # lane entries
    prev = np.concatenate([np.zeros(mloc.shape[:-1] + (1,), f32),
                           mloc[..., :-1]], axis=-1)
    out = zb + (prev + PW * E[..., None])
    s16 = np.rint(np.clip(out, f32(-32768), f32(32767)))
    pcm = (s16 * f32(1.0 / 32768.0)).reshape(L, B, FRAME).transpose(1, 0, 2)
    return np.ascontiguousarray(pcm), X[:, -1, -1]


def k2(window, y, pk, hist, demem):
    """Both phases: (pcm [B, L, 960], hist', demem', z, steps)."""
    z, hist2, steps = comb(window, y, pk, hist)
    pcm, demem2 = deemph(z, demem, y.shape[0])
    return pcm, hist2, demem2, z, steps


# --- the inputs the tests hold the model and the kernel on -----------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMEM_REL = 1e-6  # demem' bound, relative to the largest |demem'|: ~8 ulp
TAPS = np.load(os.path.join(ROOT, "iamf_tpu_torch", "data",
                            "opus_tables.npz"))["gains"].astype(
    np.float32).reshape(3, 3)


def sample_batches():
    """The sample's real spectra through the K1 twin (its tail chained) and
    its packed parameters, as two batches of 8 frames: [(y, pk)]."""
    data = open(os.path.join(ROOT, "iamf_tpu", "data",
                             "sample_opus_714.iamf"), "rb").read()
    d = BatchedStreamDecoder(data, sound_system=9, batch_frames=8,
                             device="cpu")
    e = d.elems[0]
    packets = [d.frames_per_substream[s] for s in e.substream_ids]
    mats = imdct.FusedMats()
    tail = None
    out = []
    for start in (0, 8):
        buf = torch.from_numpy(d._opus_entropy(e, packets, start, 8, 8))
        if tail is None:
            tail = torch.zeros(buf.shape[1], 60)
        y, tail = imdct.imdct_overlap(mats, buf[..., :960],
                                      buf[..., 960] != 0, tail)
        out.append((y.numpy(), buf.numpy()[..., 960:]))
    return out


def chain(rng, n_frames, L, periods, zero_frames=(), change_at=()):
    """Packed parameters [n_frames, L, 13] of consecutive frames: a frame's
    old and current set are the previous frame's new one (CELT's rollover),
    the new one is drawn (half the frames keep the period; gains 0.09375 ·
    (0..8) times a tapset row). Frames in zero_frames have every gain 0;
    frames in change_at change the period."""
    per = rng.choice(periods, L)
    g = np.zeros((L, 3), np.float32)
    pk = np.zeros((n_frames, L, 13), np.float32)
    for f in range(n_frames):
        new_per = np.where(rng.rand(L) < 0.5, per, rng.choice(periods, L))
        if f in change_at:
            other = np.where(per == periods[0], periods[-1], periods[0])
            new_per = np.where(new_per == per, other, new_per)
        new_g = (np.float32(0.09375) * rng.randint(0, 9, L))[:, None] \
            * TAPS[rng.randint(0, 3, L)]
        if f in zero_frames or f + 1 in zero_frames:
            new_g[:] = 0.0
        pk[f, :, 1:3] = per[:, None]
        pk[f, :, 3] = new_per
        pk[f, :, 4:7] = g
        pk[f, :, 7:10] = g
        pk[f, :, 10:13] = new_g
        per, g = new_per, new_g
    return pk


def random_batches(seed, B, L, n_batches, periods, **kw):
    """[(y, pk)]: Gaussian IMDCT output at s16 scale, chained parameters."""
    rng = np.random.RandomState(seed)
    pk = chain(rng, B * n_batches, L, np.asarray(periods), **kw)
    return [((rng.randn(B, L, 960) * 3000).astype(np.float32),
             pk[i * B:(i + 1) * B]) for i in range(n_batches)]


def uniform_batches():
    """Periods drawn independently per frame from 15..1024 and gains
    uniform in [0, 0.3): no crossfade is ever skipped."""
    rng = np.random.RandomState(1)
    pk = np.zeros((3, 12, 13), np.float32)
    pk[..., 1:4] = rng.randint(15, 1025, size=(3, 12, 3))
    pk[..., 4:13] = rng.rand(3, 12, 9) * 0.3
    return [((rng.randn(3, 12, 960) * 3000).astype(np.float32), pk)]


LONG = list(range(15, 1025))
CASES = {
    "sample_2_batches": sample_batches,
    # the shortest lags: chunks of 13, 14 and 15, one warp
    "lags_15_16_17": lambda: random_batches(3, 3, 4, 2, [15, 16, 17]),
    # lags 15..20 over 12 lanes, frames 1 and 5 with every gain 0
    "lags_15_to_20_zero_gains": lambda: random_batches(
        8, 4, 12, 2, list(range(15, 21)), zero_frames=(1, 5)),
    # frame 2 has every gain 0: each of its segments is one step
    "zero_gain_frame": lambda: random_batches(4, 4, 3, 1, LONG,
                                              zero_frames=(2,)),
    # the last frame of the first batch changes the period
    "period_change_across_batch_edge": lambda: random_batches(
        5, 4, 3, 2, list(range(15, 300)), change_at=(3,)),
    # a batch shorter than the comb history
    "b1": lambda: random_batches(6, 1, 3, 4, LONG),
    "uniform_random": uniform_batches,
}
ZERO_FRAMES = {"lags_15_to_20_zero_gains": (1, 5), "zero_gain_frame": (2,)}


def inputs(case):
    """(batches [(y [B, L, 960], pk [B, L, 13])], hist0 [L, HIST], demem0
    [L]): the sample starts from zero carries, as a decode does; the others
    from random ones."""
    batches = CASES[case]()
    L = batches[0][0].shape[1]
    rng = np.random.RandomState(7)
    hist0 = (rng.randn(L, HIST) * 3000).astype(np.float32)
    demem0 = (rng.randn(L) * 100).astype(np.float32)
    if case == "sample_2_batches":
        hist0[:], demem0[:] = 0.0, 0.0
    return batches, hist0, demem0
