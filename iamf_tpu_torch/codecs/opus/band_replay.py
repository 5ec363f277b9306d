"""Band-walk replay: reconstruct CELT spectra from emitted op tables.

The feasibility proof for moving the full post-range reconstruction
(SURVEY §2.3.1 stages 3-5) onto the device: the native band decode, run
with IAMF_BAND_EMIT, appends typed records (celt.h EmitOpType) describing
every reconstruction-relevant event — frame header, per-band config, the
partition tree (theta records), leaves, stereo ops. This module replays
those records using ONLY information a device program would have:

  - the op tables (integers + a few floats, all host-known at pass-1 time
    EXCEPT the per-leaf fill/kind and LCG seeds, which the replay derives
    itself from its own collapse-mask/seed threading — the emitted values
    are used exclusively as CROSS-CHECKS and the replay asserts equality),
  - PVQ leaf vectors from the device stages 1+2 (device_cwrsi +
    device_leaf, paired with the leaf tap in decode order),
  - its own norm-buffer state (fold sources), haar/hadamard transforms,
    stereo merge, and celt_lcg_rand walk.

Validated per frame against the decoder's own band tap (g_band_tap.X):
the replayed normalized spectrum matches to float32 tolerance for every
frame class in real streams (mono/stereo lanes, transients, tf merges,
folds, noise fills — tests/test_band_replay.py). This is deliberately
numpy, not jax: it pins the SEMANTICS and the op-table sufficiency; the
jax translation is mechanical (every op here is a masked vector op, the
matrices/banks the same treatment as device_leaf's rotation bank).
"""

from __future__ import annotations

import dataclasses

import numpy as np

BITRES = 3
# bit_interleave/deinterleave tables (bands.c)
BIT_INTERLEAVE = np.array([0, 1, 1, 1, 2, 3, 3, 3, 2, 3, 3, 3, 2, 3, 3, 3],
                          np.uint32)
BIT_DEINTERLEAVE = np.zeros(16, np.uint32)
for _v in range(16):
    BIT_DEINTERLEAVE[_v] = ((0xFF if _v & 8 else 0) & 0xF0) | \
                           (0xFF if _v & 2 else 0) & 0x0F
# exact bands.c table: deinterleave maps 2-bit groups back to 4-bit
BIT_DEINTERLEAVE = np.array(
    [0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F,
     0xC0, 0xC3, 0xCC, 0xCF, 0xF0, 0xF3, 0xFC, 0xFF], np.uint32)

ORDERY = {2: [1, 0], 4: [3, 0, 2, 1], 8: [7, 0, 4, 3, 6, 1, 5, 2],
          16: [15, 0, 8, 7, 12, 3, 11, 4, 14, 1, 9, 6, 13, 2, 10, 5]}

EBANDS = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28,
                   34, 40, 48, 60, 78, 100], np.int32)


def lcg(seed: int) -> int:
    return (1664525 * seed + 1013904223) & 0xFFFFFFFF


def haar1(x, n0, stride):
    n0 >>= 1
    for i in range(stride):
        for j in range(n0):
            a = np.float32(0.70710678) * x[stride * 2 * j + i]
            b = np.float32(0.70710678) * x[stride * (2 * j + 1) + i]
            x[stride * 2 * j + i] = a + b
            x[stride * (2 * j + 1) + i] = a - b


def deinterleave_hadamard(x, n0, stride, hadamard):
    tmp = np.empty(n0 * stride, np.float32)
    if hadamard:
        o = ORDERY[stride]
        for i in range(stride):
            tmp[o[i] * n0:(o[i] + 1) * n0] = x[i::stride][:n0]
    else:
        for i in range(stride):
            tmp[i * n0:(i + 1) * n0] = x[i::stride][:n0]
    x[:n0 * stride] = tmp


def interleave_hadamard(x, n0, stride, hadamard):
    tmp = np.empty(n0 * stride, np.float32)
    if hadamard:
        o = ORDERY[stride]
        for i in range(stride):
            tmp[i::stride] = x[o[i] * n0:(o[i] + 1) * n0]
    else:
        for i in range(stride):
            tmp[i::stride] = x[i * n0:(i + 1) * n0]
    x[:n0 * stride] = tmp


def renormalise(x, gain):
    e = np.float32(1e-15) + np.float32((x.astype(np.float32)**2).sum())
    x *= np.float32(gain) / np.sqrt(e)


@dataclasses.dataclass
class Rec:
    op: int
    f: np.ndarray  # u32[16]

    def i(self, j):
        return int(self.f[j])

    def flt(self, j):
        return float(self.f[j:j + 1].view(np.float32)[0])


class Replayer:
    """Replays ONE frame's records; leaf vectors supplied in decode order
    (from device stages 1+2) via `leaf_vecs` + matching pulse-nonzero
    masks for collapse extraction."""

    def __init__(self, recs, leaf_vecs, strict=True):
        self.recs = [Rec(int(r[0]), r) for r in recs]
        self.pos = 0
        self.leaf_vecs = leaf_vecs  # list of (X[n] float32,) in order
        self.leaf_i = 0
        self.strict = strict
        self.checks = 0

    def chk(self, cond, what):
        self.checks += 1
        if self.strict:
            assert cond, f"replay cross-check failed: {what}"

    def peek(self):
        return self.recs[self.pos] if self.pos < len(self.recs) else None

    def take(self, op=None):
        r = self.recs[self.pos]
        if op is not None:
            assert r.op == op, (r.op, op)
        self.pos += 1
        return r

    # ---- leaf ----
    def leaf(self, r, fill, lowband, off):
        n = r.i(2)
        k = r.i(3)
        gain = r.flt(5)
        B = r.i(6)
        self.chk(r.i(10) == (fill & 0xFFFF), f"leaf fill {fill} vs {r.i(10)}")
        self.chk(r.i(12) == self.seed, f"leaf seed {self.seed}")
        x = np.zeros(n, np.float32)
        if k > 0:
            self.chk(r.i(9) == 0, "kind pvq")
            v = self.leaf_vecs[self.leaf_i]
            self.leaf_i += 1
            x[:] = v[:n]
            cm = self._collapse_mask(x, n, B)
        else:
            cmask = (1 << B) - 1
            f2 = fill & cmask
            if not f2:
                self.chk(r.i(9) == 1, "kind zero")
                cm = 0
            elif lowband is None:
                self.chk(r.i(9) == 2, "kind noise")
                for j in range(n):
                    self.seed = lcg(self.seed)
                    x[j] = np.float32(
                        np.int32(np.uint32(self.seed)) >> 20)
                cm = cmask
                renormalise(x, gain)
            else:
                self.chk(r.i(9) == 3, "kind fold")
                for j in range(n):
                    self.seed = lcg(self.seed)
                    t = np.float32(1.0 / 256)
                    x[j] = lowband[off + j] + (
                        t if (self.seed & 0x8000) else -t)
                cm = f2
                renormalise(x, gain)
        return x, cm

    @staticmethod
    def _collapse_mask(x, n, b):
        if b <= 1:
            return 1
        n0 = n // b
        cm = 0
        for i in range(b):
            if np.any(x[i * n0:(i + 1) * n0] != 0):
                cm |= 1 << i
        return cm

    # ---- partition tree (record-driven) ----
    def partition(self, N, B, off, fill, lowband, dest):
        """Returns cm. dest: np array view of the band X buffer."""
        r = self.peek()
        if (r is not None and r.op == 5 and r.i(5) == 0
                and r.i(7) == off and r.i(6) == N // 2):
            th = self.take(5)
            itheta = th.i(1)
            B0 = B
            Nh = N // 2
            if B == 1:
                fill = (fill & 1) | (fill << 1)
            Bh = (B + 1) >> 1
            if itheta == 0:
                fill &= (1 << Bh) - 1
            elif itheta == 16384:
                fill &= ((1 << Bh) - 1) << Bh
            self.chk(th.i(9) == (fill & 0xFFFF), "theta fill")
            # which side first? the next record's offset locates it in
            # the X half [off, off+Nh) or the Y half [off+Nh, off+N)
            nxt = self.peek()
            nxt_off = nxt.i(7 if nxt.op == 5 else 1)
            x_first = nxt_off < off + Nh
            lbX = lowband
            offY = off + Nh
            if x_first:
                cm = self.partition(Nh, Bh, off, fill, lbX, dest)
                cm |= self.partition(Nh, Bh, offY, fill >> Bh, lbX,
                                     dest) << (B0 >> 1)
            else:
                cm = self.partition(Nh, Bh, offY, fill >> Bh, lbX,
                                    dest) << (B0 >> 1)
                cm |= self.partition(Nh, Bh, off, fill, lbX, dest)
            return cm
        lf = self.take(3)
        assert lf.i(1) == off and lf.i(2) == N, (lf.i(1), off, lf.i(2), N)
        x, cm = self.leaf(lf, fill, lowband, off)
        dest[off:off + N] = x
        return cm

    # ---- quant_band ----
    def quant_band(self, N, B_in, tf_in, fill, lowband, lowband_out):
        """lowband: np copy of the band's fold source (len N) or None.
        Returns (X [N] float32, cm)."""
        if N == 1:
            r = self.take(4)
            x = np.array([r.flt(2)], np.float32)
            if lowband_out is not None:
                lowband_out[0] = x[0]
            return x, 1
        cfg = self.take(9)
        N0 = N
        B = B_in
        tf_change = tf_in
        N_B = N // B
        recombine = tf_change if tf_change > 0 else 0
        self.chk(cfg.i(1) == recombine, "recombine")
        lb = lowband.copy() if lowband is not None else None
        for kk in range(recombine):
            if lb is not None:
                haar1(lb, N >> kk, 1 << kk)
            fill = int(BIT_INTERLEAVE[fill & 0xF] |
                       BIT_INTERLEAVE[fill >> 4] << 2)
        B >>= recombine
        N_B <<= recombine
        time_divide = 0
        while (N_B & 1) == 0 and tf_change < 0:
            if lb is not None:
                haar1(lb, N_B, B)
            fill |= fill << B
            B <<= 1
            N_B >>= 1
            time_divide += 1
            tf_change += 1
        B0 = B
        N_B0 = N_B
        self.chk(cfg.i(2) == time_divide, "time_divide")
        self.chk(cfg.i(4) == B0, "B0")
        self.chk(cfg.i(5) == N_B0, "N_B0")
        longBlocks = cfg.i(3)
        if B0 > 1 and lb is not None:
            deinterleave_hadamard(lb, N_B >> recombine,
                                  B0 << recombine, longBlocks)
        X = np.zeros(N, np.float32)
        cm = self.partition(N, B, 0, fill, lb, X)
        if B0 > 1:
            interleave_hadamard(X, N_B >> recombine, B0 << recombine,
                                longBlocks)
        N_B = N_B0
        B = B0
        for _ in range(time_divide):
            B >>= 1
            N_B <<= 1
            cm |= cm >> B
            haar1(X, N_B, B)
        for kk in range(recombine):
            cm = int(BIT_DEINTERLEAVE[cm & 0xF])
            haar1(X, N0 >> kk, 1 << kk)
        B <<= recombine
        if lowband_out is not None:
            lowband_out[:N0] = np.float32(np.sqrt(N0)) * X
        return X, cm & ((1 << B) - 1)

    # ---- stereo band ----
    def quant_band_stereo(self, N, B, tf_in, orig_fill, lowband,
                          lowband_out):
        if N == 1:
            rx = self.take(4)
            ry = self.take(4)
            x = np.array([rx.flt(2)], np.float32)
            y = np.array([ry.flt(2)], np.float32)
            if lowband_out is not None:
                lowband_out[0] = x[0]
            return x, y, 1
        th = self.take(5)
        assert th.i(5) == 1
        itheta, imid, iside, inv = th.i(1), th.i(2), th.i(3), th.i(4)
        fill = orig_fill
        if itheta == 0:
            fill &= (1 << B) - 1
        elif itheta == 16384:
            fill &= ((1 << B) - 1) << B
        self.chk(th.i(9) == (fill & 0xFFFF), "stereo theta fill")
        mid = np.float32(imid * (1.0 / 32768))
        side = np.float32(iside * (1.0 / 32768))
        if N == 2:
            n2 = self.take(6)
            sign = np.int32(np.uint32(n2.i(1))).item()  # +-1
            c = n2.i(2)
            # inner decode CONTINUES with orig_fill (bands.c N==2 branch)
            v, cm = self.quant_band(N, B, tf_in, orig_fill, lowband,
                                    lowband_out)
            w = np.array([-sign * v[1], sign * v[0]], np.float32)
            X, Y = (v, w) if c == 0 else (w, v)
            X = mid * X
            Y = side * Y
            t0, t1 = X[0], X[1]
            X = np.array([t0 - Y[0], t1 - Y[1]], np.float32)
            Y = np.array([t0 + Y[0], t1 + Y[1]], np.float32)
            if inv:
                Y = -Y
            return X, Y, cm
        nxt = self.peek()
        x_first = nxt is not None and nxt.i(8) == 0
        if x_first:
            X, cmx = self.quant_band(N, B, tf_in, fill, lowband,
                                     lowband_out)
            Y, cmy = self.quant_band(N, B, tf_in, fill >> B, None, None)
        else:
            Y, cmy = self.quant_band(N, B, tf_in, fill >> B, None, None)
            X, cmx = self.quant_band(N, B, tf_in, fill, lowband,
                                     lowband_out)
        cm = cmx | cmy
        mr = self.take(7)
        self.chk(mr.i(3) == imid, "merge imid")
        # stereo_merge (celt_pvq.cc)
        xp = np.float32((Y * X).sum())
        sE = np.float32((Y * Y).sum())
        xp = mid * xp
        El = mid * mid + sE - 2 * xp
        Er = mid * mid + sE + 2 * xp
        if Er < np.float32(6e-4) or El < np.float32(6e-4):
            Y = X.copy()
        else:
            lg = np.float32(1.0) / np.sqrt(El)
            rg = np.float32(1.0) / np.sqrt(Er)
            l = mid * X
            r = Y.copy()
            X = lg * (l - r)
            Y = rg * (l + r)
        if inv:
            Y = -Y
        return X, Y, cm


def replay_frame(recs, leaf_vecs, strict=True):
    """Replay one frame's op records; returns (spec [C, M*eBands[21]]
    float32 — the normalized pre-anti-collapse spectrum, i.e. the band
    tap's X domain — plus the Replayer for check counters)."""
    rp = Replayer(recs, leaf_vecs, strict=strict)
    hdr = rp.take(1)
    C = hdr.i(1)
    M = hdr.i(12)
    norm_offset = hdr.i(11)
    rp.seed = hdr.i(7)
    nbins = int(M * EBANDS[21])
    norm = np.zeros(nbins - norm_offset, np.float32)
    norm2 = np.zeros(nbins - norm_offset, np.float32)
    collapse = np.zeros((21, 2), np.int64)
    spec = np.zeros((C, nbins), np.float32)

    while rp.peek() is not None and rp.peek().op == 2:
        bd = rp.take(2)
        i, offX, N, B = bd.i(1), bd.i(2), bd.i(3), bd.i(4)
        has_lb, eff, last = bd.i(5), bd.i(6), bd.i(8)
        dual_now, xcm_a, ycm_a = bd.i(9), bd.i(10), bd.i(11)
        avg, tf, lb_off = bd.i(12), np.int32(np.uint32(bd.i(13))).item(), \
            bd.i(14)
        rp.chk(bd.i(15) == rp.seed, f"band {i} seed")
        if avg:
            norm[:offX] = np.float32(0.5) * (norm[:offX] + norm2[:offX])
        if has_lb:
            # fold range (bands.c): replayed from host-known structure
            fs = lb_off
            while M * EBANDS[fs - 1] > eff + norm_offset:
                fs -= 1
            fs -= 1
            fe = lb_off - 1
            fe += 1
            while M * EBANDS[fe] < eff + norm_offset + N:
                fe += 1
            x_cm = y_cm = 0
            for fi in range(fs, max(fe, fs + 1)):  # do-while: >= 1 pass
                x_cm |= int(collapse[fi][0])
                y_cm |= int(collapse[fi][C - 1])
        else:
            x_cm = y_cm = (1 << B) - 1
        rp.chk(x_cm == xcm_a, f"band {i} x_cm {x_cm} vs {xcm_a}")
        rp.chk(y_cm == ycm_a, f"band {i} y_cm {y_cm} vs {ycm_a}")
        lb = norm[eff:eff + N] if has_lb else None
        lb2 = norm2[eff:eff + N] if has_lb else None
        out = None if last else norm[offX:offX + N]
        out2 = None if last else norm2[offX:offX + N]
        a = offX + norm_offset
        if dual_now:
            X, cmx = rp.quant_band(N, B, tf, x_cm, lb, out)
            Y, cmy = rp.quant_band(N, B, tf, y_cm, lb2, out2)
            spec[0][a:a + N] = X
            spec[1][a:a + N] = Y
            x_cm, y_cm = cmx, cmy
        elif C == 2:
            X, Y, cm = rp.quant_band_stereo(N, B, tf, x_cm | y_cm, lb,
                                            out)
            spec[0][a:a + N] = X
            spec[1][a:a + N] = Y
            x_cm = y_cm = cm
        else:
            X, cm = rp.quant_band(N, B, tf, x_cm | y_cm, lb, out)
            spec[0][a:a + N] = X
            x_cm = y_cm = cm
        collapse[i][0] = x_cm
        collapse[i][C - 1] = y_cm
    end = rp.take(8)
    rp.chk(end.i(1) == rp.seed, "final seed")
    assert rp.leaf_i == len(rp.leaf_vecs), (rp.leaf_i, len(rp.leaf_vecs))
    return spec, rp
