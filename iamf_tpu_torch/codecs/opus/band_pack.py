"""Pass-1 packing: flatten band-walk op records into fixed-shape tensors.

The record-driven replay (band_replay.py) proves the op tables suffice;
this layer proves they FLATTEN — the jitted device program's input format.
The tree-structured fill/cm semantics compress exactly because every
transformation in the chain (bit_interleave tables, `fill |= fill << B`,
`(fill & 1) | (fill << 1)`, shifts, theta masks, bit_deinterleave) is a
bit-level OR-map: output bit j is the OR of a fixed set of input bits. So

  - each leaf's fill function (band entry value -> fill at the leaf) is a
    16-column bit matrix, precomputed by pushing single-bit probes down
    the recorded root->leaf path;
  - each leaf's collapse-mask contribution is a plain shift (cm_shift);
  - each band's upward cm transform is another 16-column bit matrix.

The packed replay (packed_replay_frame) then needs NO tree walking at
run time: it executes the leaf list in decode order with the
cm/fill/seed threading as flat tensor ops — band assembly, fold reads,
haar/hadamard, and stereo merges keyed by per-band params. Validated
frame-exact against the decoder's tap on the same corpora as the record
replay (tests/test_band_replay.py::test_packed_*)."""

from __future__ import annotations

import dataclasses

import numpy as np

from .band_replay import (BIT_DEINTERLEAVE, BIT_INTERLEAVE, EBANDS, Rec,
                          deinterleave_hadamard, haar1, interleave_hadamard,
                          lcg, renormalise)

FILL_BITS = 16


def _probe(fns, bits=FILL_BITS):
    """16-column OR-map of a composed bit-level function chain."""
    cols = np.zeros(bits, np.uint32)
    for i in range(bits):
        v = 1 << i
        for f in fns:
            v = f(v)
        cols[i] = v
    return cols


def _apply_cols(cols, v):
    out = 0
    for i in range(FILL_BITS):
        if (v >> i) & 1:
            out |= int(cols[i])
    return out


@dataclasses.dataclass
class PackedLeaf:
    band: int
    ch: int          # 0/1 (stereo Y or dual Y = 1)
    off: int         # within the band partition domain
    n: int
    k: int           # >0 pvq; 0 q0; -1 n1 (value in n1val)
    vec_idx: int     # stage-1+2 leaf vector row (pvq only)
    gain: float
    b_leaf: int
    cm_shift: int
    fill_cols: np.ndarray  # [16] u32 OR-map band_fill -> leaf fill
    n1val: float = 0.0
    fill_chk: int = -1     # emitted actual fill (cross-check)
    kind_chk: int = -1
    seed_chk: int = -1


@dataclasses.dataclass
class PackedBand:
    i: int
    offX: int
    N: int
    B: int
    tf: int
    has_lb: bool
    eff: int
    fs: int
    fe: int
    last: bool
    mode: int        # 0 mono, 1 stereo, 2 dual
    avg: bool
    cfg: tuple       # (recombine, time_divide, longBlocks, B0, N_B0)
    cm_cols: np.ndarray  # [16] u32 band cm post-transform OR-map
    # stereo params
    merge_imid: int = 0
    inv: int = 0
    n2: tuple | None = None  # (sign, c, imid, iside)
    n1vals: tuple | None = None
    xcm_chk: int = -1
    ycm_chk: int = -1


@dataclasses.dataclass
class PackedFrame:
    C: int
    M: int
    norm_offset: int
    seed0: int
    bands: list
    leaves: list     # decode order (seed chain order)


def _band_cm_cols(recombine, time_divide, B0):
    fns = []
    B = B0
    for _ in range(time_divide):
        B >>= 1

        def mk(b):
            return lambda v: v | (v >> b)

        fns.append(mk(B))
    for _ in range(recombine):
        fns.append(lambda v: int(BIT_DEINTERLEAVE[v & 0xF]))
    return _probe(fns)


class _Packer:
    """Walks one frame's records (same traversal as band_replay.Replayer)
    collecting per-leaf path metadata instead of floats."""

    def __init__(self, recs):
        self.recs = [Rec(int(r[0]), r) for r in recs]
        self.pos = 0
        self.leaves: list[PackedLeaf] = []
        self.vec_counter = 0

    def peek(self):
        return self.recs[self.pos] if self.pos < len(self.recs) else None

    def take(self, op=None):
        r = self.recs[self.pos]
        if op is not None:
            assert r.op == op, (r.op, op)
        self.pos += 1
        return r

    def partition(self, band, ch, N, B, off, path, cm_shift, has_lb):
        r = self.peek()
        if (r is not None and r.op == 5 and r.i(5) == 0
                and r.i(7) == off and r.i(6) == N // 2):
            th = self.take(5)
            itheta = th.i(1)
            B0 = B
            Nh = N // 2
            pre = list(path)
            if B == 1:
                pre.append(lambda v: (v & 1) | (v << 1))
            Bh = (B + 1) >> 1
            if itheta == 0:
                pre.append(lambda v, m=(1 << Bh) - 1: v & m)
            elif itheta == 16384:
                pre.append(lambda v, m=((1 << Bh) - 1) << Bh: v & m)
            nxt = self.peek()
            nxt_off = nxt.i(7 if nxt.op == 5 else 1)
            x_first = nxt_off < off + Nh
            ypath = pre + [lambda v, b=Bh: v >> b]
            sh_y = cm_shift + (B0 >> 1)
            if x_first:
                self.partition(band, ch, Nh, Bh, off, pre, cm_shift,
                               has_lb)
                self.partition(band, ch, Nh, Bh, off + Nh, ypath, sh_y,
                               has_lb)
            else:
                self.partition(band, ch, Nh, Bh, off + Nh, ypath, sh_y,
                               has_lb)
                self.partition(band, ch, Nh, Bh, off, pre, cm_shift,
                               has_lb)
            return
        lf = self.take(3)
        assert lf.i(1) == off and lf.i(2) == N
        k = lf.i(3)
        vec = -1
        if k > 0:
            vec = self.vec_counter
            self.vec_counter += 1
        self.leaves.append(PackedLeaf(
            band=band, ch=ch, off=off, n=N, k=k, vec_idx=vec,
            gain=lf.flt(5), b_leaf=lf.i(6), cm_shift=cm_shift,
            fill_cols=_probe(path), fill_chk=lf.i(10), kind_chk=lf.i(9),
            seed_chk=lf.i(12)))

    def quant_band(self, band, ch, N, B_in, tf_in, has_lb, base_path):
        if N == 1:
            r = self.take(4)
            self.leaves.append(PackedLeaf(
                band=band, ch=ch, off=0, n=1, k=-1, vec_idx=-1, gain=1.0,
                b_leaf=1, cm_shift=0, fill_cols=_probe([]),
                n1val=r.flt(2)))
            return (0, 0, 1, 1, 1), _probe([])
        cfg = self.take(9)
        recombine, time_divide = cfg.i(1), cfg.i(2)
        longBlocks, B0, N_B0 = cfg.i(3), cfg.i(4), cfg.i(5)
        path = list(base_path)
        for _ in range(recombine):
            path.append(lambda v: int(
                BIT_INTERLEAVE[v & 0xF] | BIT_INTERLEAVE[(v >> 4) & 0xF]
                << 2))
        B = B_in >> recombine
        nb = (N // B_in) << recombine
        tmp_B = B
        tfc = tf_in
        steps = 0
        while (nb & 1) == 0 and tfc < 0:
            def mk(b):
                return lambda v: v | (v << b)

            path.append(mk(tmp_B))
            tmp_B <<= 1
            nb >>= 1
            tfc += 1
            steps += 1
        assert steps == time_divide, (steps, time_divide, N, B_in, tf_in)
        assert tmp_B == B0, (tmp_B, B0)
        assert nb == N_B0, (nb, N_B0)
        self.partition(band, ch, N, tmp_B, 0, path, 0, has_lb)
        return ((recombine, time_divide, longBlocks, B0, N_B0),
                _band_cm_cols(recombine, time_divide, B0))


def pack_frame(recs) -> PackedFrame:
    pk = _Packer(recs)
    hdr = pk.take(1)
    C, M, norm_offset = hdr.i(1), hdr.i(12), hdr.i(11)
    pf = PackedFrame(C=C, M=M, norm_offset=norm_offset, seed0=hdr.i(7),
                     bands=[], leaves=None)
    while pk.peek() is not None and pk.peek().op == 2:
        bd = pk.take(2)
        i, offX, N, B = bd.i(1), bd.i(2), bd.i(3), bd.i(4)
        has_lb, eff, last = bd.i(5), bd.i(6), bd.i(8)
        dual_now, avg = bd.i(9), bd.i(12)
        tf = np.int32(np.uint32(bd.i(13))).item()
        lb_off = bd.i(14)
        fs = fe = 0
        if has_lb:
            fs = lb_off
            while M * EBANDS[fs - 1] > eff + norm_offset:
                fs -= 1
            fs -= 1
            fe = lb_off
            while M * EBANDS[fe] < eff + norm_offset + N:
                fe += 1
        merge_imid = inv = 0
        n2 = None
        n1vals = None
        if dual_now:
            cfg, cmc = pk.quant_band(i, 0, N, B, tf, has_lb, [])
            cfg2, cmc2 = pk.quant_band(i, 1, N, B, tf, has_lb, [])
            mode = 2
        elif C == 2:
            mode = 1
            if N == 1:
                rx = pk.take(4)
                ry = pk.take(4)
                n1vals = (rx.flt(2), ry.flt(2))
                cfg, cmc = (0, 0, 1, 1, 1), _probe([])
            else:
                th = pk.take(5)
                assert th.i(5) == 1
                itheta = th.i(1)
                merge_imid, inv = th.i(2), th.i(4)
                base = []
                if itheta == 0:
                    base.append(lambda v, m=(1 << B) - 1: v & m)
                elif itheta == 16384:
                    base.append(lambda v, m=((1 << B) - 1) << B: v & m)
                if N == 2:
                    r2 = pk.take(6)
                    n2 = (np.int32(np.uint32(r2.i(1))).item(), r2.i(2),
                          r2.i(3), r2.i(4))
                    # inner call uses orig_fill: NO theta mask on its path
                    cfg, cmc = pk.quant_band(i, 0, N, B, tf, has_lb, [])
                else:
                    nxt = pk.peek()
                    x_first = nxt is not None and nxt.i(8) == 0
                    ypath = base + [lambda v, b=B: v >> b]
                    if x_first:
                        cfg, cmc = pk.quant_band(i, 0, N, B, tf, has_lb,
                                                 base)
                        pk.quant_band(i, 1, N, B, tf, False, ypath)
                    else:
                        pk.quant_band(i, 1, N, B, tf, False, ypath)
                        cfg, cmc = pk.quant_band(i, 0, N, B, tf, has_lb,
                                                 base)
                    mr = pk.take(7)
                    merge_imid = mr.i(3)
                    inv = mr.i(4)
        else:
            mode = 0
            cfg, cmc = pk.quant_band(i, 0, N, B, tf, has_lb, [])
        pf.bands.append(PackedBand(
            i=i, offX=offX, N=N, B=B, tf=tf, has_lb=bool(has_lb),
            eff=eff, fs=fs, fe=fe, last=bool(last), mode=mode,
            avg=bool(avg), cfg=cfg, cm_cols=cmc, merge_imid=merge_imid,
            inv=inv, n2=n2, n1vals=n1vals, xcm_chk=bd.i(10),
            ycm_chk=bd.i(11)))
    end = pk.take(8)
    del end
    pf.leaves = pk.leaves
    return pf


def _collapse_mask(x, n, b):
    if b <= 1:
        return 1
    n0 = n // b
    cm = 0
    for i in range(b):
        if np.any(x[i * n0:(i + 1) * n0] != 0):
            cm |= 1 << i
    return cm


def packed_replay_frame(pf: PackedFrame, leaf_vecs):
    """Execute the packed frame: flat leaf list in decode order with
    cm/fill/seed threading, per-band assembly + transforms, stereo ops.
    Returns spec [C, M*eBands[21]] float32 (the band tap's X domain)."""
    C, M, no = pf.C, pf.M, pf.norm_offset
    nbins = int(M * EBANDS[21])
    norm = np.zeros(nbins - no, np.float32)
    norm2 = np.zeros(nbins - no, np.float32)
    collapse = np.zeros((21, 2), np.int64)
    seed = pf.seed0
    spec = np.zeros((C, nbins), np.float32)
    # leaves grouped by band (decode order preserved within)
    by_band: dict[int, list] = {}
    for lf in pf.leaves:
        by_band.setdefault(lf.band, []).append(lf)

    for b in pf.bands:
        N = b.N
        a = b.offX + no
        if b.avg:
            norm[:b.offX] = np.float32(0.5) * (norm[:b.offX]
                                               + norm2[:b.offX])
        if b.has_lb:
            x_cm = y_cm = 0
            for fi in range(b.fs, max(b.fe, b.fs + 1)):
                x_cm |= int(collapse[fi][0])
                y_cm |= int(collapse[fi][C - 1])
        else:
            x_cm = y_cm = (1 << b.B) - 1
        assert b.xcm_chk < 0 or x_cm == b.xcm_chk, (
            "band", b.i, "x_cm", x_cm, b.xcm_chk)
        assert b.ycm_chk < 0 or y_cm == b.ycm_chk, (
            "band", b.i, "y_cm", y_cm, b.ycm_chk)
        if b.mode == 1 and b.n1vals is not None:  # stereo N==1
            spec[0][a] = b.n1vals[0]
            spec[1][a] = b.n1vals[1]
            if not b.last:
                norm[b.offX] = b.n1vals[0]
            collapse[b.i][0] = collapse[b.i][C - 1] = 1
            continue
        entry = {0: x_cm | y_cm, 1: x_cm | y_cm}
        if b.mode == 2:
            entry = {0: x_cm, 1: y_cm}
        recombine, time_divide, longBlocks, B0, N_B0 = b.cfg
        # per-channel transformed fold source
        lbs = {}
        if b.has_lb:
            for ch, src in ((0, norm), (1, norm2)):
                if ch == 1 and b.mode != 2:
                    continue
                lb = src[b.eff:b.eff + N].copy()
                for kk in range(recombine):
                    haar1(lb, N >> kk, 1 << kk)
                tdB = b.B >> recombine
                tdN = (N // b.B) << recombine
                tfc = b.tf
                while (tdN & 1) == 0 and tfc < 0:
                    haar1(lb, tdN, tdB)
                    tdB <<= 1
                    tdN >>= 1
                    tfc += 1
                if B0 > 1:
                    deinterleave_hadamard(lb, N_B0 >> recombine,
                                          B0 << recombine, longBlocks)
                lbs[ch] = lb
        Xd = {0: np.zeros(N, np.float32), 1: np.zeros(N, np.float32)}
        cm_acc = {0: 0, 1: 0}
        n1flag = {0: False, 1: False}
        for lf in by_band.get(b.i, []):
            if lf.k == -1:  # mono/dual N==1
                Xd[lf.ch][0] = lf.n1val
                cm_acc[lf.ch] |= 1
                n1flag[lf.ch] = True
                continue
            fill_leaf = _apply_cols(lf.fill_cols, entry[lf.ch])
            assert lf.fill_chk < 0 or (fill_leaf & 0xFFFF) == lf.fill_chk, (
                "band", b.i, "leaf", lf.off, fill_leaf, lf.fill_chk)
            assert lf.seed_chk < 0 or seed == lf.seed_chk, (
                "band", b.i, "leaf", lf.off, "seed", seed, lf.seed_chk)
            x = np.zeros(lf.n, np.float32)
            if lf.k > 0:
                x[:] = leaf_vecs[lf.vec_idx][:lf.n]
                cm = _collapse_mask(x, lf.n, lf.b_leaf)
            else:
                cmask = (1 << lf.b_leaf) - 1
                f2 = fill_leaf & cmask
                leaf_has_lb = b.has_lb and (b.mode != 1 or lf.ch == 0)
                kind = 1 if not f2 else (2 if not leaf_has_lb else 3)
                assert lf.kind_chk < 0 or kind == lf.kind_chk, (
                    "band", b.i, "ch", lf.ch, "off", lf.off,
                    "kind", kind, lf.kind_chk)
                if not f2:
                    cm = 0
                elif not leaf_has_lb:
                    for j in range(lf.n):
                        seed = lcg(seed)
                        x[j] = np.float32(np.int32(np.uint32(seed)) >> 20)
                    cm = cmask
                    renormalise(x, lf.gain)
                else:
                    lb = lbs[lf.ch if b.mode == 2 else 0]
                    for j in range(lf.n):
                        seed = lcg(seed)
                        t = np.float32(1.0 / 256)
                        x[j] = lb[lf.off + j] + (
                            t if (seed & 0x8000) else -t)
                    cm = f2
                    renormalise(x, lf.gain)
            Xd[lf.ch][lf.off:lf.off + lf.n] = x
            cm_acc[lf.ch] |= cm << lf.cm_shift
        # upward transforms + cm post-map per channel
        chans = (0, 1) if b.mode in (1, 2) else (0,)
        cm_final = {}
        for ch in chans:
            if n1flag[ch] or N == 1:
                cm_final[ch] = 1
                continue
            X = Xd[ch]
            if B0 > 1:
                interleave_hadamard(X, N_B0 >> recombine,
                                    B0 << recombine, longBlocks)
            tdB, tdN = B0, N_B0
            for _ in range(time_divide):
                tdB >>= 1
                tdN <<= 1
                haar1(X, tdN, tdB)
            for kk in range(recombine):
                haar1(X, N >> kk, 1 << kk)
            B_fin = (B0 >> time_divide) << recombine
            cm_final[ch] = _apply_cols(b.cm_cols, cm_acc[ch]) & (
                (1 << B_fin) - 1)
        X, Y = Xd[0], Xd[1]
        X_pre = X.copy()  # lowband_out is written INSIDE quant_band,
        # i.e. BEFORE the stereo merge/N2 construction (bands.c order)
        cmv = cm_final.get(0, 1)
        if b.mode == 1 and N >= 2:
            imid = b.merge_imid if b.n2 is None else b.n2[2]
            iside = 0 if b.n2 is None else b.n2[3]
            mid = np.float32(imid * (1.0 / 32768))
            if b.n2 is not None:
                sign, c, _, _ = b.n2
                side = np.float32(iside * (1.0 / 32768))
                v = X[:2].copy()
                w = np.array([-sign * v[1], sign * v[0]], np.float32)
                Xv, Yv = (v, w) if c == 0 else (w, v)
                Xv = mid * Xv
                Yv = side * Yv
                t0, t1 = Xv[0], Xv[1]
                X = np.array([t0 - Yv[0], t1 - Yv[1]], np.float32)
                Y = np.array([t0 + Yv[0], t1 + Yv[1]], np.float32)
            else:
                cmv = cm_final[0] | cm_final[1]
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
            if b.inv:
                Y = -Y
        spec[0][a:a + N] = X
        if C == 2:
            spec[1][a:a + N] = Y if b.mode != 2 else Xd[1]
        if b.mode == 2:
            spec[1][a:a + N] = Xd[1]
        if not b.last:
            sq = np.float32(np.sqrt(N)) if N > 1 else np.float32(1.0)
            norm[b.offX:b.offX + N] = sq * X_pre
            if b.mode == 2:
                norm2[b.offX:b.offX + N] = sq * Xd[1]
        if b.mode == 2:
            collapse[b.i][0] = cm_final[0]
            collapse[b.i][C - 1] = cm_final[1]
        else:
            cmv = cmv if b.mode == 0 else (
                cmv if b.n2 is not None else cm_final[0] | cm_final[1])
            collapse[b.i][0] = collapse[b.i][C - 1] = cmv
    return spec
