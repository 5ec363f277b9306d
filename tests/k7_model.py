"""A numpy model of K7 (iamf_tpu_torch/csrc/aac_synth.cu) in the kernel's
plan: the long rows' product over the 1024 distinct IMDCT columns, unfolded
to 2048 samples; the short rows' eight IMDCTs summed in line order; the
windows and overlaps indexed as the kernel indexes them. The products run
in float64 (the kernel's split-TF32 product errs by ~1e-3 at s16 scale),
the windowing and rounding in float32 as the kernel rounds them.

tests/test_torch_aac.py holds it to the plain twin on the CPU, and
tests/test_torch_cuda.py holds K7 to it on the card.
"""

import numpy as np

from iamf_tpu_torch.codecs.aac import synth

FRAME = synth.FRAME


def windowed_frames(spec, meta):
    """spec [R, 1024] float32, meta [R, 3] -> frames [R, 2048] float32."""
    tab = synth.tables()
    f32 = np.float32
    R = spec.shape[0]
    frames = np.zeros((R, 2 * FRAME), f32)
    distinct = tab["b_long"][:, synth.DISTINCT].astype(np.float64)
    bs = tab["b_short"].astype(np.float64)
    n = np.arange(FRAME)
    lo = n < 512
    for r in range(R):
        seq, shape, prev = (int(v) for v in meta[r])
        if seq != synth.EIGHT_SHORT:
            z = (spec[r].astype(np.float64) @ distinct).astype(f32)
            t0 = np.where(lo, z[np.minimum(n, 511)],
                          -z[np.clip(1023 - n, 0, 1023)])
            t1 = np.where(lo, z[np.minimum(512 + n, 1023)],
                          z[np.clip(1535 - n, 0, 1023)])
            frames[r, :FRAME] = t0 * tab["wl"][seq, prev]
            frames[r, FRAME:] = t1 * tab["wr"][seq, shape]
            continue
        ts = (spec[r].astype(np.float64).reshape(8, 128) @ bs).astype(f32)
        sl, sl0 = tab["short_half"][shape], tab["short_half"][prev]
        for p in range(448, 1600):
            q = p - 448
            j, o = q >> 7, q & 127
            if j == 0:
                frames[r, p] = ts[0, o] * sl0[o]
                continue
            right = ts[j - 1, 128 + o] * sl[127 - o]
            frames[r, p] = right + ts[j, o] * sl[o] if j < 8 else right
    return frames


def synthesize(spec, meta, carry):
    """spec [B, L, 1024], meta [B, L, 3], carry [L, 1024] -> (pcm / 32768
    [B, L, 1024], carry')."""
    B, L, _ = spec.shape
    fr = windowed_frames(spec.reshape(B * L, FRAME),
                         meta.reshape(B * L, 3)).reshape(B, L, 2 * FRAME)
    prev = np.concatenate([carry[None], fr[:-1, :, FRAME:]])
    v = fr[..., :FRAME] + prev
    pcm = np.rint(np.clip(v, -32768.0, 32767.0)).astype(np.float32)
    return pcm * np.float32(1 / 32768), fr[-1, :, FRAME:].copy()
