"""Layout renderers: M2M (multichannel->multichannel) and H2M (ambisonics->
multichannel) as static gain matrices (a copy of iamf_tpu/dsp/render.py;
its table file is this package's data/render_tables.npz).

Reference: m2m_rdr.c (table :1629-1778, render :1820-1840, matrices comply
with the EAR Direct Speakers renderer / ITU-R BS.2127-0 except 3.1.2 & 7.1.2
per IAMF §7.3.2.1, comment m2m_rdr.c:833-835) and h2m_rdr.c (tables
:1002-1062, render + LFE slot insertion :1088-1135). Matrix data extracted
from the reference libraries by tools/extract_render_tables.py into
data/render_tables.npz (both the spec/EAR set and the SAMSUNG_TV set).
"""

from __future__ import annotations

import functools
import os

import numpy as np

from ..constants import ChannelLayout, SoundSystem

_DATA_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                          "render_tables.npz")

# IAMF_SOUND_SYSTEM rendering ids (ae_rdr.h:40-61)
BS2051_IDS = {
    SoundSystem.A: 0x020,
    SoundSystem.B: 0x050,
    SoundSystem.C: 0x250,
    SoundSystem.D: 0x450,
    SoundSystem.E: 0x451,
    SoundSystem.F: 0x370,
    SoundSystem.G: 0x490,
    SoundSystem.H: 0x9A3,
    SoundSystem.I: 0x070,
    SoundSystem.J: 0x470,
    SoundSystem.EXT_712: 0x712,
    SoundSystem.EXT_312: 0x312,
    SoundSystem.MONO: 0x100,
}

# IA layer layout -> input rendering id (IAMF_decoder.c:257-263)
LAYER_IDS = {
    ChannelLayout.MONO: 0x100,
    ChannelLayout.STEREO: 0x200,
    ChannelLayout.L510: 0x510,
    ChannelLayout.L512: 0x512,
    ChannelLayout.L514: 0x514,
    ChannelLayout.L710: 0x710,
    ChannelLayout.L712: 0x712,
    ChannelLayout.L714: 0x714,
    ChannelLayout.L312: 0x312,
    ChannelLayout.BINAURAL: 0x1020,
}

BINAURAL_ID = 0x1020


@functools.lru_cache(maxsize=1)
def _tables():
    return np.load(_DATA_PATH)


@functools.lru_cache(maxsize=None)
def m2m_matrix(in_id: int, out_id: int, samsung_tv: bool = False) -> np.ndarray:
    """[in_ch, out_ch] gain matrix (in-major, as render_M2M indexes it)."""
    variant = "tv" if samsung_tv else "std"
    key = f"{variant}/m2m/{in_id:x}/{out_id:x}"
    z = _tables()
    if key not in z:
        raise KeyError(f"no M2M matrix for {in_id:#x} -> {out_id:#x}")
    return z[key]


@functools.lru_cache(maxsize=None)
def h2m_matrix(order: int, out_id: int, samsung_tv: bool = False):
    """([out_ch_nolfe, in_ch] matrix, channels, lfe1, lfe2)."""
    variant = "tv" if samsung_tv else "std"
    z = _tables()
    key = f"{variant}/h2m/{order}/{out_id:x}"
    if key not in z:
        raise KeyError(f"no H2M matrix for order {order} -> {out_id:#x}")
    meta = z[f"{variant}/h2m_meta/{order}/{out_id:x}"]
    return z[key], int(meta[0]), int(meta[1]), int(meta[2])


def h2m_full_matrix(
    order: int, out_id: int, out_channels: int, samsung_tv: bool = False
) -> np.ndarray:
    """Full [out_channels, in_ch] H2M matrix with LFE slots inserted as zero
    rows (LFE synthesis is off by default: DISABLE_LFE_HOA=1, ae_rdr.h:63-65).

    Replicates the channel-shift map of render_H2M (h2m_rdr.c:1114-1135).
    """
    mat, channels, lfe1, lfe2 = h2m_matrix(order, out_id, samsung_tv)
    n_size = mat.shape[0]
    full = np.zeros((out_channels, mat.shape[1]), dtype=np.float32)
    if lfe1 < 0 and lfe2 < 0:
        full[:n_size] = mat
        return full
    # build map: source row i -> destination row, skipping lfe slots
    n = 0
    dest = []
    for i in range(n_size):
        if lfe1 == i:
            n += 1
        if lfe2 == i:
            n += 1
        dest.append(n)
        n += 1
    for i, d in enumerate(dest):
        if d < out_channels:
            full[d] = mat[i]
    # lfe rows remain zero
    return full


def hoa_order_for_channels(channels: int) -> int:
    """iamf_stream_ambisionisc_order (IAMF_decoder.c:2392-2401)."""
    return {1: 0, 4: 1, 9: 2, 16: 3}.get(channels, -1)


class LFEFilter:
    """The H2M LFE-synthesis biquad (h2m_rdr.c lfefilter_init/update
    :1198-1238, enabled by a DISABLE_LFE_HOA=0 reference build): a
    2nd-order bilinear-transform low-pass (120 Hz default) applied to the
    ambisonics W channel, with input/output history carried across frames.
    All arithmetic replicated in float32 in the reference's evaluation
    order so the serial path diffs bit-exactly against that build."""

    def __init__(self, cutoff_hz: float = 120.0, rate: float = 48000.0):
        import math

        f32 = np.float32
        # C: float dt = 1/sample_rate + 1.0e-10 (double add, float store)
        dt = f32(np.float64(f32(1.0) / f32(rate)) + 1.0e-10)
        if cutoff_hz <= 0:
            self.a1 = self.a2 = self.a3 = self.b1 = self.b2 = f32(0)
        else:
            # C: c = 1.0f / tanf(M_PI * cutoff * dt) — double product
            # narrowed to float for tanf
            arg = f32(math.pi * np.float64(cutoff_hz) * np.float64(dt))
            c = f32(1.0) / f32(math.tan(np.float64(arg)))
            self.a1 = f32(1.0) / (f32(1.0) + c + c * c)
            self.a2 = f32(2.0) * self.a1
            self.a3 = self.a1
            self.b1 = f32(2.0) * (f32(1.0) - c * c) * self.a1
            self.b2 = (f32(1.0) - c + c * c) * self.a1
        self.ih = [np.float32(0.0), np.float32(0.0)]
        self.oh = [np.float32(0.0), np.float32(0.0)]

    def process(self, w: np.ndarray) -> np.ndarray:
        """Filter the W channel [T] -> LFE signal [T] (pre output scale)."""
        out = np.empty_like(w, dtype=np.float32)
        a1, a2, a3, b1, b2 = self.a1, self.a2, self.a3, self.b1, self.b2
        ih0, ih1 = self.ih
        oh0, oh1 = self.oh
        for j in range(len(w)):
            x = np.float32(w[j])
            y = a1 * x + a2 * ih0 + a3 * ih1 - b1 * oh0 - b2 * oh1
            ih1, ih0 = ih0, x
            oh1, oh0 = oh0, y
            out[j] = y
        self.ih = [ih0, ih1]
        self.oh = [oh0, oh1]
        return out
