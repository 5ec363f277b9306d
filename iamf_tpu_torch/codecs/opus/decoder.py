"""Host entropy export for the device CELT synthesis.

``iamf_tpu.codecs.opus.decoder.OpusDecoder`` (the ctypes wrapper over the
native CELT decoder) is reused as it is. Its ``decode_spectrum_batch``
imports the JAX synthesis module for three layout constants, so this
module carries a copy of that method that takes them from the port
(codecs/opus/synth.py) instead; the native calls are the same. The copy
covers the one operating point the port synthesises: CELT-960, one frame
per unit, not hybrid (others: ROADMAP.md §1 item 5).
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import os

import numpy as np

from iamf_tpu.codecs.opus.decoder import (
    _META_COL, SpectrumMeta, _gains_table, _load_native)

from .synth import FRAME, MINPERIOD, N_PARAMS


def decode_spectrum_batch(codec, frames) -> dict:
    """Entropy-decode a batch of CELT-960 temporal units to spectra
    (OpusDecoder.decode_spectrum_batch at n=960, k=1, not hybrid).

    frames: [B] lists of per-substream packets. Returns a dict whose
    ``buf`` is the [B, L, 960+13] float32 buffer with the spectra in place
    (the caller packs the 13 per-frame parameters into columns [960:973]
    with synth.pack_params), plus the parameter arrays."""
    lib = _load_native()
    gains_tab = _gains_table()
    R = B = len(frames)
    decoders = codec._decoders
    L = sum(ch for _, ch in decoders)
    buf = np.zeros((R, L, FRAME + N_PARAMS), np.float32)
    transient = np.zeros((R, L), bool)
    t_old = np.full((R, L), MINPERIOD, np.int32)
    t_cur = np.full((R, L), MINPERIOD, np.int32)
    t_new = np.full((R, L), MINPERIOD, np.int32)
    g_old = np.zeros((R, L, 3), np.float32)
    g_cur = np.zeros((R, L, 3), np.float32)
    g_new = np.zeros((R, L, 3), np.float32)
    lanes = np.cumsum([0] + [ch for _, ch in decoders])
    W = buf.shape[2]

    def run_substream(i):
        # one GIL-free native stretch per substream over all B packets;
        # the spectra land straight in this substream's lane rows of buf
        ptr, _ch = decoders[i]
        pkts = [frames[b][i] for b in range(B)]
        if any(p is None for p in pkts):
            raise ValueError("missing opus sub packet")
        blob = b"".join(bytes(p) for p in pkts)
        sizes = np.array([len(p) for p in pkts], np.int32)
        metas = (SpectrumMeta * R)()
        fbase = int(buf.ctypes.data + 4 * int(lanes[i]) * W)
        # k = 1 frame per unit; no SILK base (not hybrid)
        r = lib.iamf_opus_decode_spectrum_batch3(
            ptr, blob, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            B, 1, L * W, W, fbase, None, metas)
        if r < 0:
            raise ValueError(
                f"opus spectrum decode failed ({r}) at batch packet "
                f"{metas[0].samples} of substream {i}")
        sl = slice(lanes[i], lanes[i + 1])
        m = np.frombuffer(memoryview(metas), dtype=np.int32).reshape(
            R, len(SpectrumMeta._fields_))
        mf = m.view(np.float32)
        c = _META_COL
        transient[:, sl] = (m[:, c["transient"]] != 0)[:, None]
        t_old[:, sl] = np.maximum(m[:, c["pf_period_old"]], MINPERIOD)[:, None]
        t_cur[:, sl] = np.maximum(m[:, c["pf_period"]], MINPERIOD)[:, None]
        t_new[:, sl] = np.maximum(m[:, c["pf_period_new"]], MINPERIOD)[:, None]
        g_old[:, sl] = (mf[:, c["pf_gain_old"], None]
                        * gains_tab[m[:, c["pf_tapset_old"]]])[:, None, :]
        g_cur[:, sl] = (mf[:, c["pf_gain"], None]
                        * gains_tab[m[:, c["pf_tapset"]]])[:, None, :]
        g_new[:, sl] = (mf[:, c["pf_gain_new"], None]
                        * gains_tab[m[:, c["pf_tapset_new"]]])[:, None, :]

    if len(decoders) > 1 and B > 1:
        # substream codec states are independent: one host thread each
        if getattr(codec, "_pool", None) is None:
            codec._pool = cf.ThreadPoolExecutor(
                min(len(decoders), os.cpu_count() or 2))
        list(codec._pool.map(run_substream, range(len(decoders))))
    else:
        for i in range(len(decoders)):
            run_substream(i)
    return dict(buf=buf, transient=transient,
                t_old=t_old, t_cur=t_cur, t_new=t_new,
                g_old=g_old, g_cur=g_cur, g_new=g_new)
