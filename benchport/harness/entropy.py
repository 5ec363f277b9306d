"""The Opus entropy output that the reference synthesis starts from.

The reference decodes everything after the Opus entropy decode (the range
decoder, energies, PVQ and the post-filter parameters: the native CELT
decoder's work). It takes that stage's output from the program: a fresh
``iamf_tpu_torch.codecs.opus.decoder.OpusDecoder`` of the stream's codec
configuration, run through ``decode_spectrum_batch``, the export the
batched decoders feed their synthesis from. The stage itself is held to a
frozen copy of its output on the Opus sample
(``reference/opus_celt.entropy_gap``, which the content kind
``opus_loop`` hands this stage as its ``stage``).
"""

from __future__ import annotations

import numpy as np

from . import iamf_bits as ib

KEYS = ("transient", "t_old", "t_cur", "t_new", "g_old", "g_cur", "g_new")


def parse(stream: bytes, units: int | None = None) -> dict:
    """The stream's Opus decoder_conf, substream counts, each substream's
    packets and its trims at start and at end (as iamf_bits.trims sums
    them), over its first `units` temporal units: the walk stops there,
    so its cost is that of the units read, not of the stream."""
    pos = ib.find_sequence_header(stream)
    info = {"packets": {}, "lead": 0, "tail": 0}
    while pos < len(stream):
        obu = ib.split_obu(stream, pos)
        pos += obu.size
        p = obu.payload
        if obu.type == ib.OBU_CODEC_CONFIG:
            _, q = ib._leb128(p, 0)
            q += 4  # codec 4cc
            info["frame_size"], q = ib._leb128(p, q)
            info["decoder_conf"] = bytes(p[q + 2:])
        elif obu.type == ib.OBU_AUDIO_ELEMENT:
            info["substreams"] = ib.audio_element_substreams(p)
            info["coupled"] = p[-1]  # one layer: nb_coupled is its last byte
        elif ib.OBU_AUDIO_FRAME_ID0 <= obu.type <= ib.OBU_AUDIO_FRAME_ID17:
            sid = obu.type - ib.OBU_AUDIO_FRAME_ID0
            pk = info["packets"]
            pk.setdefault(sid, []).append(p)
            if sid == 0:
                info["lead"] += obu.trim_start
                info["tail"] += obu.trim_end
            if (units is not None and len(pk) == info["substreams"]
                    and min(len(v) for v in pk.values()) >= units):
                break
    return info


def opus_entropy(stream: bytes, units: int | None = None,
                 batch: int = 256) -> tuple[dict, dict]:
    """(entropy output of the stream's first `units` temporal units as
    arrays [F, L, ...]: freq and KEYS; the parse of those units)."""
    from iamf_tpu_torch.codecs.opus.decoder import (OpusDecoder,
                                                    decode_spectrum_batch)

    info = parse(stream, units)
    n = info["frame_size"]
    pk = info["packets"]
    total = min(len(v) for v in pk.values())
    units = total if units is None else min(units, total)
    dec = OpusDecoder(info["decoder_conf"], info["substreams"],
                      info["coupled"], n)
    parts = []
    for u0 in range(0, units, batch):
        frames = [[pk[s][u] for s in range(info["substreams"])]
                  for u in range(u0, min(u0 + batch, units))]
        d = decode_spectrum_batch(dec, frames, n=n)
        parts.append({"freq": d["buf"][..., :n].copy(),
                      **{k: d[k] for k in KEYS}})
    ent = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return ent, info
