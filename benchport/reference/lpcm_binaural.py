"""The reference of the LPCM binaural configurations: LPCM / 32768, the
reorder, the M2B render, the limiter and s16 (iamf.binaural_stream), from
the source PCM the stream was written from."""

from __future__ import annotations

import numpy as np


def pcm(cfg: dict, stream, units: int | None = None, device="cuda",
        tf32: bool = False) -> np.ndarray:
    """The whole stream (the check of an LPCM stream asks for all of
    it)."""
    from . import iamf

    return iamf.binaural_stream(stream.source, cfg, device, tf32)
