"""The reference of the Opus configurations: CELT synthesis, the reorder,
the render to the loudspeakers, the limiter and s16 (iamf.opus_stream).

It starts from the program's Opus entropy output, which the stream hands
over (``stream.stage``, the content kind's ``stage``), so that stage is
held by itself: ``entropy_gap``, the program's entropy output on the Opus
sample against a frozen copy of it.
"""

from __future__ import annotations

import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FROZEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "opus_sample_entropy.npz")


def pcm(cfg: dict, stream, units: int | None, device="cuda",
        tf32: bool = False) -> np.ndarray:
    """The stream's first `units` temporal units (all with None), its
    leading trim cut."""
    from . import iamf

    ent, info = stream.stage(units)
    return iamf.opus_stream(ent, info["lead"], 0, cfg, device, tf32)


def entropy_gap(cfg: dict, stage) -> float:
    """The program's entropy output on the configuration's Opus file
    against the frozen copy: the largest spectrum gap as a share of its
    frame and lane's peak; 1.0 where a flag, period or gain differs."""
    z = np.load(FROZEN)
    with open(os.path.join(ROOT, cfg["content"]["file"]), "rb") as f:
        ent, _ = stage(f.read())
    for k in z.files:
        if k == "freq":
            continue
        if ent[k].shape != z[k].shape or not np.array_equal(ent[k], z[k]):
            return 1.0
    peak = np.maximum(np.abs(z["freq"]).max(axis=2, keepdims=True), 1e-30)
    return float((np.abs(ent["freq"] - z["freq"]) / peak).max())


def numbers(cfg: dict, stage, tf32: bool = False) -> dict:
    """``entropy_gap``, with the float64 reference (the program's stage
    does not change with the reference's precision)."""
    return {} if tf32 else {"entropy_gap": entropy_gap(cfg, stage)}
