"""Content kind ``opus_loop``: the configuration's Opus file
(``content.file``) looped from a first unit drawn from the seed
(iamf_bits.loop_units). A unit is the configuration's ``frame_size``
samples at 48 kHz, the rate IAMF's Opus decodes at; a file whose codec
configuration says another frame size stops the run. The stream's trims
are the file's leading pre-skip and its end's.

The plain reference starts from the program's Opus entropy output
(harness/entropy.py): ``stage``.
"""

from __future__ import annotations

import os

from harness import entropy, iamf_bits as ib
from harness.content import ROOT, Stream

RATE = 48000


def stage(data: bytes, units: int | None = None):
    """(entropy output, parse) of the stream's first `units` units."""
    return entropy.opus_entropy(data, units)


def streams(cfg: dict, traffic: dict, units: list, rng, device) -> list:
    with open(os.path.join(ROOT, cfg["content"]["file"]), "rb") as f:
        sample = f.read()
    _, src = ib.split_into_units(sample)
    frame = cfg["frame_size"]
    if entropy.parse(sample, 1)["frame_size"] != frame:
        raise SystemExit(f"benchport: {cfg['content']['file']} is not of "
                         f"{frame}-sample frames (the configuration's "
                         "frame_size)")
    # known from how the loop is built: a walk over the looped stream's
    # OBUs would cost set-up in proportion to its length
    lead, tail = ib.loop_trims(sample)
    return [Stream(ib.loop_units(sample, u, int(rng.randint(len(src)))), u,
                   frame, RATE, trim=lead + tail, stage=stage)
            for u in units]
