"""Content kind ``pcm_loud``: a multitone bed with loud bursts (the
pattern of chip_smoke._loud_pcm, chip_smoke.py:585, at seeded phases and
positions), written as an LPCM stream (iamf_bits.build_pcm_layout_stream)
of the configuration's ``frame_size`` and ``sample_rate``.

Traffic keys: ``loud_share``, [least, most] share of a stream's frames in
bursts past full scale, spread evenly and dealt by the seed as the
lengths are; ``bursts`` a stream.
"""

from __future__ import annotations

import numpy as np

from harness import iamf_bits as ib
from harness.content import Stream, spread


def loud_pcm(cfg: dict, units: int, share: float, bursts: int,
             rng, device=None) -> np.ndarray:
    """[units * frame_size, channels] s16: the bed at content.bed_amp, and
    `bursts` bursts at content.burst_amp (clipped to s16) covering `share`
    of the frames, at seeded places that do not overlap. The tones are
    computed on `device` (a torch device, or None: NumPy)."""
    c = cfg["content"]
    nch = cfg["channels"]
    frame, rate = cfg["frame_size"], cfg["sample_rate"]
    pcm = ib.sine_pcm(units * frame, nch, rate, amp=c["bed_amp"],
                      seed=int(rng.randint(2**31)), device=device)
    loud = int(round(share * units))
    sizes = np.full(bursts, loud // bursts)
    sizes[:loud % bursts] += 1
    # the quiet frames, cut at seeded places into bursts + 1 gaps
    quiet = units - loud
    cuts = np.sort(rng.randint(0, quiet + 1, bursts))
    gaps = np.diff(np.concatenate([[0], cuts]))
    pos = 0
    tone = ib.sine_pcm(int(sizes.max()) * frame, nch, rate,
                       amp=c["burst_amp"], seed=int(rng.randint(2**31)),
                       device=device)
    tone = np.clip(tone, -32768, 32767)
    for gap, size in zip(gaps, sizes):
        pos += int(gap)
        pcm[pos * frame:(pos + size) * frame] = tone[:size * frame]
        pos += int(size)
    return pcm


def streams(cfg: dict, traffic: dict, units: list, rng, device) -> list:
    lo, hi = traffic["loud_share"]
    shares = rng.permutation(spread(lo, hi, len(units)))
    out = []
    for u, share in zip(units, shares):
        pcm = loud_pcm(cfg, u, share, traffic["bursts"], rng, device)
        data = ib.build_pcm_layout_stream(
            cfg["layout_code"], cfg["substreams"], cfg["coupled_substreams"],
            pcm, cfg["frame_size"], cfg["sample_rate"],
            cfg["headphones_rendering_mode"])
        out.append(Stream(data, u, cfg["frame_size"], cfg["sample_rate"],
                          source=pcm))
    return out
