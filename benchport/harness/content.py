"""The one generator of the benchmark's inputs: a configuration's streams
for a traffic mix, from the seed.

A traffic file sets the parameters; this module reads them:
- ``streams``: the fleet's size (1 for the serial player);
- ``units``: [least, most] temporal units a stream, or one number. A fleet
  takes the same set of lengths in every run, spread evenly over the
  range (stream i of S: least + (i + 1/2) (most - least) / S units), and
  the seed only deals them out, so every seed asks the same work;
- ``loud_share``: [least, most] share of a loud stream's frames in bursts
  past full scale, spread and dealt the same way; ``bursts`` a stream.
A configuration's ``content.kind`` says what a stream holds:
- ``opus_loop``: the configuration's Opus file looped from a first unit
  drawn from the seed (iamf_bits.loop_units);
- ``pcm_loud``: a multitone bed with loud bursts (the pattern of
  chip_smoke._loud_pcm, chip_smoke.py:585, at seeded phases and
  positions), written as an LPCM stream (iamf_bits.build_pcm_layout_stream).
"""

from __future__ import annotations

import os

import numpy as np

from . import iamf_bits as ib

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FRAME = 960


class Stream:
    """One generated stream: its bytes, its audio seconds (its samples
    past the trims), its temporal units, for LPCM the source PCM [samples,
    channels] in codec order, and what the check keeps of it."""

    def __init__(self, data: bytes, units: int, seconds: float,
                 source: np.ndarray | None = None):
        self.data = data
        self.units = units
        self.seconds = seconds
        self.source = source
        self.cache: dict = {}


def _spread(lo: float, hi: float, n: int) -> np.ndarray:
    return lo + (np.arange(n) + 0.5) * (hi - lo) / n


def lengths(traffic: dict, rng: np.random.RandomState) -> list:
    units = traffic["units"]
    if not isinstance(units, list):
        return [int(units)] * traffic["streams"]
    return [int(round(u)) for u in rng.permutation(
        _spread(units[0], units[1], traffic["streams"]))]


def _opus_stream(cfg: dict, units: int, rng) -> Stream:
    with open(os.path.join(ROOT, cfg["content"]["file"]), "rb") as f:
        sample = f.read()
    _, src = ib.split_into_units(sample)
    data = ib.loop_units(sample, units, int(rng.randint(len(src))))
    # known from how the loop is built: a walk over the looped stream's
    # OBUs would cost set-up in proportion to its length
    lead, tail = ib.loop_trims(sample)
    return Stream(data, units, (units * FRAME - lead - tail) / 48000.0)


def loud_pcm(cfg: dict, units: int, share: float, bursts: int,
             rng, device=None) -> np.ndarray:
    """[units * 960, channels] s16: the bed at content.bed_amp, and
    `bursts` bursts at content.burst_amp (clipped to s16) covering `share`
    of the frames, at seeded places that do not overlap. The tones are
    computed on `device` (a torch device, or None: NumPy)."""
    c = cfg["content"]
    nch = cfg["channels"]
    n = units * FRAME
    pcm = ib.sine_pcm(n, nch, amp=c["bed_amp"], seed=int(rng.randint(2**31)),
                      device=device)
    loud = int(round(share * units))
    sizes = np.full(bursts, loud // bursts)
    sizes[:loud % bursts] += 1
    # the quiet frames, cut at seeded places into bursts + 1 gaps
    quiet = units - loud
    cuts = np.sort(rng.randint(0, quiet + 1, bursts))
    gaps = np.diff(np.concatenate([[0], cuts]))
    pos = 0
    tone = ib.sine_pcm(int(sizes.max()) * FRAME, nch, amp=c["burst_amp"],
                       seed=int(rng.randint(2**31)), device=device)
    tone = np.clip(tone, -32768, 32767)
    for gap, size in zip(gaps, sizes):
        pos += int(gap)
        pcm[pos * FRAME:(pos + size) * FRAME] = tone[:size * FRAME]
        pos += int(size)
    return pcm


def _pcm_stream(cfg: dict, units: int, share: float, bursts: int,
                rng, device) -> Stream:
    pcm = loud_pcm(cfg, units, share, bursts, rng, device)
    data = ib.build_pcm_layout_stream(
        cfg["layout_code"], cfg["substreams"], cfg["coupled_substreams"],
        pcm, FRAME, cfg["sample_rate"], cfg["headphones_rendering_mode"])
    return Stream(data, units, units * FRAME / 48000.0, pcm)


def make(cfg: dict, traffic: dict, seed: int, device=None) -> list:
    """The traffic's streams for `seed` (a whole number, any size); tones
    are computed on `device` (a torch device, or None: NumPy)."""
    rng = np.random.RandomState(np.random.SeedSequence(
        seed % 2**64).generate_state(4))
    kind = cfg["content"]["kind"]
    units = lengths(traffic, rng)
    if kind == "opus_loop":
        return [_opus_stream(cfg, u, rng) for u in units]
    if kind == "pcm_loud":
        lo, hi = traffic["loud_share"]
        shares = rng.permutation(_spread(lo, hi, len(units)))
        return [_pcm_stream(cfg, u, s, traffic["bursts"], rng, device)
                for u, s in zip(units, shares)]
    raise ValueError(f"content kind {kind!r}")
