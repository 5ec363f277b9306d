"""The one generator of the benchmark's inputs: a configuration's streams
for a traffic mix, from the seed.

A traffic file sets the parameters; this module reads those every kind
shares:
- ``streams``: the fleet's size (1 for the serial player);
- ``units``: [least, most] temporal units a stream, or one number. A fleet
  takes the same set of lengths in every run, spread evenly over the
  range (stream i of S: least + (i + 1/2) (most - least) / S units), and
  the seed only deals them out, so every seed asks the same work.
A configuration's ``content.kind`` says what a stream holds: it names
``benchport/content/<kind>.py`` under the run's root, which defines
``streams(cfg, traffic, units, rng, device) -> list[Stream]`` (one stream
a length, drawing from `rng` after the lengths) and reads the traffic's
other keys itself. Where the plain reference follows the program past a
stage, the kind also defines ``stage(data, units=None)``, the program's
output of that stage, which it hands to each Stream it makes.
"""

from __future__ import annotations

import os

import numpy as np

from reference import RATE

from . import manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Stream:
    """One generated stream: its bytes, its temporal units of `frame`
    samples at `rate` Hz, its audio seconds (its samples past `trim`, the
    trims at its start and end), the source PCM [samples, channels] in
    codec order where the kind wrote the stream from one, the program's
    `stage` for the reference (a function of the bytes and the units, or
    None), and what the check keeps of it."""

    def __init__(self, data: bytes, units: int, frame: int, rate: int,
                 trim: int = 0, source: np.ndarray | None = None,
                 stage=None):
        self.data = data
        self.units = units
        self.frame = frame
        self.rate = rate
        self.seconds = (units * frame - trim) / rate
        self.source = source
        self.program_stage = stage
        self.cache: dict = {}

    def stage(self, units: int | None = None):
        """The program's stage output over the first `units` units (all
        with None), kept for a second call."""
        if units not in self.cache:
            self.cache[units] = self.program_stage(self.data, units)
        return self.cache[units]


def spread(lo: float, hi: float, n: int) -> np.ndarray:
    return lo + (np.arange(n) + 0.5) * (hi - lo) / n


def lengths(traffic: dict, rng: np.random.RandomState) -> list:
    units = traffic["units"]
    if not isinstance(units, list):
        return [int(units)] * traffic["streams"]
    return [int(round(u)) for u in rng.permutation(
        spread(units[0], units[1], traffic["streams"]))]


def kind(cfg: dict, root: str = ROOT):
    """The configuration's content kind, found by name under `root`."""
    return manifest.load("content", cfg["content"]["kind"], root)


def make(cfg: dict, traffic: dict, seed: int, device=None,
         root: str = ROOT) -> list:
    """The traffic's streams for `seed` (a whole number, any size); tones
    are computed on `device` (a torch device, or None: NumPy). A stream
    at another rate than the reference's stops the run: the limiter's
    times and the check's delay are at RATE."""
    rng = np.random.RandomState(np.random.SeedSequence(
        seed % 2**64).generate_state(4))
    units = lengths(traffic, rng)
    streams = kind(cfg, root).streams(cfg, traffic, units, rng, device)
    for s in streams:
        if s.rate != RATE:
            raise SystemExit(f"benchport: a {cfg['content']['kind']} stream "
                             f"at {s.rate} Hz; the reference limiter and "
                             f"the check's delay are at {RATE} Hz")
    return streams
