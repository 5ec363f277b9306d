"""Whether what the timed path produced is correct.

After the window closes (and the device's peak memory is read), the plain
reference (benchport/reference/, which imports nothing of the program)
decodes the same inputs and the program's PCM is held to it:
- the samples compared: in a fleet, those of the fleet kept by the
  window (drawn from the seed) and, of its streams, the longest and
  ``CHECK_STREAMS`` - 1 more drawn from the seed, each over the samples
  its decode_all() returns (the limiter's drained tail is not among
  them); in the sharded cell, the first request's whole stream; in the
  serial cell, every sample the decoder returned in its warm-up's calls
  and the window's first drivers.CHECK_CALLS calls (the reference is a
  recurrence from the stream's start, so a later call costs it every
  unit before it: the cap keeps its work from growing with the calls a
  window makes). An output shorter than that is broken;
- ``max_gap_lsb``: the widest gap, in s16 steps, between a sample the
  program output and the reference's;
- ``share_over_1lsb``: the share of the samples whose gap is over one s16
  step. Where the limiter engages, its retrigger test (peak x gain over
  the threshold) meets near-ties that a float32 rounding of its input
  decides either way, and a decision taken the other way moves some
  hundreds of samples by up to ~20 steps; the widest gap then swings from
  seed to seed as far as the control's, and the share does not;
- what the configuration's reference adds (its ``numbers``), such as
  the check of a program stage that the reference starts from.
The reference is the module that the configuration's ``reference`` names
(reference/__init__.py says what it defines), found under the run's root.
Each number has its limit in the configuration's ``limits``.
"""

from __future__ import annotations

import numpy as np

from reference import DELAY

from . import content, manifest
from .content import ROOT

BROKEN = {"max_gap_lsb": 1 << 30, "share_over_1lsb": 1.0}
CHECK_STREAMS = 3


def _gaps(got: np.ndarray, want: np.ndarray,
          need: int) -> np.ndarray | None:
    """|got - want| in s16 steps over their common samples (None where
    they have fewer than `need` or differ in channels)."""
    n = min(len(got), len(want))
    if n == 0 or n < need or got.shape[1:] != want.shape[1:]:
        return None
    return np.abs(got[:n].astype(np.int64) - want[:n].astype(np.int64))


def _numbers(gaps: list) -> dict:
    if any(g is None for g in gaps):
        return dict(BROKEN, samples=0)
    samples = sum(g.size for g in gaps)
    return {"max_gap_lsb": int(max(g.max() for g in gaps)),
            "share_over_1lsb": sum(int((g > 1).sum()) for g in gaps)
            / samples,
            "samples": samples}


def reference(cfg: dict, root: str = ROOT):
    """The configuration's plain reference, found by name under `root`."""
    return manifest.load("reference", cfg["reference"], root)


def reference_pcm(cfg: dict, stream, units: int | None = None,
                  device="cuda", tf32: bool = False,
                  root: str = ROOT) -> np.ndarray:
    """The reference's s16 output of one generated stream (its first
    `units` temporal units where the check asks for fewer than all)."""
    return reference(cfg, root).pcm(cfg, stream, units, device, tf32)


def sample_streams(win, traffic: dict, seed: int) -> list:
    """Indices of the kept fleet's streams to compare: the longest, then
    others drawn from the seed."""
    outs = win.outputs
    n = len(outs)
    k = min(n, CHECK_STREAMS)
    longest = max(range(n), key=lambda i: win.fleet_streams[i].units)
    rest = [i for i in np.random.RandomState(seed % 2**32).permutation(n)
            if i != longest]
    return [longest] + [int(i) for i in rest[:k - 1]]


def fleet_numbers(cfg, traffic, win, seed, device, tf32=False,
                  root=ROOT) -> dict:
    gaps = []
    for i in sample_streams(win, traffic, seed):
        got = win.outputs[i]
        if got is None:
            return dict(BROKEN, samples=0)
        want = reference_pcm(cfg, win.fleet_streams[i], device=device,
                             tf32=tf32, root=root)
        gaps.append(_gaps(got[DELAY:], want, len(want) - DELAY))
    return _numbers(gaps)


def sharded_numbers(cfg, traffic, win, seed, device, tf32=False,
                    root=ROOT) -> dict:
    """The first request's PCM (decode_all(): the stream's samples)."""
    got = win.outputs[0]
    if got is None:
        return dict(BROKEN, samples=0)
    want = reference_pcm(cfg, win.fleet_streams[0], device=device,
                         tf32=tf32, root=root)
    return _numbers([_gaps(got, want, len(want))])


def serial_numbers(cfg, traffic, win, seed, device, tf32=False,
                   root=ROOT) -> dict:
    """Every sample of the kept calls (win.units: the warm-up's and the
    window's first drivers.CHECK_CALLS) against the reference's decode of
    those units and one more, parsed from the stream's start that far."""
    got = win.outputs
    if got is None:
        return dict(BROKEN, samples=0)
    # the calls' output covers their units but the limiter's look-ahead;
    # one unit more covers the whole
    stream = win.fleet_streams[0]
    want = reference_pcm(cfg, stream, win.units + 1, device=device,
                         tf32=tf32, root=root)
    return _numbers([_gaps(got, want, len(want) - stream.frame - DELAY)])


def output_numbers(cfg: dict, traffic: dict, win, seed: int,
                   device: str = "cuda", tf32: bool = False,
                   root: str = ROOT) -> dict:
    """The numbers of the window's outputs against the reference (and the
    samples compared); the reference's products run on `device`."""
    fn = {"fleet": fleet_numbers, "sharded": sharded_numbers,
          "serial": serial_numbers}[traffic["mode"]]
    return fn(cfg, traffic, win, seed, device, tf32, root)


def numbers(cfg: dict, traffic: dict, win, seed: int, device: str = "cuda",
            tf32: bool = False, root: str = ROOT) -> dict:
    """The compared numbers of a run: output_numbers and the reference's
    own ``numbers``, where it has them."""
    out = output_numbers(cfg, traffic, win, seed, device, tf32, root)
    ref = reference(cfg, root)
    if hasattr(ref, "numbers"):
        stage = getattr(content.kind(cfg, root), "stage", None)
        out.update(ref.numbers(cfg, stage, tf32))
    return out


def verdict(cfg: dict, nums: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) for the numbers that have
    limits."""
    shown = {}
    ok = True
    for name, limit in cfg["limits"].items():
        if name not in nums:
            continue
        v = nums[name]
        shown[name] = {"value": v, "limit": limit}
        ok = ok and limit is not None and v <= limit
    return ok, shown
