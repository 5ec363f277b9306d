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
- ``entropy_gap`` (Opus): the reference starts from the program's Opus
  entropy output (harness/entropy.py), so that stage is held by itself to
  a frozen copy of its output on the Opus sample's 16 units: the largest
  gap of a spectrum value, as a share of its frame and lane's peak, and
  any difference in the frames' flags, periods and gains.
Each number has its limit in the configuration's ``limits``.
"""

from __future__ import annotations

import os

import numpy as np

from . import entropy
from .content import ROOT

DELAY = 240
FROZEN = os.path.join(ROOT, "benchport", "reference",
                      "opus_sample_entropy.npz")


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


def reference_pcm(cfg: dict, stream, units: int | None = None,
                  device="cuda", tf32: bool = False) -> np.ndarray:
    """The reference's s16 output of one generated stream (its first
    `units` temporal units for the Opus configuration; the program's
    entropy output kept on the stream for a second call)."""
    from reference import iamf as ref

    if cfg["content"]["kind"] == "opus_loop":
        key = ("entropy", units)
        if key not in stream.cache:
            stream.cache[key] = entropy.opus_entropy(stream.data, units)
        ent, info = stream.cache[key]
        return ref.opus_stream(ent, info["lead"], 0, cfg, device, tf32)
    if cfg.get("binaural"):
        return ref.binaural_stream(stream.source, cfg, device, tf32)
    raise ValueError("no reference for this configuration")


def entropy_gap() -> float:
    """The program's entropy output on the Opus sample against the frozen
    copy: the largest spectrum gap as a share of its frame and lane's
    peak; 1.0 where a flag, period or gain differs."""
    z = np.load(FROZEN)
    with open(os.path.join(ROOT, "benchport", "data",
                           "sample_opus_714.iamf"), "rb") as f:
        ent, _ = entropy.opus_entropy(f.read())
    for k in entropy.KEYS:
        if ent[k].shape != z[k].shape or not np.array_equal(ent[k], z[k]):
            return 1.0
    peak = np.maximum(np.abs(z["freq"]).max(axis=2, keepdims=True), 1e-30)
    return float((np.abs(ent["freq"] - z["freq"]) / peak).max())


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


def fleet_numbers(cfg, traffic, win, seed, device, tf32=False) -> dict:
    gaps = []
    for i in sample_streams(win, traffic, seed):
        got = win.outputs[i]
        if got is None:
            return dict(BROKEN, samples=0)
        want = reference_pcm(cfg, win.fleet_streams[i], device=device,
                             tf32=tf32)
        gaps.append(_gaps(got[DELAY:], want, len(want) - DELAY))
    return _numbers(gaps)


def sharded_numbers(cfg, traffic, win, seed, device, tf32=False) -> dict:
    """The first request's PCM (decode_all(): the stream's samples)."""
    got = win.outputs[0]
    if got is None:
        return dict(BROKEN, samples=0)
    want = reference_pcm(cfg, win.fleet_streams[0], device=device,
                         tf32=tf32)
    return _numbers([_gaps(got, want, len(want))])


def serial_numbers(cfg, traffic, win, seed, device, tf32=False) -> dict:
    """Every sample of the kept calls (win.units: the warm-up's and the
    window's first drivers.CHECK_CALLS) against the reference's decode of
    those units and one more, parsed from the stream's start that far."""
    got = win.outputs
    if got is None:
        return dict(BROKEN, samples=0)
    # the calls' output covers their units but the limiter's look-ahead;
    # one unit more covers the whole
    want = reference_pcm(cfg, win.fleet_streams[0], win.units + 1,
                         device=device, tf32=tf32)
    return _numbers([_gaps(got, want, len(want) - 960 - DELAY)])


def numbers(cfg: dict, traffic: dict, win, seed: int, device: str = "cuda",
            tf32: bool = False) -> dict:
    """The compared numbers of a run (and the samples compared); the
    reference's products run on `device`."""
    fn = {"fleet": fleet_numbers, "sharded": sharded_numbers,
          "serial": serial_numbers}[traffic["mode"]]
    out = fn(cfg, traffic, win, seed, device, tf32)
    if cfg["content"]["kind"] == "opus_loop" and not tf32:
        out["entropy_gap"] = entropy_gap()
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
