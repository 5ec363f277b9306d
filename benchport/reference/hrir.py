"""The binaural renderer's head-related impulse responses, frozen.

A copy of iamf_tpu_torch/dsp/binaural.py:81 (spherical_head_hrir) and :145
(hrir_bank): a parametric spherical-head model per loudspeaker direction
(Woodworth delay as a windowed fractional-delay sinc, a one-pole head
shadow, a pinna reflection), and an omnidirectional half-level impulse at
sample 16 for the LFE. The directions are the configuration's.
"""

from __future__ import annotations

import math

import numpy as np

SPEED_OF_SOUND = 343.0
HEAD_RADIUS = 0.0875  # m


def spherical_head_hrir(azimuth_deg: float, elevation_deg: float,
                        taps: int = 256, rate: int = 48000) -> np.ndarray:
    """[2, taps] HRIR pair (left ear first), float32."""
    az = math.radians(azimuth_deg)
    el = math.radians(elevation_deg)
    out = np.zeros((2, taps), dtype=np.float64)
    base_delay = 16
    for ear, sign in ((0, 1.0), (1, -1.0)):
        x = math.sin(az * sign) * math.cos(el)
        inc = math.acos(max(-1.0, min(1.0, x)))
        if inc <= math.pi / 2:
            dt = -HEAD_RADIUS / SPEED_OF_SOUND * math.cos(inc)
        else:
            dt = HEAD_RADIUS / SPEED_OF_SOUND * (inc - math.pi / 2)
        delay = base_delay + dt * rate + HEAD_RADIUS / SPEED_OF_SOUND * rate
        n = np.arange(taps)
        sinc = np.sinc(n - delay)
        half_w = 32.0
        win = np.where(np.abs(n - delay) < half_w,
                       0.5 * (1.0 + np.cos(np.pi * (n - delay) / half_w)),
                       0.0)
        h = sinc * win
        shadow = 0.5 * (1.0 + math.cos(inc))
        fc = 1500.0 + 18000.0 * shadow
        a = math.exp(-2.0 * math.pi * fc / rate)
        g = 1.0 - a
        y = np.zeros(taps)
        state = 0.0
        for i in range(taps):
            state = g * h[i] + a * state
            y[i] = state
        y *= 0.7 + 0.3 * shadow
        refl_delay = int(round((6.0 - 3.0 * math.sin(el)) * rate / 48000.0))
        refl = np.zeros(taps)
        if refl_delay + 1 < taps:
            refl[refl_delay] = -0.25 * (1.0 - 0.5 * math.sin(el))
        y = y + np.convolve(y, refl)[:taps]
        out[ear] = y
    return out.astype(np.float32)


def hrir_bank(directions: list, lfe: list, taps: int = 256,
              rate: int = 48000) -> np.ndarray:
    """[2, channels, taps] for the channels' (azimuth, elevation) in
    rendering order; lfe[i] marks the LFE channel."""
    bank = np.stack([spherical_head_hrir(az, el, taps, rate)
                     for az, el in directions], axis=1)
    for i, is_lfe in enumerate(lfe):
        if is_lfe:
            bank[:, i] = 0.0
            bank[:, i, 16] = 0.5
    return bank
