"""Plain IAMF decodes of the benchmark's two configurations (AOM IAMF
v1.0.0 with libiamf's renderer, limiter and output stage), in float64
with the limiter's float32 gain recurrence.

Both configurations hold one single-layer channel-based 7.1.4 element,
so demixing only reorders the substreams' channels (codec order: the
coupled pairs, then the mono substreams) into the layout's order, and the
element and output mix gains are their defaults:
- ``opus_stream``: CELT synthesis (celt.py) of each lane, the reorder, the
  render to sound system J (4+7+0, the same loudspeakers as 7.1.4: the
  identity), the stream's leading trim (Opus pre-skip) cut before the
  limiter, then the limiter and s16;
- ``binaural_stream``: LPCM / 32768, the reorder, the M2B render (every
  loudspeaker channel convolved with its HRIR pair and summed per ear),
  then the limiter and s16.
The limiter's look-ahead past the stream's last sample sees what the
decoder emits there: the CELT synthesis's ringing into one more (silent)
frame, the convolution's tail.
``tf32=True`` rounds the operands of each product (the IMDCT, the HRIR
convolution) to TF32: the control.
"""

from __future__ import annotations

import numpy as np
import torch

from . import celt, hrir, limiter


def _gain(cfg: dict) -> float:
    return 10.0 ** ((cfg["element_gain_db"] + cfg["output_gain_db"]) / 20.0)


def _order(cfg: dict) -> list:
    codec = cfg["codec_channels"]
    return [codec.index(c) for c in cfg["output_channels"]]


def opus_stream(ent: dict, lead: int, tail: int, cfg: dict, device="cpu",
                tf32: bool = False) -> np.ndarray:
    """One Opus stream's s16 output [samples, channels] from its entropy
    output (celt.synthesize's input, lanes in codec order)."""
    F = len(ent["freq"])
    # one silent frame past the end: the decoder's ringing there feeds the
    # limiter's look-ahead over the last samples
    ent = {k: np.concatenate([v, np.zeros_like(v[:1])]) for k, v in
           ent.items()}
    for k in ("t_old", "t_cur", "t_new"):
        ent[k][-1] = celt.MINPERIOD
    lanes = celt.synthesize(ent, device, tf32)
    x = lanes[_order(cfg)] * _gain(cfg)
    want = F * celt.N - lead - tail
    return limiter.limit_s16(x[:, lead:], want)


def binaural_stream(pcm: np.ndarray, cfg: dict, device="cpu",
                    tf32: bool = False) -> np.ndarray:
    """One LPCM stream's binaural s16 output [samples, 2] from its source
    PCM [samples, channels] (s16 values, codec order)."""
    n = pcm.shape[0]
    x = torch.as_tensor(pcm.T[_order(cfg)], dtype=torch.float64,
                        device=device) / 32768.0
    dirs = cfg["hrir"]["directions"]
    bank = hrir.hrir_bank([dirs[c] for c in cfg["output_channels"]],
                          [c == "LFE" for c in cfg["output_channels"]],
                          cfg["hrir"]["taps"])
    h = torch.as_tensor(bank, dtype=torch.float64, device=device)
    if tf32:
        x, h = celt.to_tf32(x), celt.to_tf32(h)
    size = 1 << int(np.ceil(np.log2(n + h.shape[-1] - 1)))
    X = torch.fft.rfft(x, size)
    H = torch.fft.rfft(h, size)
    # the ears with the filters' tail past the stream's end
    ears = torch.fft.irfft(torch.einsum("ecf,cf->ef", H, X), size)
    ears = ears[:, :n + h.shape[-1] - 1].cpu().numpy() * _gain(cfg)
    return limiter.limit_s16(ears, n)
