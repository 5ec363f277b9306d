"""Output quantization + interleave (counterpart of iamf_tpu/dsp/quantize.py;
reference: iamf_decoder_plane2stride_out, IAMF_decoder.c:121-167).

Scale by 2^(bits-1), clamp to the integer range, round half to even
(lrintf; torch.round matches), interleave planar [C, T] to [T, C].
Plain PyTorch: on the limited main path the same arithmetic is K3's
epilogue (csrc/limiter.cu); this function serves the limiter-free path
and the limiter's plain twin.
"""

from __future__ import annotations

import torch


def quantize_interleave(x, bits: int):
    """x: [..., C, T] float32 -> [..., T, C] int16 (bits=16) or int32
    (24/32)."""
    scale = float(2 ** (bits - 1))
    lo = -(2 ** (bits - 1))
    hi = 2 ** (bits - 1) - 1
    v = x.to(torch.float32) * scale
    # clamp-then-round == round-then-clip for these bounds
    v = torch.round(torch.clamp(v, lo, hi))
    dtype = torch.int16 if bits == 16 else torch.int32
    return v.to(dtype).transpose(-1, -2).contiguous()
