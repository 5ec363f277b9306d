"""Output quantization + interleave (counterpart of iamf_tpu/dsp/quantize.py;
reference: iamf_decoder_plane2stride_out, IAMF_decoder.c:121-167).

Scale by 2^(bits-1), clamp to the integer range, round half to even
(lrintf; torch.round matches), interleave planar [C, T] to [T, C]; a
stride above C zero-pads the columns (the SAMSUNG_TV 12-channel output
mode). Plain PyTorch: on the limited main path the same arithmetic is K3's
epilogue (csrc/limiter.cu); this function serves the limiter-free path
and the limiter's plain twin.
"""

from __future__ import annotations

import torch


def quantize_interleave(x, bits: int, stride: int = 0):
    """x: [..., C, T] float32 -> [..., T, stride or C] int16 (bits=16) or
    int32 (24/32)."""
    scale = float(2 ** (bits - 1))
    lo = -(2 ** (bits - 1))
    hi = 2 ** (bits - 1) - 1
    v = x.to(torch.float32) * scale
    # clamp-then-round == round-then-clip for these bounds
    v = torch.clamp(v, lo, hi)
    if not v.is_cuda:
        # |v| < 1/2 rounds to 0 either way; zeroing it first keeps
        # denormals (codec tails) off the CPU's slow rounding path
        v = torch.where(v.abs() < 0.5, 0.0, v)
    v = torch.round(v)
    if bits == 32:
        # float32 rounds 2^31 - 1 up to 2^31: saturate in float64, as the
        # reference's conversion (and the card's) does
        v = torch.clamp(v.to(torch.float64), lo, hi)
    dtype = torch.int16 if bits == 16 else torch.int32
    return pad_stride(v.to(dtype).transpose(-1, -2).contiguous(), stride)


def pad_stride(pcm, stride: int):
    """Interleaved [..., T, C] -> [..., T, stride], zero columns past C
    (stride 0 or C: unchanged)."""
    C = pcm.shape[-1]
    if stride > C:
        pcm = torch.nn.functional.pad(pcm, (0, stride - C))
    return pcm


def dequantize_planar(pcm, bits: int):
    """Interleaved int [..., T, C] -> planar float32 [..., C, T], scale
    2^-(bits-1)."""
    scale = float(2.0 ** -(bits - 1))
    return pcm.transpose(-1, -2).to(torch.float32) * scale
