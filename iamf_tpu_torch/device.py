"""Device handling. The entry points run on the card unless the caller
asks for the CPU by name: their device defaults to 'cuda', and a CUDA
request without a visible card raises.

A CUDA tensor goes to a hand-written kernel or the call raises; a CPU
tensor takes the kernel's plain PyTorch twin. There is no fallback from
one to the other.
"""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "iamf_tpu_torch: no CUDA device is visible "
            "(torch.cuda.is_available() is False); the hand-written kernels "
            "run only on an NVIDIA GPU (built for sm_90a)")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """torch.device for an explicit 'cpu' / 'cuda[:i]' request; a CUDA
    request without a card raises."""
    if device is None:
        raise ValueError("iamf_tpu_torch: pass device='cpu' or 'cuda'")
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"iamf_tpu_torch: unsupported device {dev}")
    return dev
