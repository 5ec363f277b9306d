"""iamf-tpu-torch: the IAMF batched decode path in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package (``iamf_tpu``) is the reference this package is held to;
its host layers that import no JAX (OBU parser, database, codecs, render
tables, the stream muxer) are imported as they are, and the ones that do are
carried here as JAX-free copies (core/stream.py, core/timeline.py,
core/presentation.py, dsp/demix.py, dsp/limiter.py, core/pipeline.py, and
the host parts of dsp/binaural.py and dsp/resample.py).

Precision policy: the reference evaluates every contraction at
``Precision.HIGHEST`` (iamf_tpu/__init__.py), so TF32 is switched off for
both matmuls and cuDNN here; bf16 is never used.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .device import require_cuda, resolve_device  # noqa: E402

__all__ = ["require_cuda", "resolve_device"]
