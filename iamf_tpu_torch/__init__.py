"""iamf-tpu-torch: the IAMF batched decode path in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package (``iamf_tpu``) is the reference this package is held to
(by the tests, which import both); this package imports none of it. The
host layers it needs are carried here as copies: constants, the OBU parser
(obu/), core/database.py, the codec registry and host decoders (codecs/),
dsp/render.py and the host half of dsp/downmix.py, the muxer
(tools/builder.py), core/stream.py, core/timeline.py,
core/presentation.py, and the host parts of dsp/demix.py, dsp/limiter.py,
core/pipeline.py, dsp/binaural.py and dsp/resample.py.

Precision policy: the reference evaluates every contraction at
``Precision.HIGHEST`` (iamf_tpu/__init__.py), so TF32 is switched off for
both matmuls and cuDNN here; bf16 is never used.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .device import require_cuda, resolve_device  # noqa: E402

__all__ = ["require_cuda", "resolve_device"]
