"""Pipeline-parallel decode: the batched decode split in two stages over two
devices (counterpart of iamf_tpu/parallel/pp_decoder.py).

Stage A, on devices[0], is the host entropy (BatchedStreamDecoder's
worker) and the codec synthesis: K1 + K2 for Opus at any operating point
(n and hybrid passed, k frames regrouped into a unit row; SILK and mixed
streams come decoded from the host), K7 for AAC, with the synthesis
carries resident there. Stage B, on devices[1], is
core/pipeline.decode_frames (demix, render, mix, K3), with its carry
resident there. A batch's [B, C, T] activations cross by
``.to(dev_b, non_blocking=True)``, and the CUDA launch queues pipeline the
batches, as JAX's async dispatch does: while B limits batch t-1, A
synthesizes batch t. The stages are the batched decoder's own functions
split at the synthesis, so the output equals its decode bit for bit.

The flush calls past the stream's end synthesize the batched decoder's
neutral rows on stage A, as its own flush calls do (the JAX PP decoder
feeds stage B zero activations there instead).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.batch_decoder import (BatchedStreamDecoder, _HostPlan, put_bufs,
                                  synthesize_elements)
from ..core.pipeline import decode_frames, init_carry, stream_params
from ..device import require_cuda, resolve_device


class PipelinedStreamDecoder:
    """Two-stage pipelined decode of a complete in-memory IAMF stream.
    devices: the two stages' devices (default: the first two visible
    cards; two entries may name one card, or the CPU for the twins)."""

    def __init__(self, data: bytes, devices=None, sound_system: int = 0,
                 bits: int = 16, batch_frames: int = 128,
                 limiter: bool = True):
        if devices is None:
            require_cuda()
            devices = [torch.device("cuda", i)
                       for i in range(min(2, torch.cuda.device_count()))]
        if len(devices) < 2:
            raise ValueError("pipeline parallelism needs 2 devices")
        self.dev_a, self.dev_b = (resolve_device(d) for d in devices[:2])
        self.base = BatchedStreamDecoder(
            data, sound_system=sound_system, bits=bits,
            batch_frames=batch_frames, limiter=limiter, device=self.dev_a)
        if self.base.needs_resample:
            raise ValueError("use BatchedStreamDecoder for rate-mismatch "
                             "streams")

    def decode_all(self) -> np.ndarray:
        """[samples, out_channels] int PCM on the host, with
        BatchedStreamDecoder.decode_all's bookkeeping."""
        base = self.base
        cfg = base.cfg
        B, T = base.batch_frames, base.frame_size
        plan = _HostPlan(base)  # stage A: entropy worker, synthesis carries
        syn = plan.carry["syn"]
        # stage B: the whole stream's parameters and the pipeline carry
        params = stream_params(cfg, base.params, (plan.n_batches + 1) * B,
                               self.dev_b)
        pipe = init_carry(cfg, self.dev_b)
        cuda_b = self.dev_b.type == "cuda"
        rows = B * T
        full = torch.empty(
            ((plan.total_calls - plan.k0) * rows, cfg.out_channels),
            dtype=torch.int16 if cfg.bits == 16 else torch.int32,
            pin_memory=cuda_b)
        staging: dict = {}
        try:
            for call in range(plan.total_calls):
                bufs = put_bufs([plan.next_bufs() or plan.flush_bufs()],
                                self.dev_a, staging)
                xs, syn = synthesize_elements(plan.kinds, base.synths, syn,
                                              bufs)
                acts = [x.to(self.dev_b, non_blocking=True) for x in xs]
                pipe, out = decode_frames(cfg, pipe, params, acts)
                i = call - plan.k0
                if i >= 0:
                    full[i * rows:(i + 1) * rows].copy_(out[0],
                                                        non_blocking=cuda_b)
            if cuda_b:  # the last batch's copy to the host
                torch.cuda.synchronize(self.dev_b)
        finally:
            plan.close()
        return base.kept(full.numpy(), plan.want)
