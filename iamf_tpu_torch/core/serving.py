"""Multi-stream serving on PyTorch (counterpart of iamf_tpu/core/serving.py):
decode a fleet of IAMF streams in as few device steps as possible.

The reference decoder is single-stream (one IAMF_DecoderHandle per stream,
IAMF_decoder_decode one access unit at a time); serving N streams there
means N handles. Here the decode step takes a leading stream axis
(batch_decoder.fused_decode, core/pipeline.py), so a bucket of S streams
costs one launch of each kernel per frame batch, as the JAX server vmaps
its step: K3 (with K9) and K8 index the stream by a grid dimension, one
gain walk a stream; K1, K2 and K7 take the streams as S·L lanes; demix,
render and mix fold the streams into the frame axis.

Buckets: streams group by their step's key (PipelineConfig and synthesis
kinds), then by the shapes of their parameter tensors (a demix-matrix bank
may differ in size between otherwise equal streams). Within a bucket,
streams of different lengths are padded to the longest: neutral parameter
rows and the flush input (_HostPlan.flush_bufs) past a stream's end; the
extra outputs are dropped per stream, so every stream's kept batches see
exactly the inputs of its own decode. Correctness bar: each stream's
batches equal its own BatchedStreamDecoder(...).decode_all(fetch=False),
bit for bit on the CPU (tests/test_torch_serving.py).

Refused, as in the JAX server (ValueError): streams not at 48 kHz (their
resample tail runs per stream) and reconfigured streams.
"""

from __future__ import annotations

import torch

from ..utils import trace
from .batch_decoder import (BatchedStreamDecoder, _HostPlan, fused_decode,
                            plan_kinds, put_bufs)
from .pipeline import stack


def _shape_sig(tree) -> tuple:
    """Shapes and dtypes of a parameter tree's tensors past the stream
    axis, and of its shared HRIR banks: the last level of the bucket key,
    so that the [S, ...] stacks are rectangular."""
    if isinstance(tree, torch.Tensor):
        return ((tuple(tree.shape[1:]), str(tree.dtype)),)
    if isinstance(tree, dict):
        return sum((_shape_sig(tree[k]) for k in sorted(tree)), ())
    if isinstance(tree, (list, tuple)):
        return sum((_shape_sig(v) for v in tree), ())
    return ((tuple(tree.bank.shape), str(tree.bank.dtype)),)  # an Hrir


class MultiStreamServer:
    """Decode a fleet of complete IAMF streams together on `device` ('cuda'
    by default, raising where no card is visible; 'cpu' runs the twins).

    streams: in-memory IAMF byte streams. Decoder options (sound_system,
    batch_frames, ...) are shared. Streams may differ in length, codec and
    content: streams of one step share its launches, the rest form further
    buckets."""

    def __init__(self, streams, *, device="cuda", **kw):
        self.decs = [BatchedStreamDecoder(s, device=device, **kw)
                     for s in streams]
        for d in self.decs:
            if d.needs_resample:
                raise ValueError("rate-mismatch streams need the resample "
                                 "tail; serve them per stream")
            if d._next_data is not None:
                raise ValueError("mid-stream reconfigure streams are not "
                                 "servable in a bucket")
        # the step-level buckets; the parameter-shape level needs the
        # plans, so it happens in decode_all
        self._groups: dict = {}
        for i, d in enumerate(self.decs):
            self._groups.setdefault((d.cfg, plan_kinds(d)), []).append(i)

    @property
    def n_buckets(self) -> int:
        return len(self._groups)

    def decode_all(self) -> list:
        """Decode every stream; returns, in stream order, each stream's list
        of [B*T, out_channels] int batches on the device: the contract of
        BatchedStreamDecoder.decode_all(fetch=False)."""
        results: list = [None] * len(self.decs)
        for (cfg, kinds), idxs in self._groups.items():
            decs = [self.decs[i] for i in idxs]
            B = decs[0].batch_frames
            rows = (max(-(-d.n_frames // B) for d in decs) + 1) * B
            plans = []
            try:
                for d in decs:
                    plans.append(_HostPlan(d, rows=rows))
                sub: dict = {}
                for i, p in zip(idxs, plans):
                    sub.setdefault(_shape_sig(p.stream_params), []).append(
                        (i, p))
                for members in sub.values():
                    self._decode_bucket(cfg, kinds, members, results)
            finally:
                for p in plans:
                    p.close()
        return results

    def _decode_bucket(self, cfg, kinds, members, results):
        plans = [p for _, p in members]
        dec0 = plans[0].dec
        carry = stack([p.carry for p in plans])
        params = stack([p.stream_params for p in plans])
        # no call past the last kept one: flush calls' outputs are dropped
        calls = max(p.k0 + p.n_batches for p in plans)
        outs = []
        staging: dict = {}
        for _ in range(calls):
            # one host-to-device copy of each element's [S, B, ...] input
            bufs = put_bufs([p.next_bufs() or p.flush_bufs() for p in plans],
                            dec0.device, staging)
            carry, pcm = fused_decode(cfg, kinds, dec0.synths, carry, params,
                                      bufs)
            outs.append(pcm)  # [S, B*T, out]
        with trace.span("plan.sync"):
            if dec0.device.type == "cuda":
                torch.cuda.synchronize(dec0.device)
        for s, (i, p) in enumerate(members):
            results[i] = [o[s] for o in outs[p.k0:p.k0 + p.n_batches]]
