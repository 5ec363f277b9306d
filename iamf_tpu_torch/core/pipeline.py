"""Batched decode pipeline in PyTorch (counterpart of iamf_tpu/core/pipeline.py).

One call decodes a batch of B = cfg.batch_frames frames of S streams that
share one PipelineConfig: every input, parameter and carry tensor has a
leading stream axis [S, ...]. One decoder is the S = 1 case; the
multi-stream server (core/serving.py) stacks a bucket of streams, as the
JAX server vmaps this step (iamf_tpu/core/serving.py:36-44). Demix, render
and mix fold the streams into the frame axis; K8 and K3 (with K9) take
the stream axis in one launch each.

    per element:  demix chains (dsp/demix.py, elementwise, batched over B)
                  -> render matmul (per-frame matrices, offset-split blend)
                  -> element mix gain
    binaural:     an element with hrtf_taps > 0 renders its virtual-speaker
                  bed, and K8 (dsp/binaural.py) folds the bed over the whole
                  batch timeline to two ears, with an overlap carry; its
                  gain applies after the convolution (render -> binaural ->
                  gain, as the serial path orders them)
    mix:          sum over elements, then the output gain
    head trim:    pre-limiter splice of the stream's leading trimmed samples
    limiter:      + quantize/interleave: K3 on the card (dsp/limiter.py)
    emit_float:   (rate-mismatched streams) no limiter, no quantize: the
                  mixed float32 [B*T, out] goes to the resample tail
                  (core/batch_decoder.py)

Demix, render and mix are plain PyTorch for now (ROADMAP.md §2: a fused
kernel only if a profile on the card shows it matters). The limiter is the
only per-sample recurrence on this path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..dsp.binaural import Hrir, hrir_for_batch, hrtf_conv
from ..dsp.demix import DemixSpec, demix_frame, make_windows
from ..dsp.limiter import LimiterConfig, init_state, limit_quantize
from ..dsp.quantize import quantize_interleave

FACTOR_KEYS = ("alpha", "beta", "gamma", "delta", "dw")


@dataclasses.dataclass(frozen=True)
class ElementSpec:
    """Static config of one element in the pipeline."""

    demix: Optional[DemixSpec]  # None => passthrough (scene-based pre-mixed)
    n_in: int  # decoded channels entering the pipeline
    n_rendered: int  # channels after demix/reorder (render matrix rows input)
    render_offset: int = 0  # DMRenderer offset split position (codec delay)
    input_scale: float = 1.0  # applied when x arrives as integers
    skip: int = 0  # demix smoothing split (codec delay % frame_size):
    #   the first `skip` samples use the previous frame's factors
    #   (demixer_set_frame_offset, demixer.c:537-563)
    rg_index: tuple[int, ...] = ()  # recon-smoothed output-channel indices
    per_sample_gain: bool = False  # elem gain arrives [B, T] instead of [B]
    hrtf_taps: int = 0  # >0: binaural element: render_mat yields the
    #   virtual-speaker bed, folded to 2 ears by K8 (params['hrir'][i],
    #   carry['hrtf'][i])


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    frame_size: int
    out_channels: int
    bits: int
    elements: tuple[ElementSpec, ...]
    limiter: Optional[LimiterConfig]
    per_sample_out_gain: bool = False
    batch_frames: int = 128  # B: frames per decode_frames call
    head_trim: int = 0  # leading samples spliced out PRE-limiter
    #   (iamf_frame_trim, IAMF_decoder.c:1361-1381): trimmed samples never
    #   drive the limiter envelope. The splice delays output by one batch;
    #   callers discard the first call's output.
    emit_float: bool = False  # return the mixed float32 [B*T, out]: the
    #   rate-mismatch path resamples, normalizes, limits and quantizes it
    #   afterwards. Requires limiter=None.


def stream_params(cfg: PipelineConfig, tl, n_padded: int, device,
                  hrtf_banks=None) -> dict:
    """The replayed timeline (core/timeline.TimelineParams) of ONE stream as
    whole-stream tensors on `device`, put once per decode, each with a
    stream axis of 1 (``stack`` joins a bucket's). Each per-frame array is
    padded to n_padded frames with neutral values:
      factors:  list per element of [1, Np, 2, 5] float32 (prev/cur factors)
      rg:       list per element of [1, Np, n_rg, 3] float32
      mats:     list per element of [1, M, out, n_rendered] float32
      mat_idx:  list per element of [1, Np, 2] int64 (prev, cur) into mats
      elem_gain: list per element of [1, Np] (or [1, Np, T]) float32
      out_gain: [1, Np] (or [1, Np, T]) float32
      hrir:     {element index: binaural.Hrir} for binaural elements, from
                hrtf_banks[i] ([2, C_i, taps] numpy, None for the others):
                no stream axis, a bucket's streams share the bank"""

    def pad_frames(a, fill):
        if a.shape[0] >= n_padded:
            return a[:n_padded]
        tail = np.full((n_padded - a.shape[0],) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, tail])

    def put(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)[None]).to(
            device)

    params = {"factors": [], "rg": [], "mats": [], "mat_idx": [],
              "elem_gain": []}
    for ep in tl.elements:
        params["factors"].append(put(pad_frames(ep.factors, 1.0)))
        params["rg"].append(put(pad_frames(ep.rg, 0.0)))
        params["mats"].append(put(ep.mats))
        params["mat_idx"].append(put(pad_frames(ep.mat_idx, 0), np.int64))
        params["elem_gain"].append(
            put(pad_frames(ep.gain.astype(np.float32), 1.0)))
    params["out_gain"] = put(pad_frames(tl.out_gain.astype(np.float32), 1.0))
    params["hrir"] = {
        i: hrir_for_batch(bank, cfg.batch_frames, cfg.frame_size, device)
        for i, bank in enumerate(hrtf_banks or ()) if bank is not None}
    return params


def init_carry(cfg: PipelineConfig, device) -> dict:
    """One stream's carry, each tensor with a stream axis of 1 (``stack``
    joins a bucket's): {'pos': frame position (host int, shared by the
    streams), 'limiter': limiter state [1, ...], 'splice': [1, out, B*T]
    head-trim carry, 'hrtf': {element index: [1, 2, taps-1] overlap} for
    binaural elements}."""
    carry = {"pos": 0}
    if cfg.limiter is not None:
        carry["limiter"] = {k: v[None] for k, v in
                            init_state(cfg.limiter, device).items()}
    if cfg.head_trim:
        carry["splice"] = torch.zeros(
            (1, cfg.out_channels, cfg.batch_frames * cfg.frame_size),
            dtype=torch.float32, device=device)
    if any(es.hrtf_taps for es in cfg.elements):
        carry["hrtf"] = {
            i: torch.zeros((1, 2, es.hrtf_taps - 1), dtype=torch.float32,
                           device=device)
            for i, es in enumerate(cfg.elements) if es.hrtf_taps}
    return carry


def stack(trees: list):
    """Join per-stream trees (stream_params, init_carry, synthesis carries)
    along their stream axis: tensors concatenate, dicts, lists and tuples
    (NamedTuples too) map, a host int (the shared frame position) and the
    shared HRIRs must agree across the streams."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return torch.cat(trees)
    if isinstance(t0, dict):
        return {k: stack([t[k] for t in trees]) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(stack(list(v)) for v in zip(*trees)))
    if isinstance(t0, (list, tuple)):
        return type(t0)(stack(list(v)) for v in zip(*trees))
    if isinstance(t0, Hrir):
        if any(not torch.equal(t.bank, t0.bank) for t in trees):
            raise ValueError("streams of one bucket need one HRIR bank")
        return t0
    if any(t != t0 for t in trees):
        raise ValueError(f"streams disagree on {t0!r}")
    return t0


def _element_batch(cfg: PipelineConfig, i: int, x, fac, rg, m_prev, m_cur):
    """Demix + render for ONE element over the batch's R = S*B frames:
    [R, out, T] (the virtual-speaker bed [R, C_i, T] for a binaural
    element)."""
    es = cfg.elements[i]
    T = cfg.frame_size
    dev = x.device
    if x.dtype != torch.float32:
        x = x.to(torch.float32) * float(np.float32(es.input_scale))
    if es.demix is not None:
        if es.skip:
            # the first `skip` samples use the previous frame's factors
            mask = (torch.arange(T, device=dev) < es.skip).to(torch.float32)
            factors_t = {
                k: fac[:, 0, j, None] * mask + fac[:, 1, j, None] * (1.0 - mask)
                for j, k in enumerate(FACTOR_KEYS)
            }
        else:
            factors_t = {k: fac[:, 1, j, None]
                         for j, k in enumerate(FACTOR_KEYS)}
        if es.rg_index:
            start_w, stop_w = (torch.from_numpy(w).to(dev)
                               for w in make_windows(T, es.skip))
            filt = (rg[:, :, 0:1] * stop_w[None, None]
                    + rg[:, :, 1:2] * start_w[None, None])
            # inactive rows (flags changed mid-stream) pass through
            filt = rg[:, :, 2:3] * filt + (1.0 - rg[:, :, 2:3])
        else:
            filt = None
        y = demix_frame(x, es.demix, factors_t, es.rg_index, filt)
    else:
        y = x
    # render: blend previous/current matrices across the offset split
    r = torch.matmul(m_cur, y)
    if es.render_offset:
        r_prev = torch.matmul(m_prev, y)
        mask = (torch.arange(T, device=dev) < es.render_offset).to(
            torch.float32)
        r = r_prev * mask + r * (1.0 - mask)
    return r


def window_params(params: dict, lo: int, count: int, device) -> dict:
    """Frames [lo, lo + count) of ``stream_params``' tensors (padded past
    the stream's end with its neutral rows) on `device`, the stream axis of
    1 kept: one shard's timeline (parallel/sharded_decoder.py). The
    matrices are whole."""
    def rows(a):
        return a[:, lo:lo + count].to(device)

    out = {k: [rows(a) for a in params[k]]
           for k in ("factors", "rg", "mat_idx", "elem_gain")}
    out["mats"] = [m.to(device) for m in params["mats"]]
    out["out_gain"] = rows(params["out_gain"])
    return out


def element_mix(cfg: PipelineConfig, i: int, params: dict, x):
    """Element i's demixed, rendered and gained frames [F, out, T] from its
    input x [F, C_in, T] and a ``window_params`` window of F frames (the
    counterpart of _element_frame and its gain in iamf_tpu/core/
    pipeline.py:146, :196). Loudspeaker elements only: the sharded decoders
    render no binaural output."""
    es = cfg.elements[i]
    if es.hrtf_taps:
        raise NotImplementedError("element_mix: binaural elements run in "
                                  "decode_frames only")
    mi = params["mat_idx"][i][0]
    mats = params["mats"][i][0]
    r = _element_batch(cfg, i, x, params["factors"][i][0],
                       params["rg"][i][0], mats[mi[:, 0]], mats[mi[:, 1]])
    g = params["elem_gain"][i][0]
    return r * g[:, None, :] if es.per_sample_gain else r * g[:, None, None]


def out_mix(cfg: PipelineConfig, params: dict, mixed):
    """The output gain over the summed elements [F, out, T] of a
    ``window_params`` window -> the shard's mixed timeline [out, F*T]."""
    og = params["out_gain"][0]
    mixed = (mixed * og[:, None, :] if cfg.per_sample_out_gain
             else mixed * og[:, None, None])
    return mixed.transpose(0, 1).reshape(cfg.out_channels, -1)


def shard_mix(cfg: PipelineConfig, params: dict, xs: list):
    """One shard's mix over its F frames: every element's ``element_mix``
    summed in element order, then the output gain (decode_frames' order).
    xs: per element [F, C_in, T]. Returns [out, F*T]."""
    mixed = None
    for i, x in enumerate(xs):
        r = element_mix(cfg, i, params, x)
        mixed = r if mixed is None else mixed + r
    return out_mix(cfg, params, mixed)


def decode_frames(cfg: PipelineConfig, carry: dict, params: dict, xs: list):
    """Decode one batch of B = cfg.batch_frames frames of S streams.

    params: whole-stream tensors from ``stream_params`` (``stack`` of a
    bucket's); the batch window is sliced at the carry's frame position.
    xs: list per element of this batch's [S, B, C_in, T] samples (int
    dtypes are scaled by ElementSpec.input_scale). Returns (carry, pcm int
    [S, B*T, out_channels]), or with cfg.emit_float the float32 mix
    [S, B*T, out_channels]; pos advances by B."""
    B = cfg.batch_frames
    T = cfg.frame_size
    C = cfg.out_channels
    S = xs[0].shape[0]
    pos = carry["pos"]

    def sl(a):  # this batch's rows, the streams folded into the frames
        a = a[:, pos:pos + B]
        return a.reshape((S * B,) + a.shape[2:])

    rows = torch.arange(S * B, device=xs[0].device) // B  # each row's stream
    mixed = None
    hrtf = dict(carry.get("hrtf", {}))
    for i, es in enumerate(cfg.elements):
        mat_idx = sl(params["mat_idx"][i])
        mats = params["mats"][i]
        x = xs[i].reshape((S * B,) + xs[i].shape[2:])
        r = _element_batch(cfg, i, x, sl(params["factors"][i]),
                           sl(params["rg"][i]), mats[rows, mat_idx[:, 0]],
                           mats[rows, mat_idx[:, 1]])
        if es.hrtf_taps:
            # each stream's bed over the batch timeline [S, C_i, B*T] ->
            # 2 ears
            bed = r.reshape(S, B, -1, T).transpose(1, 2).reshape(
                S, -1, B * T)
            ears, hrtf[i] = hrtf_conv(params["hrir"][i], bed, hrtf[i])
            r = ears.reshape(S, 2, B, T).transpose(1, 2).reshape(
                S * B, 2, T)
        g = sl(params["elem_gain"][i])
        r = r * g[:, None, :] if es.per_sample_gain else r * g[:, None, None]
        mixed = r if mixed is None else mixed + r
    og = sl(params["out_gain"])
    mixed = (mixed * og[:, None, :] if cfg.per_sample_out_gain
             else mixed * og[:, None, None])
    carry = dict(carry, pos=pos + B)
    if hrtf:
        carry["hrtf"] = hrtf

    flat = mixed.reshape(S, B, C, T).transpose(1, 2).reshape(S, C, B * T)
    if cfg.head_trim:
        # pre-limiter trim splice: delete the stream's leading trimmed
        # samples from the mixed timeline, at a one-batch output latency
        seq = torch.cat([carry["splice"], flat], dim=2)
        carry = dict(carry, splice=flat)
        flat = seq[..., cfg.head_trim:cfg.head_trim + B * T]

    if cfg.emit_float:
        return carry, flat.transpose(1, 2)
    if cfg.limiter is not None:
        lim_state, pcm = limit_quantize(cfg.limiter, carry["limiter"], flat,
                                        cfg.bits, T)
        return dict(carry, limiter=lim_state), pcm
    return carry, quantize_interleave(flat, cfg.bits)
