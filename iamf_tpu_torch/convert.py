"""State carried across from the JAX package: its stream parameters and
carries, taken as numpy arrays, turned into this package's tensors on a
given device, so both packages can start a batch from identical state.

- ``stream_params``: the dict from iamf_tpu.core.pipeline.put_stream_params
  (with the HRIR spectra ``hrtf_H`` that the JAX decoder's _HostPlan adds)
- ``pipe_carry``: iamf_tpu.core.pipeline.init_carry / decode_frames carry
  (limiter state, ``splice``, ``pos``, the binaural overlap ``hrtf``)
- ``plan_carry``: the JAX _HostPlan.carry, {"pipe": ..., "syn": [...]}
- ``synth_carry``: iamf_tpu.codecs.opus.tpu_synth.SynthCarry
- ``aac_carry``: iamf_tpu.codecs.aac.tpu_synth's [L, 1024] overlap carry
- ``limiter_state``: iamf_tpu.dsp.limiter's state dict
- ``pipeline_config``: iamf_tpu.core.pipeline.PipelineConfig
- ``serial_limiter_state``: the frame-serial iamf_tpu.dsp.limiter.Limiter's
  state, as dsp/limiter.Limiter carries it (a stream axis of 1)
- ``hrtf_overlap``: the frame-serial iamf_tpu.dsp.binaural.HRTFRenderer's
  overlap, as dsp/binaural.HRTFRenderer carries it ([1, 2, taps-1])
- ``leaf_batch``: the PVQ leaf arrays the native leaf tap gives (the input
  of iamf_tpu.codecs.opus.device_leaf.reconstruct), as
  codecs/opus/device_leaf.reconstruct sends them to the device
- ``packed_frame``: device_bands.pack_tensors' numpy dicts of one frame or
  of several, as codecs/opus/device_bands.run_frame takes them (a leading
  frame axis)

The port's pipeline takes a leading stream axis on its parameters and
carries (core/pipeline.py). ``stream_params``, ``pipe_carry`` and
``plan_carry`` give it: a JAX tree of one stream gains an axis of 1, and a
JAX fleet's stack (stacked=True: the jax.tree.map(_stack, ...) of its
plans' carries and stream_params, iamf_tpu/core/serving.py:112-113) keeps
its S, so a test can start a bucket from the JAX fleet's state.
``limiter_state``, ``synth_carry`` and ``aac_carry`` map shapes one to
one, leading axes included.

The JAX arrays are passed through ``np.asarray`` by the caller or here;
this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .codecs.opus.synth import SynthCarry
from .core.pipeline import ElementSpec, PipelineConfig
from .dsp.binaural import batch_seg_plan, hrir_for_batch
from .dsp.demix import DemixSpec
from .dsp.limiter import LimiterConfig, check_reachable_tc


def _t(a, device, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def pipeline_config(cfg) -> PipelineConfig:
    """iamf_tpu.core.pipeline.PipelineConfig -> this package's (the two
    sets of frozen dataclasses have the same fields)."""

    def spec(es):
        d = dict(vars(es))
        if es.demix is not None:
            d["demix"] = DemixSpec(**vars(es.demix))
        return ElementSpec(**d)

    d = dict(vars(cfg))
    d["elements"] = tuple(spec(es) for es in cfg.elements)
    if cfg.limiter is not None:
        d["limiter"] = LimiterConfig(**vars(cfg.limiter))
    return PipelineConfig(**d)


def stream_params(params: dict, device, cfg=None,
                  stacked: bool = False) -> dict:
    """put_stream_params pytree -> core/pipeline.stream_params layout, with
    the stream axis (gained, or kept when `stacked`). Rows past the padded
    length are junk in both packages and never read. The binaural spectra
    hrtf_H {i: [2 (re/im), 2, C, F]} become binaural.Hrir entries, which
    the streams share (a fleet's must be equal): the spectra as they are,
    and the time-domain bank irfft(...)[..., :taps] at the segment plan of
    `cfg` (this package's or the JAX PipelineConfig, needed only with
    hrtf_H)."""

    def put(a, dtype):
        a = np.asarray(a)
        return _t(a if stacked else a[None], device, dtype)

    out = {k: [put(a, np.float32) for a in params[k]]
           for k in ("factors", "rg", "mats", "elem_gain")}
    out["mat_idx"] = [put(a, np.int64) for a in params["mat_idx"]]
    out["out_gain"] = put(params["out_gain"], np.float32)
    out["hrir"] = {}
    for i, hri in params.get("hrtf_H", {}).items():
        hri = np.asarray(hri)
        if stacked:
            if any(not np.array_equal(h, hri[0]) for h in hri):
                raise ValueError("a fleet's streams need one HRIR bank")
            hri = hri[0]
        spec = (hri[0] + 1j * hri[1]).astype(np.complex64)
        taps = cfg.elements[i].hrtf_taps
        _, n, _ = batch_seg_plan(cfg.batch_frames, cfg.frame_size, taps)
        bank = np.fft.irfft(spec, n=n, axis=2)[..., :taps]
        out["hrir"][i] = hrir_for_batch(bank, cfg.batch_frames,
                                        cfg.frame_size, device, spec=spec)
    return out


def limiter_state(state: dict, device) -> dict:
    """iamf_tpu.dsp.limiter state dict -> dsp/limiter.py state dict, any
    leading (stream) axes kept. The envelope time must be one K3 can
    place: -1 or a value the recurrence reaches (check_reachable_tc; those
    depend only on the attack, release and rate, which both decoders leave
    at LimiterConfig's defaults). The true-peak meter's history tp_hist
    [..., C, 11] comes along where present."""
    env = np.stack([np.asarray(state[k], np.float32)
                    for k in ("current_gain", "target_start_gain",
                              "target_end_gain", "current_tc")], axis=-1)
    for tc in np.ravel(env[..., 3]):
        check_reachable_tc(LimiterConfig(), tc)
    out = {
        "env": _t(env, device),
        "delay_data": _t(state["delay_data"], device, np.float32),
        "peak_data": _t(state["peak_data"], device, np.float32),
        "entry_index": _t(np.asarray(state["entry_index"])[..., None],
                          device, np.int32),
    }
    if "tp_hist" in state:
        out["tp_hist"] = _t(state["tp_hist"], device, np.float32)
    return out


def serial_limiter_state(limiter, device) -> dict:
    """The JAX frame-serial Limiter's state (its ``state`` dict) -> the
    state dsp/limiter.Limiter carries: limiter_state's, with the stream
    axis of 1. The swallow (``padsize``, ``inited``) is two host ints the
    caller copies."""
    state = {k: np.asarray(v) for k, v in limiter.state.items()}
    return {k: v[None] for k, v in limiter_state(state, device).items()}


def hrtf_overlap(renderer, device) -> torch.Tensor:
    """The JAX frame-serial HRTFRenderer's overlap [2, taps-1] -> the
    carry dsp/binaural.HRTFRenderer keeps, [1, 2, taps-1] float32."""
    return _t(np.asarray(renderer.overlap)[None], device, np.float32)


def _axis(tree, stacked: bool):
    """Give a converted tree (tensors in dicts and NamedTuples) the stream
    axis unless it has it."""
    if stacked:
        return tree
    if isinstance(tree, torch.Tensor):
        return tree[None]
    if isinstance(tree, dict):
        return {k: _axis(v, False) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_axis(v, False) for v in tree))
    return tree  # the host frame position


def pipe_carry(carry: dict, device, stacked: bool = False) -> dict:
    """Pipeline carry, with the stream axis (gained, or kept when
    `stacked`): pos becomes a host int (a fleet's streams share it), the
    rest tensors."""
    pos = np.unique(np.asarray(carry["pos"]))
    if pos.size != 1:
        raise ValueError(f"a fleet's streams share one position: {pos}")
    out = {"pos": int(pos[0])}
    if "limiter" in carry:
        out["limiter"] = limiter_state(carry["limiter"], device)
    if "splice" in carry:
        out["splice"] = _t(carry["splice"], device, np.float32)
    if "hrtf" in carry:
        out["hrtf"] = {i: _t(v, device, np.float32)
                       for i, v in carry["hrtf"].items()}
    return _axis(out, stacked)


def plan_carry(carry: dict, device, stacked: bool = False) -> dict:
    """The JAX _HostPlan.carry {"pipe": ..., "syn": [per element]} ->
    batch_decoder.fused_decode's carry, with the stream axis: an Opus
    element's SynthCarry, an AAC element's overlap array, None for PCM."""
    syn = [None if c is None
           else _axis(aac_carry(c, device) if hasattr(c, "shape")
                      else synth_carry(c, device), stacked)
           for c in carry["syn"]]
    return {"pipe": pipe_carry(carry["pipe"], device, stacked), "syn": syn}


def synth_carry(carry, device) -> SynthCarry:
    """tpu_synth.SynthCarry (tail, hist, demem) -> synth.SynthCarry."""
    tail, hist, demem = carry
    return SynthCarry(tail=_t(tail, device, np.float32),
                      hist=_t(hist, device, np.float32),
                      demem=_t(demem, device, np.float32))


def aac_carry(carry, device) -> torch.Tensor:
    """The AAC filterbank's overlap carry [L, 1024]."""
    return _t(carry, device, np.float32)


def leaf_batch(n, k, idx, gain, spread, blocks, device) -> dict:
    """PVQ leaf arrays [L] -> tensors: n, k, spread, blocks int32, idx
    uint32, gain float32."""
    return {"n": _t(n, device, np.int32), "k": _t(k, device, np.int32),
            "idx": _t(idx, device, np.uint32),
            "gain": _t(gain, device, np.float32),
            "spread": _t(spread, device, np.int32),
            "blocks": _t(blocks, device, np.int32)}


def packed_frame(bt, lt, device) -> tuple[dict, dict]:
    """device_bands.pack_tensors' (bt, lt) of one frame, or sequences of
    them, -> (bt, lt) dicts of tensors with a leading frame axis F (1 for
    one frame), each key in its numpy dtype (fill_cols uint32)."""
    bts, lts = ([bt], [lt]) if isinstance(bt, dict) else (bt, lt)

    def stack(ds):
        return {key: torch.from_numpy(np.stack([d[key] for d in ds])).to(
            device) for key in ds[0]}

    return stack(bts), stack(lts)
