"""decode_frames of the PyTorch port vs the JAX package, batch by batch.

Both sides decode the same PCM batches with the same configuration; the
JAX side runs the first batch alone, its carry (limiter envelope, delay
line and peak ring, head-trim splice, frame position) and its stream
parameters are carried across with iamf_tpu_torch.convert, and from then
on both chain their own carries. Bound: <= 1 LSB on the int16 output.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectors
from iamf_tpu.constants import AnimationType, ChannelLayout
from iamf_tpu.core import pipeline as jpipe
from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as JaxDecoder
from iamf_tpu_torch import convert
from iamf_tpu_torch.core import pipeline as ppipe

B = 4
T = 960


def _loud(n_frames, nch, lo, hi):
    """Sine bed with a +4 dB burst over frames [lo, hi)."""
    pcm = vectors.sine_pcm(n_frames * T, nch, 48000, amp=0.4, seed=3)
    burst = vectors.sine_pcm((hi - lo) * T, nch, 48000, amp=1.45, seed=4)
    pcm[lo * T:hi * T] = np.clip(burst, -32768, 32767)
    return pcm


def _offset_split(cfg):
    # force the render offset split and the demix skip split (codec delay
    # is 0 for PCM) so both blends run
    es = [dataclasses.replace(e, render_offset=240, skip=240)
          for e in cfg.elements]
    return dataclasses.replace(cfg, elements=tuple(es))


CASES = {
    # quiet 7.1.4 -> J with a pre-limiter head trim: limiter fast branch
    "pcm714_ssJ_head_trim_fast": (
        lambda: vectors.build_pcm_layout_stream(
            ChannelLayout.L714, n_frames=12, amp=0.5)[0],
        9, lambda c: dataclasses.replace(c, head_trim=312), "fast"),
    # +4 dB burst across the batch edge at frame 4: limiter slow branch
    "pcm714_ssJ_loud_slow": (
        lambda: vectors.build_pcm_layout_stream(
            ChannelLayout.L714, n_frames=12,
            pcm_override=_loud(12, 12, 3, 5))[0],
        9, lambda c: c, "slow"),
    # two-layer scalable stream: demix chains, mode walk, recon gains
    "scalable_demix_recon_ss1": (
        lambda: vectors.build_scalable_pcm_stream(
            n_frames=12, demix_modes=[0, 1, 2, 1],
            recon_gains=[(200, 180), (255, 255), (120, 90)])[0],
        1, lambda c: c, None),
    # 7.1.4 downmixed to 5.1.2 with changing demix modes (a table of
    # render matrices, prev != cur), an animated element mix gain, and the
    # offset-split render blend
    "downmix_offset_split_ss2": (
        lambda: vectors.build_pcm_layout_stream(
            ChannelLayout.L714, n_frames=12, amp=0.3,
            demix_modes=[0, 1, 2],
            layout_specs=[vectors.builder.LayoutSpec(sound_system=2)],
            mix_gain_segments=[{"animation": AnimationType.LINEAR,
                                "start": -256 * (i % 4),
                                "end": -256 * ((i + 1) % 4)}
                               for i in range(12)])[0],
        2, _offset_split, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_frames_matches_jax(name):
    make, ss, tweak, branch = CASES[name]
    jd = JaxDecoder(make(), sound_system=ss, batch_frames=B)
    cfg_j = tweak(jd.cfg)
    if name.startswith("downmix"):
        assert len(np.unique(jd.params.elements[0].mat_idx, axis=0)) > 1
    cfg_p = convert.pipeline_config(cfg_j)
    n = jd.n_frames
    nb = -(-n // B)
    params_j = jpipe.put_stream_params(cfg_j, jd.params, (nb + 1) * B)
    params_p = convert.stream_params(params_j, "cpu")
    xs_all = [e.codec.decode_batch_raw(
        [jd.frames_per_substream[s] for s in e.substream_ids], T)[0]
        for e in jd.elems]

    carry_j = jpipe.init_carry(cfg_j)
    carry_p = None
    idle = []
    for bi in range(nb + 1):  # the last call is a zero flush
        xs = []
        for x in xs_all:
            x = x[bi * B:(bi + 1) * B]
            xs.append(np.concatenate(
                [x, np.zeros((B - len(x),) + x.shape[1:], x.dtype)]))
        if bi == 1:
            carry_p = convert.pipe_carry(carry_j, "cpu")
        carry_j, pcm_j = jpipe.decode_frames(
            cfg_j, carry_j, params_j, [jnp.asarray(x) for x in xs])
        if carry_p is None:
            continue
        carry_p, pcm_p = ppipe.decode_frames(
            cfg_p, carry_p, params_p, [torch.from_numpy(x)[None] for x in xs])
        pcm_p = pcm_p[0]  # the one stream
        pcm_j = np.asarray(pcm_j)
        assert pcm_p.dtype == torch.int16 and pcm_p.shape == pcm_j.shape
        d = np.abs(pcm_p.numpy().astype(np.int32) - pcm_j.astype(np.int32))
        assert d.max() <= 1, f"batch {bi}: {d.max()} LSB"
        assert carry_p["pos"] == int(carry_j["pos"])
        if cfg_p.limiter is not None:
            idle.append(float(carry_p["limiter"]["env"][0, 3]) == -1.0)
    if branch == "fast":
        assert all(idle)
    elif branch == "slow":
        assert not all(idle)
