"""The plain reference against the port's CPU path on small inputs of each
configuration, and its TF32 control failing the limits."""

import json
import os

import numpy as np
import pytest
import torch

from harness import content, entropy, iamf_bits as ib, manifest
from reference import celt, iamf as ref, limiter, opus_celt

from conftest import BENCH


def _cfg(name):
    return json.load(open(os.path.join(BENCH, "configs", f"{name}.json")))


def _sample():
    return open(os.path.join(BENCH, "data", "sample_opus_714.iamf"),
                "rb").read()


def _gap(a, b):
    n = min(len(a), len(b))
    assert n > 0 and a.shape[1:] == b.shape[1:]
    return int(np.abs(a[:n].astype(np.int64) - b[:n].astype(np.int64)).max())


def _opus(first, units, tf32=False):
    data = ib.loop_units(_sample(), units, first)
    ent, info = entropy.opus_entropy(data)
    return data, ref.opus_stream(ent, info["lead"], info["tail"],
                                 _cfg("opus714_ssJ"), tf32=tf32)


def _loud(units, seed):
    cfg = _cfg("pcm714_binaural")
    rng = np.random.RandomState(seed)
    pcm = manifest.load("content", "pcm_loud").loud_pcm(cfg, units, 0.3, 2,
                                                        rng)
    data = ib.build_pcm_layout_stream(7, 7, 5, pcm, hrm=1)
    return cfg, pcm, data


@pytest.mark.parametrize("first,units", [(0, 16), (5, 40)])
def test_opus_reference_matches_port(first, units):
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

    data, got = _opus(first, units)
    want = BatchedStreamDecoder(data, sound_system=9, batch_frames=8,
                                device="cpu").decode_all()
    assert got.shape == want.shape
    assert _gap(got, want) <= 1


@pytest.mark.parametrize("seed", [1, 2])
def test_binaural_reference_matches_port(seed):
    from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

    cfg, pcm, data = _loud(24, seed)
    want = BatchedStreamDecoder(data, binaural=True, batch_frames=8,
                                device="cpu").decode_all()
    got = ref.binaural_stream(pcm, cfg)
    assert got.shape == want.shape
    assert np.abs(want).max() >= 29000  # the limiter engaged
    assert _gap(got, want) <= 1


def test_limiter_matches_port_twin():
    from iamf_tpu_torch.dsp import limiter as pl

    rng = np.random.RandomState(0)
    x = (rng.randn(3, 20000) * 0.3).astype(np.float32)
    x[:, 5000:9000] *= 4
    cfg = pl.LimiterConfig(channels=3)
    st = {k: v[None] for k, v in pl.init_state(cfg, "cpu").items()}
    z = np.concatenate([x, np.zeros((3, 240), np.float32)], axis=1)
    _, q = pl.limit_quantize(cfg, st, torch.from_numpy(z)[None], 16,
                             z.shape[1])
    assert np.array_equal(limiter.limit_s16(x, 20000), q[0, 240:].numpy())


def test_window_is_celts():
    from iamf_tpu_torch.codecs.opus.imdct import window120

    assert np.abs(celt.window() - window120()).max() < 1e-7


def test_opus_control_fails():
    """The reference with TF32 products in the program's place reads past
    the limit; the float64 one is within it."""
    limit = _cfg("opus714_ssJ")["limits"]["max_gap_lsb"]
    _, want = _opus(3, 40)
    _, ctl = _opus(3, 40, tf32=True)
    assert _gap(ctl, want) > limit


def test_binaural_control_fails():
    limit = _cfg("pcm714_binaural")["limits"]["share_over_1lsb"]
    cfg, pcm, _ = _loud(24, 3)
    ctl = ref.binaural_stream(pcm, cfg, tf32=True)
    want = ref.binaural_stream(pcm, cfg)
    assert (np.abs(ctl.astype(int) - want.astype(int)) > 1).mean() > limit


def test_entropy_stage_and_its_control():
    """The program's Opus entropy output on the sample equals the frozen
    copy; the copy's spectra rounded to TF32 read past the limit."""
    cfg = _cfg("opus714_ssJ")
    limit = cfg["limits"]["entropy_gap"]
    stage = content.kind(cfg).stage
    assert opus_celt.entropy_gap(cfg, stage) == 0.0
    z = np.load(opus_celt.FROZEN)
    tf = celt.to_tf32(torch.from_numpy(z["freq"]).double()).numpy()
    peak = np.abs(z["freq"]).max(axis=2, keepdims=True)
    assert (np.abs(tf - z["freq"]) / peak).max() > limit
