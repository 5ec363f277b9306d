"""Scaling of the frame-sharded decode (counterpart of
iamf_tpu/tools/scaling_bench.py).

Decodes one stream through ShardedStreamDecoder at 1, 2, 4 and 8 shards
and reports frames/s at each count beside the overhead the carry-chain
design implies:

- preroll %: the one-frame re-decode prefix a shard (the Opus and AAC
  filterbank overlap) as a share of a shard's work, the only compute the
  sharding adds;
- carry bytes: the state each frames boundary hands on (comb history
  [L, 1032] and de-emphasis memory [L] float32 an Opus lane, the limiter
  state), the serial part: S hops of a chain; the head-trim halo moves
  the other way;
- efficiency: frames/s(k) / (k * frames/s(1)), measured, and the model
  F / (F + k * R) for the stream's F frames and for 30 s (F = 1500).

The shards lie over the visible cards (--device cuda, the default) or on
the CPU (--device cpu). With fewer cards than shards the shards share a
card, and the row says so ("shared_card": true): as on the JAX bench's
virtual CPU mesh, such a row's wall efficiency is a lower bound and the
decomposition columns are what transfers to more cards. The wall of a
count is the least of 3 decodes after one warm-up (the kernels' build
excluded).

Opus content is the repo's Opus sample (iamf_tpu/data/sample_opus_714.iamf,
16 frames): the JAX bench encodes its Opus with libopus, which is absent
here, so --frames sets the PCM content's length only.

  python -m iamf_tpu_torch.tools.scaling_bench [--content opus|pcm]
      [--frames N] [--json out] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..constants import ChannelLayout
from ..device import resolve_device
from ..dsp.limiter import init_state
from ..parallel.sharded_decoder import ShardedStreamDecoder
from . import streams

SAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "iamf_tpu", "data", "sample_opus_714.iamf")


def content(kind: str, n_frames: int = 64) -> bytes:
    """The bench's stream: the Opus sample, or n_frames of 7.1.4 PCM."""
    if kind == "opus":
        with open(SAMPLE, "rb") as f:
            return f.read()
    return streams.build_pcm_layout_stream(
        ChannelLayout.L714, n_frames=n_frames, amp=0.5)[0]


def carry_bytes(dec: ShardedStreamDecoder) -> tuple[int, int]:
    """(bytes a frames boundary hands to the next shard, the head-trim
    halo's bytes handed back)."""
    lanes = sum(e.lanes for e in dec.base.elems if e.opus)
    comb = lanes * (1032 + 1) * 4
    cfg = dec.base.cfg
    lim = 0
    if cfg.limiter is not None:
        lim = sum(t.numel() * t.element_size()
                  for t in init_state(cfg.limiter, "cpu").values())
    return comb + lim, cfg.head_trim * cfg.out_channels * 4


def rows(stream: bytes, device="cuda", shards=(1, 2, 4, 8),
         sound_system: int = 9, reps: int = 3) -> list:
    """One row a shard count (JAX scaling_bench's keys, plus the devices
    used); each decode is held to the one-shard decode within 1 LSB."""
    dev = resolve_device(device)
    cards = (torch.cuda.device_count() if dev.type == "cuda" else None)
    out, base_fps, want = [], None, None
    for k in shards:
        dec = ShardedStreamDecoder(stream, n_devices=k,
                                   sound_system=sound_system, device=dev)
        got = dec.decode_all()  # warm-up
        wall = []
        for _ in range(reps):
            t0 = time.perf_counter()
            dec.decode_all()
            wall.append(time.perf_counter() - t0)
        if want is None:
            want = got
        else:
            d = np.abs(got.astype(np.int64) - want.astype(np.int64))
            if got.shape != want.shape or d.max() > 1:
                raise AssertionError(f"shards={k}: {d.max()} LSB against "
                                     "one shard")
        best = min(wall)
        fps = dec.n_frames / best
        base_fps = base_fps or fps
        R, F = dec.preroll, dec.n_frames
        carry, halo = carry_bytes(dec)
        used = sorted({str(d) for _, d in dec.mesh.shards})
        out.append({
            "shards": k,
            "wall_ms": round(best * 1e3, 1),
            "frames_per_s": round(fps, 1),
            "frames_per_shard": dec.frames_per_shard,
            "preroll_frames": R,
            "preroll_overhead_pct": round(
                100.0 * R / (dec.frames_per_shard + R), 1),
            "carry_bytes_per_boundary": carry,
            "halo_bytes_per_boundary": halo,
            "chain_steps": k,
            "measured_efficiency_pct": round(100.0 * fps / (k * base_fps), 1),
            "model_efficiency_pct": round(100.0 * F / (F + k * R), 1),
            "model_efficiency_30s_pct": round(100.0 * 1500 / (1500 + k * R),
                                              1),
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "cards": used,
            "shared_card": dev.type == "cuda" and cards < k,
        })
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--content", choices=("opus", "pcm"), default="opus")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--json")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    table = rows(content(a.content, a.frames), a.device)
    for r in table:
        print(f"shards={r['shards']}: {r['wall_ms']:7.1f} ms  "
              f"{r['frames_per_s']:8.1f} frames/s  preroll "
              f"{r['preroll_overhead_pct']}%  carry "
              f"{r['carry_bytes_per_boundary']} B  measured-eff "
              f"{r['measured_efficiency_pct']}%  model-eff "
              f"{r['model_efficiency_pct']}% (30s: "
              f"{r['model_efficiency_30s_pct']}%)  on {r['device']} "
              f"{r['cards']}{' (shared card)' if r['shared_card'] else ''}",
              flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"content": a.content, "n_frames": a.frames,
                       "rows": table}, f, indent=1)
        print(f"wrote {a.json}")


if __name__ == "__main__":
    main()
