"""Frame-parallel decode of a whole IAMF stream over a mesh of shards
(counterpart of iamf_tpu/parallel/sharded_decoder.py).

The host half is BatchedStreamDecoder's: the OBU parse, the timeline
replay, and the whole stream's Opus or AAC entropy (or PCM unpack) at
once. The frames axis of a ShardMesh (parallel/mesh.py) cuts the timeline
into shards of F frames; every cross-frame recurrence is handed from shard
to shard exactly, so the output equals the single-device decode:

1. **Preroll re-decode.** The codec filterbanks carry a one-frame overlap
   (the CELT TDAC tail, the AAC overlap-add half), a pure function of the
   previous frame's spectra. Each shard takes one extra leading frame (the
   idiom of IAMF's audio_roll_distance), runs K1 (synth.shard_stages) or
   K7 from a zero carry over preroll + F frames, and drops the preroll row.
2. **Carry chains.** The CELT comb post-filter and de-emphasis (K2) and
   the limiter (K3) are IIRs over the whole timeline. They run as chains
   over the frames axis: shard k runs its own frames (its padded tail rows
   too) from the state shard k-1 handed it, then hands its state to shard
   k+1 (``ShardMesh.ppermute``, one hop a shard).
3. **Mix.** Demix, render, gains and mix run on each shard's frames
   (core/pipeline.shard_mix on a window of stream_params). The head trim
   moves the right neighbour's first head_trim mixed samples into each
   shard (a halo hop to the previous shard) before the limiter chain.
4. **Output.** The PCM goes to every rank in frames order
   (``process_allgather``); when the stream fills the mesh exactly, the
   limiter's drain is one more K3 call on delay_size zeros from the last
   shard's state.

Two 2-D meshes add a second axis:
- ("frames", "elements"): an element belongs to element shard i %
  n_eshards. The owner alone runs its K1 (a psum over "elements" gives
  every element row the result) and its K7 / demix / render / gain; the
  psum of the contributions is the reference's mixer sum. The K2 and K3
  chains run on every element row, on the summed data.
- ("frames", "substreams"): each substream shard synthesizes a slab of
  every element's lanes (padded to a multiple of the axis: neutral Opus
  rows, zero PCM or AAC lanes), then an all_gather reassembles each
  element, the padding dropped, before the demix.

As the JAX sharded decoder, it renders to loudspeakers only (no binaural)
and builds no resample tail: a stream not at 48 kHz comes out as the
quantized mix at its own rate, without a limiter (ROADMAP.md §3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs.aac import synth as aac_synth
from ..codecs.opus import synth as opus_synth
from ..core.batch_decoder import BatchedStreamDecoder
from ..core.pipeline import (element_mix, out_mix, shard_mix, stream_params,
                             window_params)
from ..dsp.limiter import init_state, limit_quantize
from ..dsp.quantize import quantize_interleave
from .mesh import ShardMesh


def _window(a: np.ndarray, lo: int, count: int, lanes: slice, fill, dev):
    """Rows [lo, lo + count) and `lanes` of a per-frame array [n, L, ...] as
    a tensor on `dev`; the rows outside [0, n) take `fill` (a row, or a
    scalar). For a card the window is filled in pinned memory and copied
    without blocking (the caching host allocator keeps the buffer until
    the copy is done)."""
    a = a[:, lanes]
    out = torch.empty((count,) + a.shape[1:],
                      dtype=torch.from_numpy(a[:0]).dtype,
                      pin_memory=dev.type == "cuda")
    host = out.numpy()
    i0 = min(max(-lo, 0), count)  # the window's rows in [0, n): [i0, i1)
    i1 = min(max(a.shape[0] - lo, i0), count)
    host[:i0] = fill
    host[i0:i1] = a[lo + i0:lo + i1]
    host[i1:] = fill
    return out.to(dev, non_blocking=True)


class ShardedStreamDecoder:
    """Decode a complete in-memory IAMF stream sharded over a ShardMesh of
    devices (and processes). `device`: the shards' device kind when no
    mesh is given ('cuda', the default, raises without a card; 'cpu' for
    the twins); n_devices shards in all, element_axis or substream_axis of
    them on the second axis of a 2-D mesh."""

    def __init__(self, data: bytes, mesh: ShardMesh | None = None,
                 n_devices: int | None = None, sound_system: int = 0,
                 bits: int = 16, limiter: bool = True,
                 element_axis: int = 1, substream_axis: int = 1,
                 device="cuda"):
        if element_axis > 1 and substream_axis > 1:
            raise ValueError("element_axis and substream_axis are "
                             "mutually exclusive (use a 2-D mesh)")
        if mesh is None:
            second = max(element_axis, substream_axis)
            name = ("elements" if element_axis > 1 else
                    "substreams" if substream_axis > 1 else None)
            mesh = ShardMesh.build(n_devices, second, name, device)
        self.mesh = mesh
        self.n_shards = mesh.shape["frames"]
        self.n_eshards = mesh.shape.get("elements", 1)
        self.n_sshards = mesh.shape.get("substreams", 1)
        # batch_frames only gates the head trim: the shards drive the
        # pipeline themselves
        self.base = BatchedStreamDecoder(
            data, sound_system=sound_system, bits=bits, limiter=limiter,
            batch_frames=128, device=mesh.devices[0])
        base = self.base
        # a one-frame overlap prefix for the device filterbanks
        self.prerolls = tuple(1 if e.opus or e.aac else 0
                              for e in base.elems)
        # the stream's declared random-access prefix (informational: the
        # carry chains make deeper preroll needless)
        self.roll_distance = max(
            (abs(int(base.db.elements[e.stream.element_id]
                     .codec_config.roll_distance)) for e in base.elems),
            default=0)
        self.preroll = max(self.prerolls)
        n = base.n_frames
        self.frames_per_shard = -(-n // self.n_shards)
        self.n_frames = n
        if base.cfg.head_trim > self.frames_per_shard * base.frame_size:
            # the halo reaches one shard to the left only
            raise ValueError(
                f"trimming_start ({base.cfg.head_trim} samples) exceeds one "
                f"shard ({self.frames_per_shard * base.frame_size} samples); "
                f"use fewer shards or the single-device BatchedStreamDecoder")
        self._aac_tabs: dict = {}
        # after decode_all with a limiter: its state after the last shard,
        # {key: tensor} on the host
        self.final_limiter = None

    # --- host ---------------------------------------------------------------

    def _host_inputs(self) -> list:
        """Per element: (kind, whole-stream arrays [n, L, ...] (AAC: spectra
        and window meta), their neutral rows), the lanes padded to a
        multiple of the substreams axis."""
        base = self.base
        n, T = self.n_frames, base.frame_size
        out = []
        for e in base.elems:
            packets = [base.frames_per_substream.get(sid, [])
                       for sid in e.substream_ids]
            if e.opus:
                arrays = (base._opus_entropy(e, packets, 0, n, n),)
                kind = "opus"
            elif e.aac:
                arrays = base._aac_entropy(e, packets, 0, n, n)
                kind = "aac"
            else:
                arrays = (e.codec.decode_batch_raw(packets, T)[0][:n],)
                kind = "raw"
            L = arrays[0].shape[1]
            fills = tuple(opus_synth.neutral_rows(()) if kind == "opus"
                          else 0 for _ in arrays)
            Lp = -(-L // self.n_sshards) * self.n_sshards
            if Lp != L:
                arrays = tuple(np.concatenate(
                    [a, np.broadcast_to(np.asarray(f, a.dtype),
                                        (n, Lp - L) + a.shape[2:])], axis=1)
                    for a, f in zip(arrays, fills))
            out.append((kind, arrays, fills, L))
        return out

    def _aac(self, dev):
        if dev not in self._aac_tabs:
            self._aac_tabs[dev] = aac_synth.Tables().to(dev)
        return self._aac_tabs[dev]

    # --- the chains -----------------------------------------------------------

    def _chain(self, step, init) -> tuple[dict, dict]:
        """Run step(i, carry) -> (out, carry') on this rank's shards in
        frames order, each frames shard's carry handed to the next (one
        ppermute hop a shard; every column of the second axis its own
        chain). init(i): shard i's first carry (used at frames 0, and as
        the receivers' shapes). carry: a list of tensors. Returns ({i:
        out}, {i: carry after shard i})."""
        mesh = self.mesh
        outs, finals = {}, {}
        got = {}
        for k in range(self.n_shards):
            here = [i for i in mesh.local
                    if mesh.axis_index(i, "frames") == k]
            for i in here:
                outs[i], finals[i] = step(i, got.pop(i) if k else init(i))
            nxt = {j: init(j) for j in mesh.local
                   if mesh.axis_index(j, "frames") == k + 1}
            got.update(mesh.ppermute({**{i: finals[i] for i in here}, **nxt},
                                     "frames", +1, src=k))
        return outs, finals

    # --- the decode -----------------------------------------------------------

    def decode_all(self) -> np.ndarray:
        """Decode the stream: [samples, out_channels] int PCM on the host,
        on every rank."""
        base, mesh = self.base, self.mesh
        cfg = base.cfg
        S, F, T, n = self.n_shards, self.frames_per_shard, cfg.frame_size, \
            self.n_frames
        Ss, Se = self.n_sshards, self.n_eshards
        n_e = len(cfg.elements)
        host = self._host_inputs()
        params = stream_params(cfg, base.params, S * F, "cpu")
        opus_idx = [e for e in range(n_e) if host[e][0] == "opus"]

        def owns(i, e):
            return Se == 1 or mesh.axis_index(i, "elements") == e % Se

        # ---- per shard: inputs, stage 1 (K1 with a preroll; K7 and raw
        # frames wait for the mix, where the elements mesh needs them)
        ins, pk, y = {}, {}, {}
        for i in mesh.local:
            dev = mesh.device(i)
            k = mesh.axis_index(i, "frames")
            j = mesh.axis_index(i, "substreams") if Ss > 1 else 0
            ins[i], pk[i], y[i] = [], {}, {}
            for e, (kind, arrays, fills, _) in enumerate(host):
                R = self.prerolls[e]
                ll = arrays[0].shape[1] // Ss
                ts = [_window(a, k * F - R, R + F,
                              slice(j * ll, (j + 1) * ll), f, dev)
                      for a, f in zip(arrays, fills)]
                ins[i].append(ts)
                if kind == "opus":
                    pk[i][e] = ts[0][R:]
                    if owns(i, e):
                        y[i][e] = opus_synth.shard_stages(
                            opus_synth.celt_synth(dev), ts[0], R)
                    else:
                        y[i][e] = torch.zeros(
                            (F, ll, opus_synth.FRAME), device=dev)
        if Se > 1:
            for e in opus_idx:
                got = mesh.psum({i: y[i][e] for i in mesh.local}, "elements")
                for i in mesh.local:
                    y[i][e] = got[i]

        # ---- stage 2: the comb + de-emphasis chain over the frames axis
        def comb_init(i):
            return [t for e in opus_idx for t in (
                torch.zeros((pk[i][e].shape[1], opus_synth.HIST),
                            device=mesh.device(i)),
                torch.zeros((pk[i][e].shape[1],), device=mesh.device(i)))]

        def comb_step(i, carry):
            win = opus_synth.celt_synth(mesh.device(i)).window
            pcm, out = {}, []
            for m, e in enumerate(opus_idx):
                pcm[e], h, d = opus_synth.comb_deemph(
                    win, y[i][e], pk[i][e], carry[2 * m], carry[2 * m + 1])
                out += [h, d]
            return pcm, out

        combed = (self._chain(comb_step, comb_init)[0] if opus_idx
                  else {i: {} for i in mesh.local})

        # ---- stage 3: the elements' frames, then the mix
        def frames_of(i, e):
            kind, _, _, _ = host[e]
            R = self.prerolls[e]
            if kind == "opus":
                return combed[i][e]
            if kind == "aac":
                spec, meta = ins[i][e]
                x, _ = aac_synth.synthesize(
                    self._aac(spec.device), spec, meta,
                    aac_synth.init_carry(spec.shape[1], spec.device))
                return x[R:]
            return ins[i][e][0][R:]

        windows = {i: window_params(params, mesh.axis_index(i, "frames") * F,
                                    F, mesh.device(i)) for i in mesh.local}
        if Se > 1:
            contrib = {}
            for i in mesh.local:
                total = None
                for e in range(n_e):
                    if owns(i, e):
                        r = element_mix(cfg, e, windows[i], frames_of(i, e))
                        total = r if total is None else total + r
                contrib[i] = total if total is not None else torch.zeros(
                    (F, cfg.out_channels, T), device=mesh.device(i))
            mixed = mesh.psum(contrib, "elements")
            flat = {i: out_mix(cfg, windows[i], mixed[i])
                    for i in mesh.local}
        else:
            xs = {i: [frames_of(i, e) for e in range(n_e)]
                  for i in mesh.local}
            if Ss > 1:
                for e in range(n_e):
                    got = mesh.all_gather({i: xs[i][e] for i in mesh.local},
                                          "substreams", dim=1)
                    for i in mesh.local:
                        xs[i][e] = got[i][:, :host[e][3]]
            flat = {i: shard_mix(cfg, windows[i], xs[i]) for i in mesh.local}

        # ---- stage 4: the head-trim halo, the limiter chain, quantize
        h = cfg.head_trim
        if h:
            halo = mesh.ppermute({i: [f[:, :h]] for i, f in flat.items()},
                                 "frames", -1)
            flat = {i: torch.cat([f[:, h:], halo[i][0]], dim=1)
                    for i, f in flat.items()}
        lim = cfg.limiter
        if lim is not None:
            keys = sorted(init_state(lim, "cpu"))

            def lim_init(i):
                st = init_state(lim, mesh.device(i))
                return [st[key][None] for key in keys]

            def lim_step(i, carry):
                st, pcm = limit_quantize(lim, dict(zip(keys, carry)),
                                         flat[i][None], cfg.bits, T)
                return pcm[0], [st[key] for key in keys]

            pcm, finals = self._chain(lim_step, lim_init)
        else:
            pcm = {i: quantize_interleave(f, cfg.bits)
                   for i, f in flat.items()}
        full = mesh.process_allgather(pcm).reshape(
            S * F * T, cfg.out_channels).numpy()

        # ---- host: the look-ahead head, the drain, the edge trims (the
        # batched decoder's semantics). The padded frames past the stream
        # ran through the limiter chain, so the rows after it ARE the
        # drain; only a stream that fills the mesh needs one more call.
        lead, want = base.lead, n * T - base.lead - base.tail
        if lim is None:
            return full[lead: lead + want]
        # the limiter state after the last shard (the JAX program's
        # final_lim[S - 1]), on every rank: the drain starts from it
        self.final_limiter = {key: mesh.process_allgather(
            {i: c[m][0] for i, c in finals.items()})[S - 1]
            for m, key in enumerate(keys)}
        d = lim.delay_size
        start = d if h else d + lead
        out = full[start: start + want]
        missing = start + want - full.shape[0]
        if missing > 0:
            dev = mesh.devices[0]
            state = {key: v[None].to(dev)
                     for key, v in self.final_limiter.items()}
            _, drain = limit_quantize(
                lim, state, torch.zeros((1, cfg.out_channels, d), device=dev),
                cfg.bits, T)
            out = np.concatenate([out, drain[0].cpu().numpy()[:missing]])
        return out
