"""Batched stream decoder on PyTorch (counterpart of
iamf_tpu/core/batch_decoder.py).

The host half is the reference's: all OBUs are split up front
(obu/parser.py), the parameter timeline is replayed (core/timeline.py),
PCM and FLAC substreams are unpacked in one vectorized pass, and Opus and
AAC substreams are entropy-decoded per batch by the native decoders into
spectra, prefetched one batch ahead on a worker thread so host entropy
overlaps the device work. The device half runs per batch:

    kind "opus" (CELT-960, one frame per unit): CELT synthesis
        (codecs/opus/synth.py: K1 IMDCT+TDAC, K2 comb+de-emphasis+s16)
    kind "aac"  (AAC-LC, 1024-sample frames): the synthesis filterbank
        (codecs/aac/synth.py: K7 IMDCT, windows, overlap-add, s16)
    kind "raw"  (PCM and FLAC, unpacked on the host): passthrough
    -> core/pipeline.decode_frames (demix, render, K8 HRTF convolution for
       binaural elements, gains, mix, head trim, K3 limiter + quantize,
       fed by the K9 true-peak meter with IAMF_TRUEPEAK=1)

binaural=True renders to two ears: channel-based elements with
headphones_rendering_mode 1 convolve their channel bed with the layout's
HRIR bank (M2B), scene-based ones first render to a 7.1.2 virtual bed
(H2B); with mode 0 the M2M/H2M matrix to the binaural layout is used.

A stream not at 48 kHz takes the resample tail: the pipeline emits the
float mix (no device limiter, no head trim), the batches stay on the device
and are joined, K10 resamples the trimmed stream to 48 kHz, then the
normalization gain, the limiter (K3, one call over the stream and its
drain) or plain quantization, and one copy to the host.

The device step takes a leading stream axis (fused_decode, and
core/pipeline.py): one decoder runs it with S = 1, the multi-stream server
(core/serving.py) with a bucket of S streams, from the same _HostPlan per
stream.

A non-redundant Sequence Header after the first starts a reconfigure
segment (IAMF_decoder.c:2918-2921, iamfplayer.c:623-626): this decoder
decodes up to it, and decode_all chains a follow-on decoder over the rest
on the same device. ``from_mp4`` opens IAMF in MP4 or fragmented MP4
(mp4/iamf_track.py), with an optional seek. ``stats`` names each element's
decode path.

Not ported yet, and raising NotImplementedError: other Opus operating
points, SILK and hybrid included (ROADMAP.md §1 item 5), and AAC with
frames other than 1024 samples.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import functools
import os

import numpy as np
import torch

from ..codecs.aac import synth as aac_synth
from ..codecs.base import open_decoder
from ..codecs.opus import synth as opus_synth
from ..codecs.opus.decoder import decode_spectrum_batch
from ..constants import (
    AmbisonicsMode, ChannelLayout, ElementType, LayoutType, SoundSystem,
    db_to_linear, q78_to_db,
)
from ..device import resolve_device
from ..dsp import render as rdr
from ..dsp.binaural import hrir_bank
from ..dsp.demix import DemixSpec
from ..dsp.downmix import DownmixerState, can_downmix, downmix_matrix
from ..dsp.limiter import LimiterConfig, init_state, limit_quantize
from ..dsp.quantize import quantize_interleave
from ..dsp.resample import ResamplePlan, resample_stream
from ..mp4.iamf_track import MP4IAMFParser
from ..obu import parser
from . import timeline
from .database import Database, codec_config_sampling_rate
from .pipeline import (ElementSpec, PipelineConfig, decode_frames, init_carry,
                       stream_params)
from .presentation import best_loudness, best_mix_presentation
from .stream import SS_TO_LAYOUT, OutputLayout, Stream


@dataclasses.dataclass
class _ElemCtx:
    stream: Stream
    codec: object
    substream_ids: list
    demix_spec: object  # DemixSpec | None
    render_mat: np.ndarray  # [out_channels, n_rendered]
    downmix: object  # DownmixerState | None (mode/w walk for the renderer)
    n_in: int
    input_scale: float
    raw_input: bool
    opus: bool
    aac: bool
    gain: float  # element default mix gain (linear)
    hrtf_bank: object = None  # np.ndarray [2, n_bed, taps] | None: the HRIRs
    #   of a binaural (M2B/H2B) element; render_mat then yields the bed

    @property
    def lanes(self) -> int:
        """Channel lanes of an Opus or AAC element's synthesis."""
        return sum(ch for _, ch in self.codec._decoders)


def _carry_map(f, c):
    """f over a synthesis carry: a tensor (AAC) or a SynthCarry (Opus)."""
    return f(c) if isinstance(c, torch.Tensor) else type(c)(*map(f, c))


def lane_synth(fn, inputs: tuple, carry):
    """A synthesis fn(*inputs [B, L, ...], carry [L, ...]) -> (pcm [B, L,
    n], carry') over S streams: inputs [S, B, L, ...], carry [S, L, ...].
    The lanes carry independent state, so on the card the streams fold
    into S·L lanes and fn launches its kernels once for all of them (K1
    and K2, or K7); on the CPU the twins run stream by stream, since a CPU
    matmul rounds differently with its row count and a served stream must
    equal its own decode bit for bit."""
    S, B, L = inputs[0].shape[:3]
    if inputs[0].is_cuda:
        pcm, c = fn(*(a.transpose(0, 1).reshape((B, S * L) + a.shape[3:])
                      for a in inputs),
                    _carry_map(lambda t: t.reshape((S * L,) + t.shape[2:]),
                               carry))
        return (pcm.reshape((B, S, L) + pcm.shape[2:]).transpose(0, 1),
                _carry_map(lambda t: t.reshape((S, L) + t.shape[1:]), c))
    outs = [fn(*(a[s] for a in inputs),
               _carry_map(lambda t: t[s], carry)) for s in range(S)]
    cs = [c for _, c in outs]
    c0 = cs[0]
    return (torch.stack([p for p, _ in outs]),
            torch.stack(cs) if isinstance(c0, torch.Tensor)
            else type(c0)(*map(torch.stack, zip(*cs))))


def synthesize_elements(kinds: tuple, synths: dict, syn: list, bufs: list):
    """Each element's codec synthesis for one batch of S streams: synths
    the constants by kind ("opus": CeltSynth, "aac": aac_synth.Tables);
    bufs per element [S, B, ...] (an AAC element's (spec, meta)); syn the
    synthesis carries, a leading stream axis each. Returns (xs, syn'):
    the decode pipeline's inputs and the next carries."""
    xs = []
    out = []
    for i, kind in enumerate(kinds):
        if kind == "opus":
            x, s = lane_synth(
                functools.partial(opus_synth.synthesize_packed,
                                  synths["opus"]), (bufs[i],), syn[i])
        elif kind == "aac":
            x, s = lane_synth(
                functools.partial(aac_synth.synthesize, synths["aac"]),
                bufs[i], syn[i])
        elif kind == "raw":
            x, s = bufs[i], syn[i]
        else:
            raise NotImplementedError(f"element kind {kind!r}")
        xs.append(x)
        out.append(s)
    return xs, out


def fused_decode(cfg: PipelineConfig, kinds: tuple, synths: dict,
                 carry: dict, params: dict, bufs: list):
    """Codec synthesis for each element (synthesize_elements), then the
    decode pipeline, for one batch of S streams (S = 1 for one decoder;
    core/serving.py stacks a bucket). carry: per-stream state with a
    leading stream axis. Returns (carry, pcm [S, B*T, out] int)."""
    xs, syn = synthesize_elements(kinds, synths, carry["syn"], bufs)
    pipe, pcm = decode_frames(cfg, carry["pipe"], params, xs)
    return {"pipe": pipe, "syn": syn}, pcm


def plan_kinds(dec: "BatchedStreamDecoder") -> tuple:
    """Each element's synthesis kind ("opus", "aac", "raw"): with the
    PipelineConfig, the key of the device step, so also the serving
    bucket's."""
    return tuple("opus" if e.opus else "aac" if e.aac else "raw"
                 for e in dec.elems)


def put_bufs(per_stream: list, device, staging: dict) -> list:
    """S streams' numpy inputs of one call (each a list per element of [B,
    ...] arrays; an AAC element's a (spec, meta) pair) -> per element one
    [S, B, ...] tensor on `device`. Each stream's array is copied into a
    host buffer [S, B, ...] that `staging` keeps from call to call (pinned
    for a CUDA device, so the copy to the card reads it directly), then
    the buffer goes to `device` in one blocking copy, after which the next
    call may refill it."""
    pin = torch.device(device).type == "cuda"

    def put(key, arrs):
        if key not in staging:
            staging[key] = torch.empty(
                (len(arrs),) + arrs[0].shape,
                dtype=torch.from_numpy(arrs[0][:0]).dtype, pin_memory=pin)
        buf = staging[key]
        host = buf.numpy()
        for s, a in enumerate(arrs):
            host[s] = a
        return buf.to(device, copy=True)

    return [tuple(put((i, j), p) for j, p in enumerate(zip(*parts)))
            if isinstance(parts[0], tuple) else put(i, parts)
            for i, parts in enumerate(zip(*per_stream))]


class _HostPlan:
    """Host-side plan of one stream's decode: whole-stream parameter
    tensors, per-element input (unpacked PCM, or prefetched Opus and AAC
    entropy), initial carries (each with a stream axis of 1), and the
    call/trim bookkeeping. Shared by BatchedStreamDecoder.decode_all and
    serving.MultiStreamServer, which stacks a bucket's plans."""

    def __init__(self, dec: "BatchedStreamDecoder", rows: int | None = None):
        self.dec = dec
        B = self.B = dec.batch_frames
        T = dec.frame_size
        n = self.n = dec.n_frames
        dev = dec.device
        self.n_batches = -(-n // B)
        # +1 batch of neutral padding so the limiter drain runs past the
        # end; `rows` overrides the padded length: the server pads every
        # member of a bucket to its longest stream (padding rows are
        # neutral), so the [S, ...] stacks are rectangular
        self.stream_params = stream_params(
            dec.cfg, dec.params, rows or (self.n_batches + 1) * B, dev,
            hrtf_banks=[e.hrtf_bank for e in dec.elems])
        self.elem_packets = []
        self.elem_all_x = []
        syn_carry = []
        for e in dec.elems:
            packets = [dec.frames_per_substream.get(sid, [])
                       for sid in e.substream_ids]
            self.elem_packets.append(packets)
            if e.opus or e.aac:
                self.elem_all_x.append(None)
                syn_carry.append(_carry_map(
                    lambda t: t[None],
                    (opus_synth if e.opus else aac_synth).init_carry(
                        e.lanes, dev)))
            else:
                self.elem_all_x.append(e.codec.decode_batch_raw(packets, T)[0])
                syn_carry.append(None)
        self.carry = {"pipe": init_carry(dec.cfg, dev), "syn": syn_carry}
        self.kinds = plan_kinds(dec)

        # Output bookkeeping: with the pre-limiter trim splice the first
        # call emits only warm-up zeros, so the kept stream starts at call
        # 1; zero-input flush calls surface the splice latency and the
        # limiter drain.
        self.want = n * T - dec.lead - dec.tail
        self.k0 = 1 if dec.cfg.head_trim else 0
        if dec.cfg.limiter is not None:
            needed = self.want + dec.cfg.limiter.delay_size
            if not dec.cfg.head_trim:
                needed = n * T + dec.cfg.limiter.delay_size
        else:
            needed = self.want + dec.lead
        self.total_calls = self.n_batches
        while (self.total_calls - self.k0) * B * T < needed:
            self.total_calls += 1

        # Opus and AAC entropy decode one batch ahead on ONE worker: the
        # codecs' inter-frame state (CELT energies, AAC window shapes)
        # chains across batches, so batches decode in submission order,
        # never concurrently.
        self.entropy_pool = (cf.ThreadPoolExecutor(1)
                             if any(e.opus or e.aac for e in dec.elems)
                             else None)
        self._pending = self._submit(0) if self.n_batches else None
        self._bi = 0
        self._flush = None

    def _host_batch(self, i, e, start, count):
        if e.opus:
            return self.dec._opus_entropy(
                e, self.elem_packets[i], start, count, self.B)
        if e.aac:
            return self.dec._aac_entropy(
                e, self.elem_packets[i], start, count, self.B)
        xs = self.elem_all_x[i][start:start + count]
        if count < self.B:
            xs = np.concatenate(
                [xs, np.zeros((self.B - count,) + xs.shape[1:], xs.dtype)])
        return xs

    def _submit(self, bi):
        start = bi * self.B
        count = min(self.B, self.n - start)
        items = []
        for i, e in enumerate(self.dec.elems):
            if e.opus or e.aac:
                items.append(self.entropy_pool.submit(
                    self._host_batch, i, e, start, count))
            else:
                items.append((i, e, start, count))
        return items

    def next_bufs(self):
        """Numpy inputs (padded to B frames) for the next call, or None for
        a trailing flush call (the caller takes flush_bufs)."""
        bi = self._bi
        self._bi += 1
        if bi >= self.n_batches:
            return None
        items = self._pending
        self._pending = (self._submit(bi + 1)
                         if bi + 1 < self.n_batches else None)
        return [self._host_batch(*it) if isinstance(it, tuple)
                else it.result() for it in items]

    def flush_bufs(self) -> list:
        """The zero input of one call, per element, as numpy (made once,
        from the plan's shapes): the trailing flush calls, and the calls of
        a served stream past its end. Opus rows keep legal comb periods
        (the JAX decoder's have period 0, ROADMAP.md §3; zero gains make
        the comb an identity either way), AAC rows are ONLY_LONG with sine
        windows (meta 0)."""
        if self._flush is None:
            B = self.B
            out = []
            for e, x in zip(self.dec.elems, self.elem_all_x):
                if e.opus:
                    z = opus_synth.neutral_rows((B, e.lanes))
                elif e.aac:
                    z = (np.zeros((B, e.lanes, aac_synth.FRAME), np.float32),
                         np.zeros((B, e.lanes, 3), np.int32))
                else:
                    z = np.zeros((B,) + x.shape[1:], x.dtype)
                out.append(z)
            self._flush = out
        return self._flush

    def close(self):
        if self.entropy_pool is not None:
            self.entropy_pool.shutdown(wait=True, cancel_futures=True)


class BatchedStreamDecoder:
    """Decode a complete in-memory IAMF stream in frame batches on
    `device`: 'cuda' (the default) runs the hand-written kernels and raises
    where no card is visible; 'cpu', asked for by name, runs their plain
    twins."""

    @classmethod
    def from_mp4(cls, path: str, start_sec: float = 0.0, **kw
                 ) -> "BatchedStreamDecoder":
        """Open IAMF in MP4 or fragmented MP4: the track is demuxed to a
        descriptor + packet OBU stream (descriptors re-emitted on a
        sample-description change, mp4iamfpar.c:111-189; a seek walks the
        sample deltas, :203-233) and decoded as one stream. kw: the
        constructor's (device included)."""
        mp4 = MP4IAMFParser(path)
        if start_sec > 0:
            mp4.seek(start_sec)
        parts = [mp4.descriptors]
        for packet, new_descriptors in mp4.packets():
            if new_descriptors:
                parts.append(new_descriptors)
            parts.append(packet)
        return cls(b"".join(parts), **kw)

    def __init__(self, data: bytes, sound_system: int = 0, bits: int = 16,
                 batch_frames: int = 128, limiter: bool = True,
                 normalization_db: float | None = None,
                 peak_threshold_db: float | None = None,
                 binaural: bool = False,
                 mix_presentation_id: int | None = None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.bits = bits
        self.batch_frames = batch_frames
        self.db = Database()
        # the follow-on segment decoder's arguments (reconfigure)
        self._init_kw = dict(
            sound_system=sound_system, bits=bits, batch_frames=batch_frames,
            limiter=limiter, normalization_db=normalization_db,
            peak_threshold_db=peak_threshold_db, binaural=binaural,
            mix_presentation_id=mix_presentation_id, device=self.device)
        self._next_data: bytes | None = None
        # each element's decode path; "segments" holds the follow-on
        # decoders' stats after a reconfigured decode_all
        self.stats: dict = {"elements": []}
        if binaural:
            self.layout = OutputLayout(type=LayoutType.BINAURAL)
        else:
            self.layout = OutputLayout(
                type=LayoutType.SS_CONVENTION, sound_system=sound_system)

        off = parser.find_sequence_header(data)
        if off < 0:
            raise ValueError("no sequence header")
        body = data[off:] if isinstance(data, bytes) else bytes(
            memoryview(data)[off:])
        recs = parser.split_records(body)
        # a non-redundant Sequence Header after the first ends this
        # segment: the rest is the follow-on decoder's (decode_all)
        seq = np.flatnonzero(
            (recs[:, 0] == 31) & ((recs[:, 1] & 1) == 0))  # SEQUENCE_HEADER
        if seq.size > 1:
            j = int(seq[1])
            self._next_data = body[int(recs[j, 2]):]
            recs = recs[:j]
        types = recs[:, 0]
        sids = recs[:, 7]
        self.frames_per_substream: dict[int, list[bytes]] = {}
        self.trims: list[tuple[int, int]] = []
        self._frame_pos = {}
        for s in np.unique(sids[sids >= 0]):
            idx = np.flatnonzero(sids == s)
            self._frame_pos[int(s)] = idx
            self.frames_per_substream[int(s)] = [
                body[recs[i, 3]: recs[i, 3] + recs[i, 4]] for i in idx]
        param_obus: list = []
        for i in np.flatnonzero((types >= 0) & (types <= 3)):
            obu = parser.split_obu(body, int(recs[i, 2]))
            if obu.type == 0:
                self.db.add_codec_config(parser.parse_codec_config(obu))
            elif obu.type == 1:
                self.db.add_element(parser.parse_audio_element(obu))
            elif obu.type == 2:
                self.db.add_mix_presentation(
                    parser.parse_mix_presentation(obu))
            else:
                param_obus.append((int(i), obu))

        mp = best_mix_presentation(self.db, self.layout, mix_presentation_id)
        if mp is None:
            raise ValueError("no mix presentation available")
        self.mix_presentation = mp
        sub = mp.sub_mixes[0]
        out_ch = self.layout.channels
        # a stream not at 48 kHz is resampled after the mix, and the
        # limiter runs after the resampler (iamf_resample
        # IAMF_decoder.c:3223-3248, then loudness :3480, limiter :3487)
        self.stream_rate = int(codec_config_sampling_rate(
            self.db.elements[sub.elements[0].element_id].codec_config))
        self.needs_resample = self.stream_rate != 48000
        device_limiter = limiter and not self.needs_resample
        self._want_limiter = limiter
        self._peak_threshold_db = peak_threshold_db
        self.frame_size = None
        self.elems: list[_ElemCtx] = []
        for econf in sub.elements:
            item = self.db.elements[econf.element_id]
            self.elems.append(
                self._open_element(item, econf, sound_system, out_ch))
        self.synths = {}
        if any(e.opus for e in self.elems):
            self.synths["opus"] = opus_synth.celt_synth(self.device)
        if any(e.aac for e in self.elems):
            self.synths["aac"] = aac_synth.Tables().to(self.device)
        out_gain_default = db_to_linear(
            q78_to_db(sub.output_mix_gain.default_mix_gain_q78))
        norm_gain = 1.0
        if normalization_db is not None:
            # loudness normalization: db2lin(norm - selected loudness)
            # (IAMF_decoder.c:3480-3484, selection :3030-3059)
            norm_gain = db_to_linear(
                normalization_db - best_loudness(mp, self.layout))
        self._norm_gain = 1.0
        if self.needs_resample:
            # the reference normalizes after resampling: the gain stays out
            # of the device out-gain and the resample tail applies it
            self._norm_gain, norm_gain = norm_gain, 1.0

        # temporal-unit events: unit u closes at the max record index among
        # the required substreams' u-th frames; its trims come from the
        # first selected substream's u-th frame
        required = [sid for e in self.elems for sid in e.substream_ids]
        first_sid = self.elems[0].substream_ids[0]
        pos = [self._frame_pos.get(sid, np.empty(0, np.int64))
               for sid in required]
        units = min((len(p) for p in pos), default=0)
        self.events: list = []
        if units:
            close_pos = np.max(np.stack([p[:units] for p in pos]), axis=0)
            f0 = self._frame_pos[first_sid][:units]
            ts0 = recs[f0, 5]
            te0 = recs[f0, 6]
            self.trims = list(zip(ts0.tolist(), te0.tolist()))
            pi = 0
            for u in range(units):
                while (pi < len(param_obus)
                       and param_obus[pi][0] < close_pos[u]):
                    self.events.append(("param", param_obus[pi][1]))
                    pi += 1
                self.events.append(("unit", int(ts0[u]), int(te0[u])))
            for _, obu in param_obus[pi:]:
                self.events.append(("param", obu))
        else:
            self.events = [("param", obu) for _, obu in param_obus]

        self.params = timeline.replay(
            self.db, self.elems, sub.elements, sub, self.events,
            self.n_frames, self.frame_size, self.stream_rate,
            out_gain_default, norm_gain,
        )

        # Edge trims (iamf_frame_trim, IAMF_decoder.c:1361-1381) happen
        # BEFORE the limiter: with a limiter the trimmed samples are zeroed
        # through a per-sample out-gain mask and the head is spliced out of
        # the mixed timeline on the device (PipelineConfig.head_trim).
        nf = self.n_frames
        self.lead = sum(t[0] for t in self.trims[:nf])
        self.tail = sum(t[1] for t in self.trims[:nf])
        T = self.frame_size
        head_trim = (self.lead if device_limiter
                     and 0 < self.lead <= batch_frames * T else 0)
        if head_trim:
            og = self.params.out_gain
            if og.ndim == 1:
                og = np.repeat(og[:, None], T, axis=1).astype(np.float32)
            else:
                og = og.copy()
            rem, u = head_trim, 0
            while rem > 0 and u < len(og):
                k = min(rem, T)
                og[u, :k] = 0.0
                rem -= k
                u += 1
            rem, u = self.tail, nf - 1
            while rem > 0 and u >= 0:
                k = min(rem, T)
                og[u, T - k:] = 0.0
                rem -= k
                u -= 1
            self.params.out_gain = og
            self.params.out_gain_per_sample = True

        self.cfg = PipelineConfig(
            frame_size=self.frame_size,
            out_channels=out_ch,
            bits=bits,
            elements=tuple(
                ElementSpec(
                    demix=e.demix_spec,
                    n_in=e.n_in,
                    n_rendered=e.render_mat.shape[1],
                    input_scale=e.input_scale,
                    render_offset=(int(getattr(e.codec, "delay", 0) or 0)
                                   if e.downmix is not None else 0),
                    skip=(int(getattr(e.codec, "delay", 0) or 0)
                          % self.frame_size if e.demix_spec is not None
                          else 0),
                    rg_index=ep.rg_index,
                    per_sample_gain=ep.gain_per_sample,
                    hrtf_taps=(e.hrtf_bank.shape[2]
                               if e.hrtf_bank is not None else 0),
                )
                for e, ep in zip(self.elems, self.params.elements)
            ),
            limiter=LimiterConfig(
                channels=out_ch,
                true_peak=os.environ.get("IAMF_TRUEPEAK") == "1",
                **({"threshold_db": peak_threshold_db}
                   if peak_threshold_db is not None else {}),
            ) if device_limiter else None,
            per_sample_out_gain=self.params.out_gain_per_sample,
            batch_frames=batch_frames,
            head_trim=head_trim,
            emit_float=self.needs_resample,
        )

    def _open_element(self, item, econf, sound_system, out_ch) -> _ElemCtx:
        stream = Stream(item, self.layout)
        el = item.element
        cc = item.codec_config
        if self.frame_size is None:
            self.frame_size = cc.nb_samples_per_frame
        elif self.frame_size != cc.nb_samples_per_frame:
            raise ValueError("batched path: mixed frame sizes")
        gain = db_to_linear(
            q78_to_db(econf.element_mix_gain.default_mix_gain_q78))

        downmix = None
        hrtf_bank = None
        binaural_hrtf = (self.layout.type == LayoutType.BINAURAL
                         and econf.headphones_rendering_mode == 1)
        if stream.scheme == ElementType.CHANNEL_BASED:
            s = stream
            codec = open_decoder(
                s.codec, cc.decoder_conf,
                sum(l.nb_substreams for l in s.layers[: s.layer + 1]),
                sum(l.nb_coupled_substreams for l in s.layers[: s.layer + 1]),
                self.frame_size,
            )
            order = s.channels_order[: s.selected_channels]
            demix_spec = DemixSpec(
                layout=s.selected_layout,
                channels_in=tuple(order),
                frame_size=self.frame_size,
                output_gains=(1.0,) * len(order),
            )
            in_layout = s.selected_layout
            # a downmix target exists only for a loudspeaker layout
            tgt = (SS_TO_LAYOUT.get(SoundSystem(sound_system))
                   if self.layout.type == LayoutType.SS_CONVENTION else None)
            if binaural_hrtf:
                # M2B: the demixed channel bed convolves with the layout's
                # HRIR bank
                render_mat = np.eye(len(order), dtype=np.float32)
                hrtf_bank = hrir_bank(in_layout, 256, 48000)
            elif (tgt is not None and s.dmx_default_mode >= 0
                    and can_downmix(in_layout, tgt)):
                mode = max(s.dmx_default_mode, 0)
                render_mat = downmix_matrix(
                    in_layout, tgt, mode, max(s.dmx_default_w_idx, 0))
                downmix = DownmixerState(in_layout, tgt)
                downmix.set_mode_weight(mode, s.dmx_default_w_idx)
            else:
                render_mat = rdr.m2m_matrix(
                    rdr.LAYER_IDS[in_layout], self.layout.render_id
                ).T.copy()
            n_in = len(order)
        else:
            # scene-based: fold mono-remap / projection into the H2M matrix
            codec = open_decoder(
                stream.codec, cc.decoder_conf,
                stream.nb_substreams, stream.nb_coupled_substreams,
                self.frame_size,
            )
            lanes = stream.nb_substreams + stream.nb_coupled_substreams
            n_amb = stream.nb_channels
            if stream.ambisonics_mode == AmbisonicsMode.PROJECTION:
                vals = np.frombuffer(stream.ambisonics_mapping,
                                     dtype=">i2").astype(np.float32) / 32768.0
                conv = vals.reshape(lanes, n_amb).T  # [n_amb, lanes]
            else:
                conv = np.zeros((n_amb, lanes), np.float32)
                for i, m in enumerate(stream.ambisonics_mapping[:n_amb]):
                    if m < lanes:
                        conv[i, m] = 1.0
            hoa_order = rdr.hoa_order_for_channels(n_amb)
            if binaural_hrtf:
                # H2B: HOA -> 7.1.2 virtual speaker bed -> HRTF conv
                virt = rdr.h2m_full_matrix(
                    hoa_order, 0x712, 10, self.layout.samsung_tv)
                render_mat = (virt @ conv).astype(np.float32)  # [10, lanes]
                hrtf_bank = hrir_bank(ChannelLayout.L712, 256, 48000)
            else:
                full = rdr.h2m_full_matrix(
                    hoa_order, self.layout.render_id, out_ch,
                    self.layout.samsung_tv)  # [out, n_amb]
                render_mat = (full @ conv).astype(np.float32)  # [out, lanes]
            demix_spec = None
            n_in = lanes

        input_scale = 1.0
        raw_input = hasattr(codec, "decode_batch_raw")
        if raw_input:
            input_scale = 1.0 / float(getattr(codec, "scale", 1.0))
        opus = False
        if hasattr(codec, "classify_packets"):
            pkts = [self.frames_per_substream.get(sid) or []
                    for sid in el.substream_ids]
            opus_mode, n_f, k_f = codec.classify_packets(
                pkts, self.frame_size)
            if (opus_mode, n_f, k_f) != ("celt", 960, 1):
                raise NotImplementedError(
                    f"Opus {opus_mode} n={n_f} k={k_f}: only CELT-960 with "
                    "one frame per unit is ported (ROADMAP.md §1 item 5)")
            opus = True
        aac = not opus and hasattr(codec, "decode_spectrum_batch")
        if aac and self.frame_size != aac_synth.FRAME:
            raise NotImplementedError(
                f"AAC with {self.frame_size}-sample frames: only 1024-sample "
                "AAC-LC frames are ported (the device filterbank)")
        self.stats["elements"].append({
            "element_id": el.element_id,
            "path": ("opus_device_celt" if opus else "aac_device" if aac
                     else "raw_device"),
            **({"opus_cfg": (opus_synth.FRAME, 1, False)} if opus else {}),
        })
        return _ElemCtx(
            stream=stream, codec=codec,
            substream_ids=list(el.substream_ids),
            demix_spec=demix_spec, render_mat=render_mat, downmix=downmix,
            n_in=n_in, input_scale=input_scale, raw_input=raw_input,
            opus=opus, aac=aac, gain=gain, hrtf_bank=hrtf_bank,
        )

    @property
    def n_frames(self) -> int:
        return min(
            len(self.frames_per_substream.get(sid, []))
            for e in self.elems for sid in e.substream_ids
        )

    def _opus_entropy(self, e: _ElemCtx, packets, start, count, B):
        """Host entropy decode of one Opus batch -> the packed buffer
        [B, L, 973] = spectra ++ 13 per-frame parameters."""
        blk = [[p[k] for p in packets] for k in range(start, start + count)]
        d = decode_spectrum_batch(e.codec, blk)
        n = opus_synth.FRAME
        buf = d["buf"]
        buf[..., n:n + opus_synth.N_PARAMS] = opus_synth.pack_params(d)
        pad = B - count
        if pad:
            buf = np.concatenate([buf, opus_synth.neutral_rows(
                (pad,) + buf.shape[1:-1])])
        return buf

    def _aac_entropy(self, e: _ElemCtx, packets, start, count, B):
        """Host entropy decode of one AAC batch -> (spectra [B, L, 1024]
        float32, (window_sequence, window_shape, previous shape) [B, L, 3]
        int32), padded with neutral rows: zero spectra, ONLY_LONG, sine."""
        blk = [[p[k] for p in packets] for k in range(start, start + count)]
        d = e.codec.decode_spectrum_batch(blk)
        meta = np.stack([d["win_seq"], d["shape"], d["prev_shape"]],
                        axis=-1).astype(np.int32)
        spec = d["spec"].astype(np.float32, copy=False)
        pad = B - count
        if pad:
            spec = np.concatenate(
                [spec, np.zeros((pad,) + spec.shape[1:], np.float32)])
            meta = np.concatenate(
                [meta, np.zeros((pad,) + meta.shape[1:], np.int32)])
        return spec, meta

    def _resample_tail(self, full, want: int) -> np.ndarray:
        """Rate-mismatch output stage, on the decoder's device: resample the
        float mix to 48 kHz (K10; the output includes the latency drain),
        apply the normalization gain, then limit (K3 over the stream and a
        delay_size drain of zeros, dropping the look-ahead) and quantize,
        or quantize alone; one copy to the host at the end. The serial
        decoder's order: iamf_resample IAMF_decoder.c:3223-3248 -> loudness
        :3480 -> limiter :3487, flush drain :3250-3301.

        full: [rows, C] float32 mix timeline of every kept call."""
        x = full[self.lead:self.lead + want].T  # [C, want]
        C = x.shape[0]
        rs = ResamplePlan(self.stream_rate, 48000, device=self.device)
        y = resample_stream(rs, x)
        if self._norm_gain != 1.0:
            # the serial path normalizes the resampler's process() outputs
            # but not its drained latency tail: split at its pre-drain count
            n_main = -(-(want - rs.input_latency) * rs.den // rs.num)
            y[:, :n_main] *= float(np.float32(self._norm_gain))
        if not self._want_limiter:
            return self._to_host(quantize_interleave(y, self.bits))
        cfg = LimiterConfig(
            channels=C,
            **({"threshold_db": self._peak_threshold_db}
               if self._peak_threshold_db is not None else {}))
        # the serial limiter's first call swallows delay_size samples and
        # its drain pushes delay_size zeros: one call over y ++ zeros with
        # the first delay_size rows dropped
        D = cfg.delay_size
        z = torch.cat([y, y.new_zeros((C, D))], dim=1)
        state = {k: v[None] for k, v in init_state(cfg, self.device).items()}
        _, pcm = limit_quantize(cfg, state, z[None], self.bits,
                                self.frame_size)
        return self._to_host(pcm[0, D:])

    def _to_host(self, pcm: torch.Tensor) -> np.ndarray:
        """One copy to the host, into pinned memory from the card."""
        cuda = pcm.is_cuda
        out = torch.empty(pcm.shape, dtype=pcm.dtype, pin_memory=cuda)
        out.copy_(pcm)
        return out.numpy()

    def decode_all(self, fetch: bool = True):
        """Decode the stream, every reconfigure segment in turn. Returns
        [samples, out_channels] int PCM on the host or, with fetch=False,
        the list of kept [B*T, out_channels] int batches still on the
        decoder's device, as the pipeline emits them: no head-trim warm-up
        call, no flush call, and so with the limiter's look-ahead head and
        without its drained tail (a resampled stream needs fetch=True).

        Segments: a non-final segment loses the last delay_size samples of
        its fetch=True output, which the reference never emits (its
        reconfigure re-inits the limiter without flushing the delay line,
        IAMF_decoder.c configure :3810), and each segment's stats go under
        stats["segments"]. With fetch=False the result is every segment's
        own batch list, one after the other, untrimmed: it holds fetch=True's
        samples only in the way one segment's batches do (the JAX decoder
        cuts the last batch of a non-final segment instead,
        iamf_tpu/core/batch_decoder.py:789-792)."""
        out = self._decode_segment(fetch)
        if self._next_data is None:
            return out
        if fetch and self.cfg.limiter is not None:
            d = self.cfg.limiter.delay_size
            out = out[:-d] if out.shape[0] > d else out[:0]
        child = BatchedStreamDecoder(self._next_data, **self._init_kw)
        nxt = child.decode_all(fetch)
        self.stats.setdefault("segments", []).append(child.stats)
        if fetch:
            return np.concatenate([out, nxt], axis=0)
        return out + nxt

    def _decode_segment(self, fetch: bool):
        """Decode this segment (decode_all's contract for one segment)."""
        B = self.batch_frames
        T = self.frame_size
        dev = self.device
        resample = self.needs_resample
        if resample and not fetch:
            raise ValueError(
                f"stream rate {self.stream_rate} != 48000: the resample tail "
                "needs fetch=True")
        plan = _HostPlan(self)
        carry = plan.carry
        rows = B * T
        cuda = dev.type == "cuda"
        # the kept calls' PCM lands in one host array; on the card each
        # batch is copied into pinned memory as soon as it is queued. A
        # resampled stream keeps its float batches on the device, and so
        # does fetch=False.
        kept = []
        full = None if resample or not fetch else torch.empty(
            ((plan.total_calls - plan.k0) * rows, self.cfg.out_channels),
            dtype=torch.int16 if self.bits == 16 else torch.int32,
            pin_memory=cuda)
        staging: dict = {}
        try:
            for call in range(plan.total_calls):
                if not fetch and call >= plan.k0 + plan.n_batches:
                    break  # the flush calls' output is not kept
                # past the stream's end: zero input, neutral params
                bufs = put_bufs([plan.next_bufs() or plan.flush_bufs()], dev,
                                staging)
                carry, out = fused_decode(self.cfg, plan.kinds, self.synths,
                                          carry, plan.stream_params, bufs)
                i = call - plan.k0
                if i < 0:
                    continue
                if full is None:
                    kept.append(out[0])
                else:
                    full[i * rows:(i + 1) * rows].copy_(out[0],
                                                        non_blocking=cuda)
            if cuda:
                torch.cuda.synchronize(dev)
        finally:
            plan.close()
        want = plan.want
        if not fetch:
            return kept
        if resample:
            return self._resample_tail(torch.cat(kept), want)
        return self.kept(full.numpy(), want)

    def kept(self, full: np.ndarray, want: int) -> np.ndarray:
        """The stream's samples in the kept calls' PCM [rows, C]: the
        limiter's look-ahead head dropped (the trailing flush calls pushed
        zeros through its delay line), then the edge trims."""
        if self.cfg.limiter is not None:
            d = self.cfg.limiter.delay_size
            if self.cfg.head_trim:
                return full[d: d + want]
            out = full[d: d + self.n_frames * self.frame_size]
            return out[self.lead: self.lead + want]
        return full[self.lead: self.lead + want]
