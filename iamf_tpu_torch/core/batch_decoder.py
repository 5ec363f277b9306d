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

Not ported yet, and raising NotImplementedError: other Opus operating
points, SILK and hybrid included (ROADMAP.md §1 item 5), AAC with frames
other than 1024 samples, and mid-stream reconfigure segments (item 10).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
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


def fused_decode(cfg: PipelineConfig, kinds: tuple, synths: dict,
                 carry: dict, params: dict, bufs: list):
    """Codec synthesis for each element, then the decode pipeline, for one
    batch. synths: the synthesis constants by kind ("opus": CeltSynth,
    "aac": aac_synth.Tables); an AAC element's input is (spec, meta).
    Returns (carry, pcm [B*T, out] int)."""
    xs = []
    syn = []
    for i, kind in enumerate(kinds):
        if kind == "opus":
            x, s = opus_synth.synthesize_packed(synths["opus"], bufs[i],
                                                carry["syn"][i])
        elif kind == "aac":
            x, s = aac_synth.synthesize(synths["aac"], *bufs[i],
                                        carry["syn"][i])
        elif kind == "raw":
            x, s = bufs[i], carry["syn"][i]
        else:
            raise NotImplementedError(f"element kind {kind!r}")
        xs.append(x)
        syn.append(s)
    pipe, pcm = decode_frames(cfg, carry["pipe"], params, xs)
    return {"pipe": pipe, "syn": syn}, pcm


class _HostPlan:
    """Host-side plan of one decode: whole-stream parameter tensors,
    per-element input (unpacked PCM, or prefetched Opus entropy), initial
    carries, and the call/trim bookkeeping."""

    def __init__(self, dec: "BatchedStreamDecoder"):
        self.dec = dec
        B = self.B = dec.batch_frames
        T = dec.frame_size
        n = self.n = dec.n_frames
        dev = dec.device
        self.n_batches = -(-n // B)
        # +1 batch of neutral padding so the limiter drain runs past the end
        self.stream_params = stream_params(
            dec.cfg, dec.params, (self.n_batches + 1) * B, dev,
            hrtf_banks=[e.hrtf_bank for e in dec.elems])
        self.elem_packets = []
        self.elem_all_x = []
        syn_carry = []
        for e in dec.elems:
            packets = [dec.frames_per_substream[sid]
                       for sid in e.substream_ids]
            self.elem_packets.append(packets)
            if e.opus or e.aac:
                self.elem_all_x.append(None)
                syn_carry.append((opus_synth if e.opus else aac_synth)
                                 .init_carry(sum(ch for _, ch in
                                                 e.codec._decoders), dev))
            else:
                self.elem_all_x.append(e.codec.decode_batch_raw(packets, T)[0])
                syn_carry.append(None)
        self.carry = {"pipe": init_carry(dec.cfg, dev), "syn": syn_carry}
        self.kinds = tuple("opus" if e.opus else "aac" if e.aac else "raw"
                           for e in dec.elems)

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
        a trailing flush call (the caller reuses zeros)."""
        bi = self._bi
        self._bi += 1
        if bi >= self.n_batches:
            return None
        items = self._pending
        self._pending = (self._submit(bi + 1)
                         if bi + 1 < self.n_batches else None)
        return [self._host_batch(*it) if isinstance(it, tuple)
                else it.result() for it in items]

    def close(self):
        if self.entropy_pool is not None:
            self.entropy_pool.shutdown(wait=True, cancel_futures=True)


class BatchedStreamDecoder:
    """Decode a complete in-memory IAMF stream in frame batches on
    `device`: 'cuda' (the default) runs the hand-written kernels and raises
    where no card is visible; 'cpu', asked for by name, runs their plain
    twins."""

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
        seq = np.flatnonzero(
            (recs[:, 0] == 31) & ((recs[:, 1] & 1) == 0))  # SEQUENCE_HEADER
        if seq.size > 1:
            raise NotImplementedError(
                "mid-stream reconfigure segments are not ported yet "
                "(ROADMAP.md §1 item 10)")
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
            padbuf = np.zeros((pad,) + buf.shape[1:], np.float32)
            # neutral rows: zero spectra/gains, legal comb periods
            for col in (opus_synth.PK_T_OLD, opus_synth.PK_T_CUR,
                        opus_synth.PK_T_NEW):
                padbuf[..., n + col] = opus_synth.MINPERIOD
            buf = np.concatenate([buf, padbuf])
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

    @staticmethod
    def _flush_buf(kind: str, like):
        """Zero input for a trailing flush call; Opus rows keep legal comb
        periods (zero gains make the comb an identity either way), AAC rows
        are ONLY_LONG with sine windows (meta 0)."""
        if kind == "aac":
            return tuple(torch.zeros_like(t) for t in like)
        z = torch.zeros_like(like)
        if kind == "opus":
            n = opus_synth.FRAME
            for col in (opus_synth.PK_T_OLD, opus_synth.PK_T_CUR,
                        opus_synth.PK_T_NEW):
                z[..., n + col] = opus_synth.MINPERIOD
        return z

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
        _, pcm = limit_quantize(cfg, init_state(cfg, self.device), z,
                                self.bits, self.frame_size)
        return self._to_host(pcm[D:])

    def _to_host(self, pcm: torch.Tensor) -> np.ndarray:
        """One copy to the host, into pinned memory from the card."""
        cuda = pcm.is_cuda
        out = torch.empty(pcm.shape, dtype=pcm.dtype, pin_memory=cuda)
        out.copy_(pcm)
        return out.numpy()

    def decode_all(self) -> np.ndarray:
        """Decode the stream; returns [samples, out_channels] int PCM."""
        B = self.batch_frames
        T = self.frame_size
        n = self.n_frames
        dev = self.device
        plan = _HostPlan(self)
        carry = plan.carry
        rows = B * T
        cuda = dev.type == "cuda"
        resample = self.needs_resample
        # the kept calls' PCM lands in one host array; on the card each
        # batch is copied into pinned memory as soon as it is queued. A
        # resampled stream keeps its float batches on the device instead.
        floats = []
        full = None if resample else torch.empty(
            ((plan.total_calls - plan.k0) * rows, self.cfg.out_channels),
            dtype=torch.int16 if self.bits == 16 else torch.int32,
            pin_memory=cuda)
        zero_bufs = None
        try:
            for call in range(plan.total_calls):
                np_bufs = plan.next_bufs()
                if np_bufs is not None:
                    bufs = [tuple(torch.from_numpy(a).to(dev) for a in b)
                            if isinstance(b, tuple)
                            else torch.from_numpy(b).to(dev)
                            for b in np_bufs]
                    if zero_bufs is None:
                        zero_bufs = [self._flush_buf(k, b)
                                     for k, b in zip(plan.kinds, bufs)]
                else:
                    bufs = zero_bufs  # flush: zero input, neutral params
                carry, out = fused_decode(self.cfg, plan.kinds, self.synths,
                                          carry, plan.stream_params, bufs)
                i = call - plan.k0
                if i < 0:
                    continue
                if resample:
                    floats.append(out)
                else:
                    full[i * rows:(i + 1) * rows].copy_(out,
                                                        non_blocking=cuda)
            if cuda and not resample:
                torch.cuda.synchronize(dev)
        finally:
            plan.close()
        want = plan.want
        if resample:
            return self._resample_tail(torch.cat(floats), want)
        full = full.numpy()
        if self.cfg.limiter is not None:
            # limiter look-ahead: drop the first delay_size rows; the
            # trailing flush batches pushed zeros through the delay line
            d = self.cfg.limiter.delay_size
            if self.cfg.head_trim:
                return full[d: d + want]
            out = full[d: d + n * T]
            return out[self.lead: self.lead + want]
        return full[self.lead: self.lead + want]
