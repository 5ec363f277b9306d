"""Public decoder API: the frame-serial decoder (counterpart of
iamf_tpu/api.py).

Equivalent of include/IAMF_decoder.h: open/configure/decode/close, output
layout & binaural setters, mix presentation selection, loudness
normalization, bit depth, peak limiter controls, PTS + extradata metadata.
Orchestration mirrors IAMF_decoder.c (configure :3759-3913, decode
:3303-3525, flush/delay drain :3250-3301), one access unit a call.

``IAMFDecoder(device="cuda")`` is the default and raises when no card is
visible; ``device="cpu"`` runs the kernels' plain twins. Bytes, the codec
decode, the parameter timelines and the resampler stay on the host; a
frame goes to the device once (core/stream.py) and stays there through
the demix, the render, the mix gains and the limiter, which quantizes in
the same launch (dsp/limiter.Limiter: K3, and K9 first with
IAMF_TRUEPEAK=1; the binaural render is K8). The frame's int PCM comes
back in one copy, its only wait on the device; ``decode`` returns host
numpy arrays, as the reference does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .constants import (
    ElementType,
    LayoutType,
    OBUType,
    ParameterType,
    SoundSystem,
    db_to_linear,
    q78_to_db,
)
from .core.database import Database, MixGainUnit, time_transform
from .core.stream import (OutputLayout, Stream, StreamDecoder,
                          StreamRenderer, to_device)
from .device import resolve_device
from .dsp.limiter import Limiter, LimiterConfig
from .dsp.quantize import quantize_interleave
from .dsp.resample import Resampler
from .obu import objects as o
from .obu import parser
from .utils import trace

OUTPUT_SAMPLERATE = 48000


class IAMFError(Exception):
    pass


class InvalidState(IAMFError):
    """New sequence header mid-stream: caller must reconfigure
    (IAMF_ERR_INVALID_STATE analogue)."""


@dataclasses.dataclass
class DecodedFrame:
    """One decoded access unit of output PCM."""

    pcm: np.ndarray  # [samples, channels] int (bit_depth quantized)
    samples: int
    pts: int = 0


@dataclasses.dataclass
class ExtraData:
    """IAMF_extradata analogue (player .met sidecar, vlogging)."""

    output_sound_system: int = -1
    number_of_samples: int = 0
    bitdepth: int = 16
    sampling_rate: int = OUTPUT_SAMPLERATE
    output_sound_mode: int = -1
    loudness_layouts: tuple = ()
    loudness: tuple = ()
    num_parameters: int = 0
    dmixp_mode: int = -1


class IAMFDecoder:
    """IAMF stream decoder (IAMF_decoder_open/configure/decode/close) on
    `device` ('cuda' by default, or 'cpu')."""

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self.db = Database()
        self.layout = OutputLayout(type=LayoutType.SS_CONVENTION, sound_system=0)
        self.bit_depth = 16
        self.sampling_rate = OUTPUT_SAMPLERATE
        self.normalization_loudness: Optional[float] = None  # dB LKFS
        self.limiter_enabled = True
        self.threshold_db = -1.0
        self.mix_presentation_id: Optional[int] = None
        self.samsung_tv = False
        # H2M LFE synthesis from W (analogue of a DISABLE_LFE_HOA=0
        # reference build, ae_rdr.h:63-65 / h2m_rdr.c:1198-1238);
        # default off to match the reference's default build
        self.lfe_hoa = False

        self.limiter: Optional[Limiter] = None
        self.resampler: Optional[Resampler] = None
        self.streams: list[Stream] = []
        self.decoders: list[StreamDecoder] = []
        self.renderers: list[StreamRenderer] = []
        self.presentation: Optional[o.MixPresentation] = None
        self.output_gain_pid: Optional[int] = None
        self.loudness_db = 1.0  # selected loudness (q_to_float of selected)
        self.configured = False
        self._magic_found = False
        self._have_config = False
        self._status = "init"
        self.pts = 0
        self.pts_time_base = 90000
        self.metadata = ExtraData()
        # SR-style golden intermediate taps (reference IAMF_debug_sr.c):
        # when enabled, per-element decoded/rendered and final mixed float
        # frames accumulate for stage-by-stage comparison.
        self.stream_log = False
        self._logs_rec: dict = {}
        self._logs_ren: dict = {}
        self._logs_mix: list = []

    # ------------------------------------------------------------------
    # setters (IAMF_decoder.c:3948-4130)
    # ------------------------------------------------------------------

    def set_sound_system(self, ss: int) -> None:
        self.layout = OutputLayout(
            type=LayoutType.SS_CONVENTION, sound_system=ss, samsung_tv=self.samsung_tv
        )

    def set_binaural(self) -> None:
        self.layout = OutputLayout(type=LayoutType.BINAURAL, samsung_tv=self.samsung_tv)

    def set_mix_presentation_id(self, mid: int) -> None:
        self.mix_presentation_id = mid

    def set_normalization_loudness(self, loudness_db: float) -> None:
        self.normalization_loudness = loudness_db

    def set_bit_depth(self, bits: int) -> None:
        assert bits in (16, 24, 32)
        self.bit_depth = bits

    def set_peak_limiter_enable(self, enable: bool) -> None:
        self.limiter_enabled = enable

    def set_peak_limiter_threshold(self, db: float) -> None:
        self.threshold_db = db

    def set_sampling_rate(self, rate: int) -> None:
        self.sampling_rate = rate

    def set_pts(self, pts: int, time_base: int) -> None:
        self.pts = pts
        self.pts_time_base = time_base

    def set_hoa_lfe_synthesis(self, enable: bool) -> None:
        """Enable the H2M LFE-synthesis branch (120 Hz biquad on W into
        the LFE slots) — the runtime analogue of building the reference
        with -DDISABLE_LFE_HOA=0 (ae_rdr.h:63-65)."""
        self.lfe_hoa = enable

    def get_last_metadata(self) -> ExtraData:
        return self.metadata

    @staticmethod
    def layout_sound_system_channels_count(ss: int) -> int:
        """IAMF_layout_sound_system_channels_count (IAMF_decoder.c:3998)."""
        from .constants import SOUND_SYSTEM_CHANNEL_COUNT, SoundSystem

        try:
            return SOUND_SYSTEM_CHANNEL_COUNT[SoundSystem(ss)]
        except (ValueError, KeyError):
            return -1

    @staticmethod
    def layout_binaural_channels_count() -> int:
        return 2

    @staticmethod
    def get_codec_capability() -> str:
        """Supported-codec capability list, one `iamf.<primary>.<additional>
        .<4cc>` entry per codec (IAMF_decoder_get_codec_capability,
        IAMF_decoder.c:4038-4086; profiles from CMakeLists.txt:11-12)."""
        return ";".join(
            f"iamf.001.001.{c}" for c in ("Opus", "mp4a.40.2", "ipcm",
                                          "fLaC"))

    def write_stream_logs(self, out_dir: str) -> list:
        """Write SR-style per-stage wav taps (requires stream_log=True)."""
        return _write_stream_logs(self, out_dir)

    # ------------------------------------------------------------------
    # configure
    # ------------------------------------------------------------------

    def configure(self, data: Optional[bytes]) -> int:
        """Ingest descriptor OBUs; returns bytes consumed. Raises IAMFError
        if descriptors are incomplete (caller supplies more data).

        data=None re-configures with the already-ingested descriptors —
        the reference's IAMF_decoder_configure(dec, NULL, 0, 0) used by the
        -test_soundsystem soak after an output-layout change
        (player_test_sound_system, iamfplayer.c:513-516); compatible
        streams keep their codec/demix state (iamf_presentation_reuse_
        stream, IAMF_decoder.c:1481-1525)."""
        if data is None:
            if not self._have_config:
                raise IAMFError("no descriptors to reconfigure with")
            self._enable_presentation(reuse=True)
            return 0
        if self._status in ("receive", "reconfigure"):
            # configure WITH data after frames have flowed (mid-stream
            # non-redundant sequence header): the reference RESETS the
            # object database and re-ingests from scratch
            # (iamf_decoder_internal_configure :3800-3807
            # iamf_database_reset + iamf_database_init), so stale
            # same-id descriptors never shadow the new ones. The limiter
            # re-init happens in _enable_presentation.
            self.db = Database()
            self._magic_found = False
            self._have_config = False
            self._status = "configure"
        pos = 0
        if not self._magic_found:
            off = parser.find_sequence_header(data)
            if off < 0:
                raise IAMFError("no sequence header found")
            pos = off

        flags = set()
        while pos < len(data):
            obu = parser.split_obu(data, pos)
            if obu is None:
                break
            if obu.redundant and self._have_config:
                pos += obu.size
                continue
            if obu.is_descriptor:
                self._add_descriptor(obu)
                flags.add(obu.type)
                if obu.type == OBUType.SEQUENCE_HEADER:
                    self._magic_found = True
                pos += obu.size
            else:
                self._have_config = True
                break

        if not self._have_config:
            needed = {
                OBUType.SEQUENCE_HEADER,
                OBUType.CODEC_CONFIG,
                OBUType.AUDIO_ELEMENT,
                OBUType.MIX_PRESENTATION,
            }
            have = (
                (self.db.version is not None)
                and self.db.codec_configs
                and self.db.elements
                and self.db.mix_presentations
            )
            if not have:
                raise IAMFError("incomplete descriptors")
            self._have_config = True

        self._enable_presentation()
        return pos

    def _add_descriptor(self, obu: o.OBU) -> None:
        if obu.type == OBUType.SEQUENCE_HEADER:
            self.db.add_sequence_header(parser.parse_sequence_header(obu))
        elif obu.type == OBUType.CODEC_CONFIG:
            self.db.add_codec_config(parser.parse_codec_config(obu))
        elif obu.type == OBUType.AUDIO_ELEMENT:
            self.db.add_element(parser.parse_audio_element(obu))
        elif obu.type == OBUType.MIX_PRESENTATION:
            self.db.add_mix_presentation(parser.parse_mix_presentation(obu))

    # presentation selection (IAMF_decoder.c:2997-3109) — scoring shared
    # with the batched decoder (core/presentation.py)

    def _layout_match_score(self, target: o.Layout) -> int:
        from .core.presentation import layout_match_score

        return layout_match_score(self.layout, target)

    def _best_mix_presentation(self) -> Optional[o.MixPresentation]:
        from .core.presentation import best_mix_presentation

        return best_mix_presentation(
            self.db, self.layout, self.mix_presentation_id)

    def _best_loudness(self, mp: o.MixPresentation) -> float:
        from .core.presentation import best_loudness

        return best_loudness(mp, self.layout)

    def _enable_presentation(self, reuse: bool = False) -> None:
        mp = self._best_mix_presentation()
        if mp is None:
            raise IAMFError("no mix presentation available")
        self.presentation = mp
        sub = mp.sub_mixes[0]

        # stream reuse across reconfigure: keep the codec/demix state of
        # elements whose decode config is unchanged by the new layout
        # (iamf_presentation_reuse_stream, IAMF_decoder.c:1481-1525)
        old = {}
        if reuse:
            old = {s.element_id: (s, d)
                   for s, d in zip(self.streams, self.decoders)}

        self.streams = []
        self.decoders = []
        self.renderers = []
        for econf in sub.elements:
            item = self.db.elements.get(econf.element_id)
            if item is None:
                raise IAMFError(f"unknown element {econf.element_id}")
            # element mix gain parameter (+default)
            rate = item.codec_config and 0
            from .core.database import codec_config_sampling_rate

            rate = codec_config_sampling_rate(item.codec_config)
            pi = self.db.add_parameter_definition(
                econf.element_mix_gain.base, -1, rate
            )
            pi.default_mix_gain = db_to_linear(
                q78_to_db(econf.element_mix_gain.default_mix_gain_q78)
            )
            item.mix_gain = pi

            stream = Stream(item, self.layout)
            prev = old.get(econf.element_id)
            same_cfg = False
            if prev is not None:
                if stream.scheme == ElementType.CHANNEL_BASED:
                    same_cfg = (prev[0].selected_layout
                                == stream.selected_layout)
                else:
                    same_cfg = True  # ambisonics decode is layout-agnostic
            if same_cfg:
                # same decode config: adopt the old decoder (codec overlap
                # windows, demixer smoothing, delay bookkeeping) and carry
                # the timestamp; only the renderer is layout-dependent
                stream.timestamp = prev[0].timestamp
                stream.trimming_start = prev[0].trimming_start
                stream.trimming_end = prev[0].trimming_end
                if hasattr(prev[0], "dmx_mode"):
                    stream.dmx_mode = prev[0].dmx_mode
                dec = prev[1]
                dec.stream = stream
            else:
                dec = StreamDecoder(stream, self.db, device=self.device)
            self.streams.append(stream)
            self.decoders.append(dec)
            self.renderers.append(
                StreamRenderer(stream, econf.headphones_rendering_mode,
                               lfe_hoa=self.lfe_hoa, device=self.device)
            )

        # output mix gain
        out_pi = self.db.add_parameter_definition(
            sub.output_mix_gain.base, -1, self.streams[0].sampling_rate
        )
        out_pi.default_mix_gain = db_to_linear(
            q78_to_db(sub.output_mix_gain.default_mix_gain_q78)
        )
        self.output_gain_pid = sub.output_mix_gain.base.id

        # limiter
        if self.limiter_enabled:
            self.limiter = Limiter(
                LimiterConfig(
                    threshold_db=self.threshold_db,
                    sample_rate=self.sampling_rate,
                    channels=self.layout.channels,
                    # USE_TRUEPEAK compile gate (audio_effect_peak_limiter
                    # .h:38, default off) exposed as a runtime flag like
                    # the other reference build options
                    true_peak=os.environ.get("IAMF_TRUEPEAK") == "1",
                ),
                device=self.device,
            )
        else:
            self.limiter = None

        # resampler when the stream rate differs from the output rate
        # (iamf_stream_resampler_open, IAMF_decoder.c:1892-1916)
        if self.streams[0].sampling_rate != self.sampling_rate:
            self.resampler = Resampler(
                channels=self.layout.channels,
                in_rate=self.streams[0].sampling_rate,
                out_rate=self.sampling_rate,
            )
        else:
            self.resampler = None

        self.loudness_db = self._best_loudness(mp)
        self.db.parameters_clear_segments()
        self.configured = True
        self._status = "receive"

        self.metadata = ExtraData(
            output_sound_system=(
                self.layout.sound_system
                if self.layout.type == LayoutType.SS_CONVENTION
                else -1
            ),
            bitdepth=self.bit_depth,
            sampling_rate=OUTPUT_SAMPLERATE,
            loudness_layouts=sub.layouts,
            loudness=sub.loudness,
            num_parameters=int(
                any(
                    self.db.elements[e.element_id].demixing is not None
                    for e in sub.elements
                    if e.element_id in self.db.elements
                )
            ),
        )

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _parse_obus(self, data: bytes) -> tuple[int, bool]:
        """iamf_decoder_internal_parse_OBUs (:2871-2932). Returns (consumed,
        run: all substream packets present)."""
        pos = 0
        run = False
        while pos < len(data):
            obu = parser.split_obu(data, pos)
            if obu is None:
                break
            if obu.type == OBUType.PARAMETER_BLOCK:
                pid = parser.peek_parameter_block_id(obu)
                pi = self.db.parameters.get(pid)
                if pi is not None:
                    elem = self.db.element_by_parameter(pid)
                    nb_layers = 0
                    rg_flags = 0
                    if (
                        elem is not None
                        and elem.element_type == ElementType.CHANNEL_BASED
                        and elem.channels_config is not None
                    ):
                        nb_layers = elem.channels_config.nb_layers
                        for i, layer in enumerate(elem.channels_config.layers):
                            if layer.recon_gain_flag:
                                rg_flags |= 1 << i
                    block = parser.parse_parameter_block(
                        obu, pi.base, nb_layers, rg_flags
                    )
                    self.db.add_parameter_block(block, obu.redundant)
                    # prepare: push demix/recon values into stream decoders
                    if elem is not None:
                        for dec in self.decoders:
                            if dec.stream.element_id == elem.element_id:
                                dec.update_parameter(self.db, pid)
            elif obu.is_audio_frame:
                frame = parser.parse_audio_frame(obu)
                self._deliver(frame)
                run = all(d.packet_ready for d in self.decoders)
            elif obu.type == OBUType.SEQUENCE_HEADER and not obu.redundant:
                self._status = "reconfigure"
                raise InvalidState("new sequence header: reconfigure required")
            pos += obu.size
            if run:
                break
        return pos, run

    def _deliver(self, frame: o.AudioFrame) -> None:
        for i, stream in enumerate(self.streams):
            idx = self.db.substream_index(stream.element_id, frame.substream_id)
            if idx > -1:
                if idx == 0:
                    stream.trimming_start = frame.trim_start
                    stream.trimming_end = frame.trim_end
                self.decoders[i].receive_packet(idx, frame)
                return

    @trace.spanned("serial.decode")
    def decode(self, data: Optional[bytes]) -> tuple[int, Optional[np.ndarray]]:
        """Decode one access unit. data=None flushes.

        Returns (consumed_bytes, pcm [samples, channels] int or None), the
        pcm a host numpy array.
        Raises InvalidState on a mid-stream new sequence header.
        """
        if not self.configured:
            raise IAMFError("decoder not configured")

        consumed = 0
        run = False
        if data:
            consumed, run = self._parse_obus(data)
            if not run:
                return consumed, None

        flushing = data is None
        pending_delay = self.decoders and self.decoders[0].delay > 0

        out_pcm = None
        if data or pending_delay:
            out_pcm = self._decode_frame(flushing)

        if flushing:
            tail = self._drain_delays()
            if tail is not None:
                if out_pcm is not None and out_pcm.shape[0] > 0:
                    out_pcm = np.concatenate([out_pcm, tail], axis=0)
                else:
                    out_pcm = tail

        return consumed, out_pcm

    def _decode_frame(self, flushing: bool) -> Optional[np.ndarray]:
        """Steady-state access unit decode (iamf_decoder_internal_decode
        :3335-3505)."""
        mixed = None
        frame_samples = 0
        pts = 0
        rate = self.streams[0].sampling_rate

        for i, dec in enumerate(self.decoders):
            stream = self.streams[i]
            renderer = self.renderers[i]

            f_pts = stream.timestamp
            if dec.delay > 0:
                f_pts -= dec.delay

            strim, etrim = dec.strim, dec.etrim
            try:
                with trace.span("serial.codec"):
                    x = dec.decode()
                if self.stream_log:
                    self._logs_rec.setdefault(stream.element_id, []).append(
                        x.cpu().numpy().copy()
                    )
            except (ValueError, NotImplementedError):
                dec.finish_frame()
                stream.timestamp += dec.frame_size
                continue
            dec.finish_frame()
            ret = dec.frame_size

            if strim == dec.frame_size or etrim == dec.frame_size:
                # whole frame trimmed away
                stream.timestamp += dec.frame_size
                continue

            if dec.frame_padding > 0:
                etrim += dec.frame_padding

            renderer.offset = dec.delay if dec.delay > 0 else 0
            if stream.trimming_start:
                renderer.offset = 0
            with trace.span("serial.render"):
                y = renderer.render(x, ret)
            if self.stream_log:
                self._logs_ren.setdefault(stream.element_id, []).append(
                    y.cpu().numpy().copy()
                )

            if flushing:
                etrim = dec.frame_size - max(dec.delay, 0)
                dec.delay = 0

            # trim (iamf_frame_trim :1361-1381)
            samples = y.shape[1]
            start_ext = stream.trimming_start - strim
            if (
                (strim and strim < dec.frame_size)
                or (etrim and etrim < dec.frame_size)
                or stream.trimming_start
            ):
                delay = dec.delay
                if etrim > 0 and delay > 0:
                    if delay > etrim:
                        dec.delay = delay - etrim
                        etrim = 0
                    else:
                        etrim -= delay
                        dec.delay = 0
                s = strim + max(start_ext, 0)
                keep = samples - s - etrim
                if keep < 0:
                    stream.timestamp += dec.frame_size
                    continue
                y = y[:, s : s + keep]
                f_pts += strim
                samples = keep

            if i == 0 and strim > 0:
                self.pts += time_transform(strim, rate, self.pts_time_base)

            if samples <= 0:
                stream.timestamp += dec.frame_size
                continue

            with trace.span("serial.render"):
                # element mix gain
                item = self.db.elements.get(stream.element_id)
                if item is not None and item.mix_gain is not None:
                    unit = item.mix_gain.get_mix_gain_unit(f_pts, samples,
                                                           rate)
                    y = _apply_gain(y, unit)

                if item is not None and item.demixing is not None:
                    if stream.dmx_mode >= 0:
                        self.metadata.dmixp_mode = stream.dmx_mode

                if mixed is None:
                    mixed = y
                    frame_samples = samples
                    pts = f_pts
                elif samples == frame_samples:
                    mixed = mixed + y

            stream.timestamp += dec.frame_size

        if mixed is None:
            return None

        with trace.span("serial.render"):
            # output mix gain
            if self.output_gain_pid is not None:
                pi = self.db.parameters.get(self.output_gain_pid)
                if pi is not None:
                    unit = pi.get_mix_gain_unit(pts, frame_samples, rate)
                    mixed = _apply_gain(mixed, unit)

        self.db.parameters_time_elapse(frame_samples, rate)

        if self.resampler is not None:
            # the speexdsp state machine runs on the host (numpy, float64
            # accumulators), as the reference's serial decoder does
            mixed = to_device(self.resampler.process(mixed.cpu().numpy()),
                              self.device)

        if self.normalization_loudness is not None:
            gain = db_to_linear(self.normalization_loudness - self.loudness_db)
            if gain != 1.0:
                mixed = mixed * float(np.float32(gain))

        if self.stream_log:
            self._logs_mix.append(mixed.cpu().numpy().copy())

        return self._limit_quantize(mixed)

    def _drain_delays(self) -> Optional[np.ndarray]:
        """Flush resampler + limiter latency (iamf_delay_buffer_handle
        :3250-3301)."""
        if self.limiter is None and self.resampler is None:
            return None
        channels = self.layout.channels
        tail = np.zeros((channels, 0), dtype=np.float32)
        if self.resampler is not None:
            res_tail = self.resampler.drain()
            if res_tail is not None and res_tail.shape[1]:
                tail = res_tail
        if self.limiter is not None:
            pad = np.zeros((channels, self.limiter.cfg.delay_size), dtype=np.float32)
            x = to_device(np.concatenate([tail, pad], axis=1), self.device)
            out = self._limit_quantize(x)
            return out if out.shape[0] else None
        if tail.shape[1] == 0:
            return None
        return self._limit_quantize(to_device(tail, self.device))

    @trace.spanned("serial.limit")
    def _limit_quantize(self, x: torch.Tensor) -> np.ndarray:
        """Limiter (when on) and quantize/interleave on the device, then the
        int PCM to the host in one copy: [samples, channels or 12]."""
        stride = 12 if self.samsung_tv else 0
        if self.limiter is not None:
            pcm = self.limiter.process(x, self.bit_depth, stride)
        else:
            pcm = quantize_interleave(x, self.bit_depth, stride)
        return _to_host(pcm)


def _write_stream_logs(dec: "IAMFDecoder", out_dir: str) -> list:
    """Dump accumulated stage taps as float32 wavs (rec_/ren_/mix_ naming
    mirroring iamf_rec/ren/mix_stream_log, IAMF_debug_sr.c:74-167)."""
    import os

    from .utils.wav import write_wav

    written = []
    os.makedirs(out_dir, exist_ok=True)

    def dump(name, frames):
        if not frames:
            return
        x = np.concatenate(frames, axis=1)  # [ch, samples]
        pcm = np.clip(np.rint(x.T * 32768.0), -32768, 32767).astype(np.int16)
        path = os.path.join(out_dir, name)
        write_wav(path, pcm, 48000, 16)
        written.append(path)

    for eid, frames in dec._logs_rec.items():
        dump(f"rec_{eid}.wav", frames)
    for eid, frames in dec._logs_ren.items():
        dump(f"ren_{eid}.wav", frames)
    dump("mix.wav", dec._logs_mix)
    return written


def _apply_gain(y: torch.Tensor, unit: MixGainUnit) -> torch.Tensor:
    if unit.gains is not None:
        return y * to_device(unit.gains[None, : y.shape[1]], y.device)
    if unit.constant_gain != 1.0 and unit.constant_gain > 0.0:
        return y * float(np.float32(unit.constant_gain))
    return y


def _to_host(pcm: torch.Tensor) -> np.ndarray:
    """The frame's int PCM to the host: from the card one blocking copy
    into pinned memory (the frame's only wait on the device)."""
    if not pcm.is_cuda:
        return pcm.numpy()
    out = torch.empty(pcm.shape, dtype=pcm.dtype, pin_memory=True)
    out.copy_(pcm)
    return out.numpy()
