"""Conformance vlogger: serialize every parsed OBU to YAML text logs.

Framework equivalent of the reference SUPPORT_VERIFIER vlogging
(vlogging_tool_sr.c:298-946 per-type writers, vlog_obu :948-995): the AOM
conformance tooling diffs these logs against reference encoders. The output
is byte-identical to a `-DSUPPORT_VERIFIER=1` reference build's `-v` log
(tests/test_vlogger_diff.py pins this on the corpus), including the
reference's formatting quirks (un-padded %X md5 hex, `recon_gains_for_layer`
emitted for empty layers, the `#0`/`##` entry framing).

Enable via the player's `-v <file>` flag or vlog_stream().
"""

from __future__ import annotations

from typing import TextIO

from ..constants import OBUType, ParameterType
from ..obu import objects as o
from ..obu import parser
from ..obu.bitstream import BitReader


class _Y:
    """write_yaml_form analogue: 2-space indents, one line per call."""

    def __init__(self):
        self.lines: list[str] = []

    def w(self, indent: int, text: str) -> None:
        self.lines.append("  " * indent + text)

    def text(self) -> str:
        return "\n".join(self.lines)


def _be32(b: bytes) -> int:
    return int.from_bytes(b[:4], "big")


def _seq_header(y: _Y, idx: int, sh: o.SequenceHeader) -> None:
    y.w(0, f"IaSequenceHeaderOBU_{idx}:")
    y.w(0, f"- ia_code: {_be32(sh.iamf_code)}")
    y.w(1, f"primary_profile: {sh.primary_profile}")
    y.w(1, f"additional_profile: {sh.additional_profile}")


def _codec_config(y: _Y, idx: int, cc: o.CodecConfig) -> None:
    y.w(0, f"CodecConfigOBU_{idx}:")
    y.w(0, f"- codec_config_id: {cc.codec_conf_id}")
    y.w(1, "codec_config:")
    y.w(2, f"codec_id: {_be32(cc.codec_4cc)}")
    y.w(2, f"num_samples_per_frame: {cc.nb_samples_per_frame}")
    y.w(2, f"audio_roll_distance: {cc.roll_distance}")
    conf = cc.decoder_conf
    if cc.codec_4cc in (b"mp4a", b"esds"):
        # DecoderConfigDescriptor walk (vlogging_tool_sr.c:316-382)
        br = BitReader(conf)
        y.w(2, "decoder_config_aac:")
        y.w(3, f"decoder_config_descriptor_tag: {br.bits(8)}")
        y.w(3, f"object_type_indication: {br.bits(8)}")
        y.w(3, f"stream_type: {br.bits(6)}")
        y.w(3, f"upstream: {br.bits(1)}")
        br.bits(1)  # reserved
        br.bits(24)  # buffer_size_db
        br.bits(32)  # max_bitrate
        br.bits(32)  # average_bit_rate
        y.w(3, "decoder_specific_info:")
        y.w(4, f"decoder_specific_info_descriptor_tag: {br.bits(8)}")
        y.w(4, f"audio_object_type: {br.bits(5)}")
        if br.bits(4) == 0xF:  # sample_frequency_index
            br.bits(24)  # explicit sampling_frequency
        y.w(4, f"channel_configuration: {br.bits(4)}")
        y.w(3, "ga_specific_config:")
        y.w(4, f"frame_length_flag: {br.bits(1)}")
        y.w(4, f"depends_on_core_coder: {br.bits(1)}")
        y.w(4, f"extension_flag: {br.bits(1)}")
    elif cc.codec_4cc == b"fLaC":
        y.w(2, "decoder_config_flac:")
        y.w(3, "metadata_blocks:")
        br = BitReader(conf)
        last = 0
        while not last:
            last = br.bits(1)
            block_type = br.bits(7)
            length = br.bits(24)
            y.w(4, "- header:")
            y.w(6, f"last_metadata_block_flag: {last}")
            y.w(6, f"block_type: {block_type}")
            y.w(6, f"metadata_data_block_length: {length}")
            if block_type == 0:  # STREAMINFO
                y.w(5, "stream_info:")
                y.w(6, f"minimum_block_size: {br.bits(16)}")
                y.w(6, f"maximum_block_size: {br.bits(16)}")
                y.w(6, f"minimum_frame_size: {br.bits(24)}")
                y.w(6, f"maximum_frame_size: {br.bits(24)}")
                y.w(6, f"sample_rate: {br.bits(20)}")
                y.w(6, f"number_of_channels: {br.bits(3)}")
                y.w(6, f"bits_per_sample: {br.bits(5)}")
                # the reference reads 4 aligned bytes and shifts <<32
                # (vlogging_tool_sr.c:434-441): replicate its value exactly
                raw4 = bytes(br.read_bytes(4))
                total = int.from_bytes(raw4, "big") << 4
                total &= (1 << 36) - 1
                y.w(6, f"total_samples_in_stream: {total}")
                md5 = bytes(br.read_bytes(16))
                y.w(6, "md5_signature: "
                       + "".join(f"{b:X}" for b in md5))
            # NOTE: like the reference, non-STREAMINFO block bodies are not
            # skipped — conformance streams carry STREAMINFO only
    elif cc.codec_4cc in (b"Opus", b"dOps"):
        y.w(2, "decoder_config_opus:")
        y.w(3, f"version: {conf[0]}")
        y.w(3, f"output_channel_count: {conf[1]}")
        y.w(3, f"pre_skip: {int.from_bytes(conf[2:4], 'big')}")
        y.w(3, f"input_sample_rate: {int.from_bytes(conf[4:8], 'big')}")
        y.w(3, f"output_gain: {int.from_bytes(conf[8:10], 'big')}")
        y.w(3, f"mapping_family: {conf[10]}")
    elif cc.codec_4cc == b"ipcm":
        y.w(2, "decoder_config_lpcm:")
        y.w(3, f"sample_format_flags: {conf[0]}")
        y.w(3, f"sample_size: {conf[1]}")
        y.w(3, f"sample_rate: {int.from_bytes(conf[2:6], 'big')}")


def _param_definition(y: _Y, indent: int, base: o.ParameterBase) -> None:
    y.w(indent, "param_definition:")
    y.w(indent + 1, f"parameter_id: {base.id}")
    y.w(indent + 1, f"parameter_rate: {base.rate}")
    y.w(indent + 1, f"param_definition_mode: {base.mode}")
    if base.mode == 0:
        y.w(indent + 1, f"duration: {base.duration}")
        y.w(indent + 1, f"num_subblocks: {base.nb_segments}")
        y.w(indent + 1, "constant_subblock_duration: "
                        f"{base.constant_segment_interval}")
        if base.constant_segment_interval == 0:
            y.w(indent + 1, "subblock_durations:")
            for iv in base.segment_intervals:
                y.w(indent + 1, f"- {iv}")


def _audio_element(y: _Y, idx: int, el: o.AudioElement) -> None:
    y.w(0, f"AudioElementOBU_{idx}:")
    y.w(0, f"- audio_element_id: {el.element_id}")
    y.w(1, f"audio_element_type: {el.element_type}")
    y.w(1, f"codec_config_id: {el.codec_config_id}")
    y.w(1, f"num_substreams: {el.nb_substreams}")
    y.w(1, "audio_substream_ids:")
    for sid in el.substream_ids:
        y.w(1, f"- {sid}")
    y.w(1, f"num_parameters: {len(el.parameters)}")
    if el.parameters:
        y.w(1, "audio_element_params:")
        for p in el.parameters:
            y.w(1, f"- param_definition_type: {p.type}")
            if p.type == ParameterType.DEMIXING:
                y.w(2, "demixing_param:")
                _param_definition(y, 3, p)
                y.w(3, "default_demixing_info_parameter_data:")
                y.w(4, f"dmixp_mode: {p.default_mode}")
                y.w(3, f"default_w: {p.default_w}")
            elif p.type == ParameterType.RECON_GAIN:
                y.w(2, "recon_gain_param:")
                _param_definition(y, 3, p)
    if el.channels_config is not None:
        cf = el.channels_config
        y.w(1, "scalable_channel_layout_config:")
        y.w(2, f"num_layers: {cf.nb_layers}")
        y.w(2, "channel_audio_layer_configs:")
        for layer in cf.layers:
            y.w(2, f"- loudspeaker_layout: {layer.loudspeaker_layout}")
            y.w(3, f"output_gain_is_present_flag: "
                   f"{int(layer.output_gain_flag)}")
            y.w(3, f"recon_gain_is_present_flag: "
                   f"{int(layer.recon_gain_flag)}")
            y.w(3, f"substream_count: {layer.nb_substreams}")
            y.w(3, f"coupled_substream_count: "
                   f"{layer.nb_coupled_substreams}")
            if layer.output_gain_flag and layer.output_gain is not None:
                y.w(3, f"output_gain_flag: {layer.output_gain.flags}")
                y.w(3, f"output_gain: {layer.output_gain.gain_q78}")
    elif el.ambisonics_config is not None:
        ac = el.ambisonics_config
        y.w(1, "ambisonics_config:")
        y.w(2, f"ambisonics_mode: {ac.mode}")
        if ac.mode == 0:  # MONO
            y.w(2, "ambisonics_mono_config:")
            y.w(3, f"output_channel_count: {ac.output_channel_count}")
            y.w(3, f"substream_count: {ac.substream_count}")
            y.w(3, "channel_mapping:")
            for m in ac.mapping:
                y.w(3, f"- {m}")
        elif ac.mode == 1:  # PROJECTION
            y.w(2, "ambisonics_projection_config:")
            y.w(3, f"output_channel_count: {ac.output_channel_count}")
            y.w(3, f"substream_count: {ac.substream_count}")
            y.w(3, f"coupled_substream_count: {ac.coupled_substream_count}")
            y.w(3, "demixing_matrix:")
            raw = ac.mapping
            for i in range(0, len(raw) - 1, 2):
                v = int.from_bytes(raw[i:i + 2], "big", signed=True)
                y.w(3, f"- {v}")


def _mix_presentation(y: _Y, idx: int, mp: o.MixPresentation) -> None:
    y.w(0, f"MixPresentationOBU_{idx}:")
    y.w(0, f"- mix_presentation_id: {mp.mix_presentation_id}")
    y.w(1, f"count_label: {mp.num_labels}")
    y.w(1, "language_labels:")
    for s in mp.languages:
        y.w(1, f'- "{s}"')
    y.w(1, "mix_presentation_annotations_array:")
    for s in mp.labels:
        y.w(1, "- mix_presentation_annotations:")
        y.w(2, f'mix_presentation_friendly_label: "{s}"')
    y.w(1, f"num_sub_mixes: {len(mp.sub_mixes)}")
    y.w(1, "sub_mixes:")
    for sub in mp.sub_mixes:
        y.w(1, f"- num_audio_elements: {len(sub.elements)}")
        y.w(2, "audio_elements:")
        for e in sub.elements:
            y.w(2, f"- audio_element_id: {e.element_id}")
            y.w(3, "mix_presentation_element_annotations_array:")
            for s in e.labels:
                y.w(3, "- mix_presentation_element_annotations:")
                y.w(4, f'audio_element_friendly_label: "{s}"')
            y.w(3, "rendering_config:")
            y.w(4, f"headphones_rendering_mode: "
                   f"{e.headphones_rendering_mode}")
            y.w(4, f"rendering_config_extension_size: "
                   f"{len(e.rendering_config_extension)}")
            y.w(3, "element_mix_config:")
            y.w(4, "mix_gain:")
            _param_definition(y, 5, e.element_mix_gain.base)
            y.w(5, f"default_mix_gain: "
                   f"{e.element_mix_gain.default_mix_gain_q78}")
        y.w(2, "output_mix_config:")
        y.w(3, "output_mix_gain:")
        _param_definition(y, 4, sub.output_mix_gain.base)
        y.w(4, f"default_mix_gain: "
               f"{sub.output_mix_gain.default_mix_gain_q78}")
        y.w(2, f"num_layouts: {len(sub.layouts)}")
        y.w(2, "layouts:")
        for l, loud in zip(sub.layouts, sub.loudness):
            y.w(2, "- loudness_layout:")
            y.w(4, f"layout_type: {l.type}")
            if l.type == 2:  # SS_CONVENTION
                y.w(4, "ss_layout:")
                y.w(5, f"sound_system: {l.sound_system}")
            y.w(3, "loudness:")
            y.w(4, f"info_type: {loud.info_type}")
            y.w(4, f"integrated_loudness: {loud.integrated_loudness}")
            y.w(4, f"digital_peak: {loud.digital_peak}")
            if loud.info_type & 1:
                y.w(4, f"true_peak: {loud.true_peak}")
            if loud.info_type & 2:
                y.w(4, "anchored_loudness:")
                y.w(5, f"num_anchored_loudness: {len(loud.anchors)}")
                if loud.anchors:
                    y.w(5, "anchor_elements:")
                    for a in loud.anchors:
                        y.w(5, f"- anchor_element: {a.anchor_element}")
                        y.w(6, f"anchored_loudness: {a.anchored_loudness}")


def _parameter_block(y: _Y, idx: int, pb: o.ParameterBlock) -> None:
    y.w(0, f"ParameterBlockOBU_{idx}:")
    y.w(0, f"- parameter_id: {pb.id}")
    y.w(1, f"duration: {pb.duration}")
    y.w(1, f"num_subblocks: {pb.nb_segments}")
    y.w(1, f"constant_subblock_duration: {pb.constant_segment_interval}")
    y.w(1, "subblocks:")
    for seg in pb.segments:
        if pb.type == ParameterType.MIX_GAIN:
            y.w(1, "- mix_gain_parameter_data:")
            y.w(3, f"subblock_duration: {seg.segment_interval}")
            y.w(3, f"animation_type: {seg.animation_type}")
            y.w(3, "param_data:")
            if seg.animation_type == 0:  # STEP
                y.w(4, "step:")
                y.w(5, f"start_point_value: {seg.start_q78}")
            elif seg.animation_type == 1:  # LINEAR
                y.w(4, "linear:")
                y.w(5, f"start_point_value: {seg.start_q78}")
                y.w(5, f"end_point_value: {seg.end_q78}")
            elif seg.animation_type == 2:  # BEZIER
                y.w(4, "bezier:")
                y.w(5, f"start_point_value: {seg.start_q78}")
                y.w(5, f"end_point_value: {seg.end_q78}")
                y.w(5, f"control_point_value: {seg.control_q78}")
                y.w(5, f"control_point_relative_time: "
                       f"{seg.control_relative_time_q08 & 0xFF}")
        elif pb.type == ParameterType.DEMIXING:
            y.w(1, "- demixing_info_parameter_data:")
            y.w(3, f"subblock_duration: {seg.segment_interval}")
            y.w(3, f"dmixp_mode: {seg.demixing_mode}")
        elif pb.type == ParameterType.RECON_GAIN:
            y.w(1, "- recon_gain_info_parameter_data:")
            for entry in seg.entries:
                y.w(3, "recon_gains_for_layer:")
                if entry is None or not entry.flags:
                    continue
                gi = 0
                for k in range(12):
                    if (entry.flags >> k) & 1:
                        y.w(4, "recon_gain:")
                        y.w(5, f"key: {k}")
                        y.w(5, f"value: {entry.gains_q08[gi]}")
                        gi += 1


def _audio_frame(y: _Y, idx: int, obu: o.OBU, frame: o.AudioFrame) -> None:
    y.w(0, f"AudioFrameOBU_{idx}:")
    y.w(0, f"- audio_substream_id: {frame.substream_id}")
    y.w(1, f"num_samples_to_trim_at_start: {obu.trim_start}")
    y.w(1, f"num_samples_to_trim_at_end: {obu.trim_end}")
    y.w(1, f"size_of_audio_frame: {len(frame.data)}")


class VLogger:
    """Streaming OBU -> YAML logger matching the reference verifier.

    Maintains the descriptor context a Parameter Block needs (its
    definition's mode-0 timing and the element's recon-gain layer layout,
    exactly what the reference's OBU constructor has in scope when it calls
    vlog_obu)."""

    def __init__(self, f: TextIO):
        self.f = f
        self._count = 0
        # parameter id -> (base, nb_layers, recon_gain_flags)
        self._params: dict[int, tuple] = {}

    def _register_element(self, el: o.AudioElement) -> None:
        nb_layers = 0
        rg_flags = 0
        if el.channels_config is not None:
            nb_layers = el.channels_config.nb_layers
            for i, layer in enumerate(el.channels_config.layers):
                if layer.recon_gain_flag:
                    rg_flags |= 1 << i
        for p in el.parameters:
            self._params[p.id] = (p, nb_layers, rg_flags)

    def _register_mix(self, mp: o.MixPresentation) -> None:
        for sub in mp.sub_mixes:
            for e in sub.elements:
                self._params.setdefault(
                    e.element_mix_gain.base.id,
                    (e.element_mix_gain.base, 0, 0))
            self._params.setdefault(
                sub.output_mix_gain.base.id,
                (sub.output_mix_gain.base, 0, 0))

    def log_obu(self, obu: o.OBU) -> None:
        y = _Y()
        t = obu.type
        if t == OBUType.SEQUENCE_HEADER:
            _seq_header(y, self._count, parser.parse_sequence_header(obu))
        elif t == OBUType.CODEC_CONFIG:
            _codec_config(y, self._count, parser.parse_codec_config(obu))
        elif t == OBUType.AUDIO_ELEMENT:
            el = parser.parse_audio_element(obu)
            self._register_element(el)
            _audio_element(y, self._count, el)
        elif t == OBUType.MIX_PRESENTATION:
            mp = parser.parse_mix_presentation(obu)
            self._register_mix(mp)
            _mix_presentation(y, self._count, mp)
        elif t == OBUType.PARAMETER_BLOCK:
            pid = parser.peek_parameter_block_id(obu)
            ctx = self._params.get(pid)
            if ctx is None:
                return  # undeclared parameter: reference skips it too
            base, nb_layers, rg_flags = ctx
            pb = parser.parse_parameter_block(obu, base, nb_layers, rg_flags)
            _parameter_block(y, self._count, pb)
        elif t == OBUType.TEMPORAL_DELIMITER:
            y.w(0, f"TemporalDelimiterOBU_{self._count}:")
        elif obu.is_audio_frame:
            _audio_frame(y, self._count, obu, parser.parse_audio_frame(obu))
        else:
            return
        self.f.write("#0\n")
        self.f.write(y.text())
        self.f.write("\n##\n")
        self._count += 1


def vlog_stream(data: bytes, out: TextIO) -> int:
    """Log every OBU in a bitstream; returns logged OBU count."""
    off = max(parser.find_sequence_header(data), 0)
    v = VLogger(out)
    for obu in parser.iter_obus(memoryview(data)[off:]):
        v.log_obu(obu)
    return v._count
