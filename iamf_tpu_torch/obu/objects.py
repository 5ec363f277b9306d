"""IAMF OBU object model (host-side dataclasses).

Parsed forms of the IAMF v1.0 OBU payloads. Field semantics mirror the
reference object model (IAMF_OBU.h:80-408) but as plain immutable-ish Python
dataclasses; all parsing happens in parser.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..constants import (
    AmbisonicsMode,
    AnimationType,
    Codec,
    ElementType,
    LayoutType,
    OBUType,
    ParameterType,
    SoundSystem,
)


@dataclasses.dataclass
class OBU:
    """A split-out OBU: header fields + raw payload view (IAMF_OBU.h:80-96)."""

    type: int
    redundant: bool
    trimming: bool
    extension: bool
    trim_start: int  # num_samples_to_trim_at_start
    trim_end: int  # num_samples_to_trim_at_end
    ext_header: bytes
    payload: memoryview
    size: int  # total OBU size in bytes (header + payload)

    @property
    def is_descriptor(self) -> bool:
        return self.type in (
            OBUType.CODEC_CONFIG,
            OBUType.AUDIO_ELEMENT,
            OBUType.MIX_PRESENTATION,
            OBUType.SEQUENCE_HEADER,
        )

    @property
    def is_audio_frame(self) -> bool:
        return OBUType.AUDIO_FRAME <= self.type <= OBUType.AUDIO_FRAME_ID17


@dataclasses.dataclass
class SequenceHeader:
    """IA Sequence Header OBU (IAMF_OBU.c:260-297)."""

    iamf_code: bytes  # 4cc, must be b"iamf"
    primary_profile: int
    additional_profile: int
    redundant: bool = False


@dataclasses.dataclass
class CodecConfig:
    """Codec Config OBU (IAMF_OBU.c:303-351)."""

    codec_conf_id: int
    codec_4cc: bytes
    nb_samples_per_frame: int
    roll_distance: int  # signed
    decoder_conf: bytes
    redundant: bool = False

    @property
    def codec(self) -> Codec:
        from ..constants import CODEC_4CC

        return CODEC_4CC.get(self.codec_4cc, Codec.UNKNOWN)


@dataclasses.dataclass
class ParameterBase:
    """Parameter definition inside an element / mix presentation
    (IAMF_OBU.h:191-201, parsed at IAMF_OBU.c:358-389)."""

    type: int  # ParameterType
    id: int
    rate: int
    mode: int  # 1 => parameter blocks carry their own duration info
    duration: int = 0
    constant_segment_interval: int = 0
    nb_segments: int = 0
    segment_intervals: tuple[int, ...] = ()
    # Demixing-parameter extras (IAMF_OBU.c:469-477):
    default_mode: int = 0
    default_w: int = 0


@dataclasses.dataclass
class OutputGain:
    """Per-layer output gain info (IAMF_OBU.h:213-216)."""

    flags: int  # 6-bit channel-select flags
    gain_q78: int  # signed Q7.8 dB


@dataclasses.dataclass
class ChannelLayerConfig:
    """One scalable channel layer (IAMF_OBU.h:218-225)."""

    loudspeaker_layout: int  # ChannelLayout
    output_gain_flag: bool
    recon_gain_flag: bool
    nb_substreams: int
    nb_coupled_substreams: int
    output_gain: Optional[OutputGain] = None


@dataclasses.dataclass
class ScalableChannelConfig:
    nb_layers: int
    layers: tuple[ChannelLayerConfig, ...]


@dataclasses.dataclass
class AmbisonicsConfig:
    """Ambisonics config (IAMF_OBU.h:232-239)."""

    mode: int  # AmbisonicsMode
    output_channel_count: int
    substream_count: int
    coupled_substream_count: int
    mapping: bytes  # mono: channel->stream map; projection: Q15 BE matrix


@dataclasses.dataclass
class AudioElement:
    """Audio Element OBU (IAMF_OBU.c:391-607)."""

    element_id: int
    element_type: int  # ElementType
    codec_config_id: int
    substream_ids: tuple[int, ...]
    parameters: tuple[ParameterBase, ...]
    channels_config: Optional[ScalableChannelConfig] = None
    ambisonics_config: Optional[AmbisonicsConfig] = None
    redundant: bool = False

    @property
    def nb_substreams(self) -> int:
        return len(self.substream_ids)


@dataclasses.dataclass
class AnchorLoudness:
    anchor_element: int
    anchored_loudness: int  # signed Q7.8


@dataclasses.dataclass
class LoudnessInfo:
    """Loudness info (IAMF_defines.h:156-163)."""

    info_type: int
    integrated_loudness: int  # signed Q7.8 LKFS
    digital_peak: int  # signed Q7.8 dBFS
    true_peak: int = 0
    anchors: tuple[AnchorLoudness, ...] = ()


@dataclasses.dataclass
class Layout:
    """Target layout in a sub-mix (IAMF_OBU.h:262-273)."""

    type: int  # LayoutType
    sound_system: int = -1  # valid when type == SS_CONVENTION

    @property
    def is_binaural(self) -> bool:
        return self.type == LayoutType.BINAURAL


@dataclasses.dataclass
class MixGain:
    """Mix gain parameter definition + default (IAMF_OBU.h:275-278)."""

    base: ParameterBase
    default_mix_gain_q78: int  # signed Q7.8 dB


@dataclasses.dataclass
class ElementMixRenderConfig:
    """Per-element config in a sub-mix (IAMF_OBU.h:289-294)."""

    element_id: int
    labels: tuple[str, ...]
    headphones_rendering_mode: int
    rendering_config_extension: bytes
    element_mix_gain: MixGain


@dataclasses.dataclass
class SubMix:
    elements: tuple[ElementMixRenderConfig, ...]
    output_mix_gain: MixGain
    layouts: tuple[Layout, ...]
    loudness: tuple[LoudnessInfo, ...]


@dataclasses.dataclass
class MixPresentation:
    """Mix Presentation OBU (IAMF_OBU.c:641-932)."""

    mix_presentation_id: int
    num_labels: int
    languages: tuple[str, ...]
    labels: tuple[str, ...]
    sub_mixes: tuple[SubMix, ...]
    redundant: bool = False


@dataclasses.dataclass
class MixGainSegment:
    segment_interval: int
    animation_type: int  # AnimationType
    start_q78: int
    end_q78: int = 0
    control_q78: int = 0
    control_relative_time_q08: int = 0


@dataclasses.dataclass
class DemixingSegment:
    segment_interval: int
    demixing_mode: int


@dataclasses.dataclass
class ReconGainEntry:
    """Recon gains of one layer: bit-flags select channels in recon-channel
    order; gains are Q0.8 (IAMF_OBU.h:357-362)."""

    flags: int
    gains_q08: tuple[int, ...]


@dataclasses.dataclass
class ReconGainSegment:
    segment_interval: int
    entries: tuple[Optional[ReconGainEntry], ...]  # one per layer, None if absent


@dataclasses.dataclass
class ParameterBlock:
    """Parameter Block OBU (IAMF_OBU.c:990-1215)."""

    id: int
    duration: int
    nb_segments: int
    constant_segment_interval: int
    type: int  # ParameterType
    segments: tuple[object, ...]  # Mix/Demixing/ReconGain segments


@dataclasses.dataclass
class AudioFrame:
    """Audio Frame OBU (IAMF_OBU.c:1227-1254)."""

    substream_id: int
    trim_start: int
    trim_end: int
    data: memoryview


@dataclasses.dataclass
class TemporalDelimiter:
    pass
