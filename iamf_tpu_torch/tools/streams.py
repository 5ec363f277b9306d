"""Stream builders for the smoke run and the port's tests: complete IAMF
streams made with this package's muxer (tools/builder.py).

Copies of the builders of the same names in tests/vectors.py, on this
package's builder and constants: the same arguments give byte-identical
streams (tests/test_torch_standalone.py holds them to it).
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    LAYOUT_CHANNELS_CODEC, ChannelLayout, ElementType, ParameterType,
)
from . import builder


def sine_pcm(n: int, channels: int, rate: int = 48000, amp: float = 0.5,
             freqs=None, bits: int = 16, seed: int = 0) -> np.ndarray:
    """Deterministic multitone int PCM [n, channels]."""
    if freqs is None:
        freqs = [220.0 * (k + 1) for k in range(channels)]
    t = np.arange(n) / rate
    rng = np.random.RandomState(seed)
    out = np.zeros((n, channels))
    for c in range(channels):
        phase = rng.uniform(0, 2 * np.pi)
        out[:, c] = amp * np.sin(2 * np.pi * freqs[c] * t + phase)
        out[:, c] += 0.1 * amp * np.sin(2 * np.pi * 3.1 * freqs[c] * t)
    scale = 2.0 ** (bits - 1) - 1
    return np.round(out * scale).astype(np.int64)


def _layer_substreams(layout: int) -> tuple[int, int]:
    """(nb_substreams, nb_coupled) for a single-layer channel config."""
    n = len(LAYOUT_CHANNELS_CODEC[ChannelLayout(layout)])
    if n == 1:
        return 1, 0
    if n == 2:
        return 1, 1
    coupled = (n - 2) // 2
    return coupled + 2, coupled


def build_pcm_layout_stream(
    layout: int,
    n_frames: int = 8,
    frame_size: int = 960,
    sample_size: int = 16,
    rate: int = 48000,
    amp: float = 0.5,
    demix_mode: int = 0,
    seed: int = 1,
    pcm_override: np.ndarray | None = None,
    demix_modes=None,  # per-frame demixing_mode values (param blocks)
    mix_gain_segments=None,  # per-frame element mix-gain segment dicts
    out_gain_segments=None,  # per-frame output mix-gain segment dicts
    hrm: int = 0,  # headphones_rendering_mode (1 => HRTF conv binaural)
    layout_specs=None,  # override the sub-mix LayoutSpec list
) -> tuple[bytes, np.ndarray]:
    """Single-layer channel-based ipcm stream for any IA layout.

    Gain segment dicts follow builder.parameter_block_obu's mix-gain form:
    {"animation": AnimationType, "start": q78, "end": q78, ...}.
    Returns (stream, source PCM [n, nch] in codec channel order).
    """
    nch = len(LAYOUT_CHANNELS_CODEC[ChannelLayout(layout)])
    nsub, ncoupled = _layer_substreams(layout)
    total = n_frames * frame_size
    if pcm_override is not None:
        pcm = np.asarray(pcm_override)[:total]
    else:
        pcm = sine_pcm(total, nch, rate, amp=amp, bits=sample_size, seed=seed)

    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(
        1, b"ipcm", frame_size, 0, builder.pcm_decoder_conf(sample_size, rate)
    )
    demix = None
    if nch > 2:
        demix = builder.ParamDefinition(
            id=998, rate=rate, mode=0, duration=frame_size,
            constant_segment_interval=frame_size,
        )
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1,
        substream_ids=list(range(nsub)),
        layers=[builder.LayerSpec(layout, nsub, ncoupled)],
        demix_param=demix,
        default_demix_mode=demix_mode,
        default_demix_w=0,
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1, mix_gain_param=builder.ParamDefinition(id=100),
                headphones_rendering_mode=hrm,
            )
        ],
        layouts=(layout_specs if layout_specs is not None
                 else [builder.LayoutSpec(sound_system=0),
                       builder.LayoutSpec(sound_system=1)]),
    )
    for f in range(n_frames):
        if demix_modes is not None and demix is not None:
            out += builder.parameter_block_obu(
                998, ParameterType.DEMIXING, duration=frame_size,
                constant_segment_interval=frame_size, mode=0,
                segments=[{"mode": demix_modes[f % len(demix_modes)]}],
            )
        if mix_gain_segments is not None:
            out += builder.parameter_block_obu(
                100, ParameterType.MIX_GAIN, duration=frame_size,
                constant_segment_interval=frame_size, mode=1,
                segments=[mix_gain_segments[f % len(mix_gain_segments)]],
            )
        if out_gain_segments is not None:
            out += builder.parameter_block_obu(
                999, ParameterType.MIX_GAIN, duration=frame_size,
                constant_segment_interval=frame_size, mode=1,
                segments=[out_gain_segments[f % len(out_gain_segments)]],
            )
        frame = pcm[f * frame_size : (f + 1) * frame_size]
        ch = 0
        for s in range(ncoupled):
            out += builder.audio_frame_obu(
                s, builder.pack_pcm_frame(frame[:, ch : ch + 2], sample_size)
            )
            ch += 2
        for s in range(ncoupled, nsub):
            out += builder.audio_frame_obu(
                s, builder.pack_pcm_frame(frame[:, ch : ch + 1], sample_size)
            )
            ch += 1
    return bytes(out), pcm


def build_pcm_51_stream(n_frames: int = 8, amp: float = 0.5, **kw):
    return build_pcm_layout_stream(
        ChannelLayout.L510, n_frames=n_frames, amp=amp, **kw
    )


def build_ambisonics_pcm_stream(
    order: int = 1,
    n_frames: int = 8,
    frame_size: int = 960,
    sample_size: int = 16,
    rate: int = 48000,
    amp: float = 0.4,
    projection: bool = False,
    seed: int = 11,
    target_layouts=(1, 0),
    hrm: int = 0,  # headphones_rendering_mode (1 => HRTF conv binaural)
) -> tuple[bytes, np.ndarray]:
    """Scene-based (ambisonics) ipcm stream: FOA/SOA/TOA ACN channels as
    mono substreams (mode=MONO) or coupled+mono with a Q15 demix matrix
    (mode=PROJECTION)."""
    nch = (order + 1) ** 2
    total = n_frames * frame_size

    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(
        1, b"ipcm", frame_size, 0, builder.pcm_decoder_conf(sample_size, rate)
    )
    if not projection:
        amb = {
            "mode": 0,
            "output_channel_count": nch,
            "substream_count": nch,
            "mapping": list(range(nch)),
        }
        nsub, ncoupled = nch, 0
        stream_ch = nch
    else:
        # projection: Q15 matrix [stream channels, ambisonics channels];
        # coupled substreams carry 2 channels each
        ncoupled = nch // 2
        nsub = nch - ncoupled
        stream_ch = nsub + ncoupled
        mat = np.zeros((stream_ch, nch), dtype=np.int64)
        for i in range(min(stream_ch, nch)):
            mat[i, i] = 16384  # 0.5 in Q15
        amb = {
            "mode": 1,
            "output_channel_count": nch,
            "substream_count": nsub,
            "coupled_substream_count": ncoupled,
            "mapping": mat.astype(">i2").tobytes(),
        }
    pcm = sine_pcm(total, stream_ch, rate, amp=amp, bits=sample_size, seed=seed)
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.SCENE_BASED,
        codec_config_id=1,
        substream_ids=list(range(nsub)),
        ambisonics=amb,
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1, mix_gain_param=builder.ParamDefinition(id=100),
                headphones_rendering_mode=hrm,
            )
        ],
        layouts=[builder.LayoutSpec(sound_system=ss) for ss in target_layouts],
    )
    for f in range(n_frames):
        frame = pcm[f * frame_size : (f + 1) * frame_size]
        ch = 0
        for s in range(ncoupled):
            out += builder.audio_frame_obu(
                s, builder.pack_pcm_frame(frame[:, ch : ch + 2], sample_size)
            )
            ch += 2
        for s in range(ncoupled, nsub):
            out += builder.audio_frame_obu(
                s, builder.pack_pcm_frame(frame[:, ch : ch + 1], sample_size)
            )
            ch += 1
    return bytes(out), pcm


def build_two_element_stream(
    n_frames: int = 8,
    frame_size: int = 960,
    sample_size: int = 16,
    rate: int = 48000,
    gain1_q78: int = 0,
    gain2_q78: int = 0,
    target_layouts=(0, 1),
    hrm: int = 0,  # headphones_rendering_mode for BOTH elements
) -> tuple[bytes, np.ndarray, np.ndarray]:
    """Base-profile mix: stereo channel element + FOA ambisonics element in
    one sub mix (the reference mixer path, IAMF_decoder.c:2702-2733)."""
    total = n_frames * frame_size
    pcm1 = sine_pcm(total, 2, rate, amp=0.3, bits=sample_size, seed=2)
    pcm2 = sine_pcm(total, 4, rate, amp=0.25, bits=sample_size, seed=9)

    out = bytearray()
    out += builder.sequence_header_obu(primary_profile=1, additional_profile=1)
    out += builder.codec_config_obu(
        1, b"ipcm", frame_size, 0, builder.pcm_decoder_conf(sample_size, rate)
    )
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1,
        substream_ids=[0],
        layers=[builder.LayerSpec(ChannelLayout.STEREO, 1, 1)],
    )
    out += builder.audio_element_obu(
        element_id=2,
        element_type=ElementType.SCENE_BASED,
        codec_config_id=1,
        substream_ids=[1, 2, 3, 4],
        ambisonics={
            "mode": 0,
            "output_channel_count": 4,
            "substream_count": 4,
            "mapping": [0, 1, 2, 3],
        },
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1,
                mix_gain_param=builder.ParamDefinition(id=100),
                default_mix_gain_q78=gain1_q78,
                headphones_rendering_mode=hrm,
            ),
            builder.MixElementSpec(
                element_id=2,
                mix_gain_param=builder.ParamDefinition(id=101),
                default_mix_gain_q78=gain2_q78,
                headphones_rendering_mode=hrm,
            ),
        ],
        layouts=[builder.LayoutSpec(sound_system=ss) for ss in target_layouts],
    )
    for f in range(n_frames):
        fr1 = pcm1[f * frame_size : (f + 1) * frame_size]
        fr2 = pcm2[f * frame_size : (f + 1) * frame_size]
        out += builder.audio_frame_obu(
            0, builder.pack_pcm_frame(fr1, sample_size)
        )
        for s in range(4):
            out += builder.audio_frame_obu(
                1 + s, builder.pack_pcm_frame(fr2[:, s : s + 1], sample_size)
            )
    return bytes(out), pcm1, pcm2
