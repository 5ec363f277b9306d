"""Core IAMF constants, enums, and channel/layout tables (a copy of
iamf_tpu/constants.py).

Semantics follow AOM IAMF v1.0 as realized by the reference decoder
(libiamf):
  - OBU types: IAMF_OBU.h:47-58
  - Sound systems: IAMF_defines.h:62-78
  - IA channel layouts: IAMF_defines.h:196-209
  - Channel enums + per-layout orders: IAMF_types.h:61-90, IAMF_utils.c:117-196
  - Mix (demix) factor table: IAMF_utils.c:236-244
  - w-index walk table: fixedp11_5.c:79-99
"""

from __future__ import annotations

import enum


class OBUType(enum.IntEnum):
    CODEC_CONFIG = 0
    AUDIO_ELEMENT = 1
    MIX_PRESENTATION = 2
    PARAMETER_BLOCK = 3
    TEMPORAL_DELIMITER = 4
    AUDIO_FRAME = 5
    # AUDIO_FRAME_ID0 .. AUDIO_FRAME_ID17 occupy 6..23
    AUDIO_FRAME_ID0 = 6
    AUDIO_FRAME_ID17 = 23
    SEQUENCE_HEADER = 31


DESCRIPTOR_OBU_TYPES = frozenset(
    {
        OBUType.CODEC_CONFIG,
        OBUType.AUDIO_ELEMENT,
        OBUType.MIX_PRESENTATION,
        OBUType.SEQUENCE_HEADER,
    }
)


class ElementType(enum.IntEnum):
    CHANNEL_BASED = 0
    SCENE_BASED = 1


class AmbisonicsMode(enum.IntEnum):
    MONO = 0
    PROJECTION = 1


class ParameterType(enum.IntEnum):
    MIX_GAIN = 0
    DEMIXING = 1
    RECON_GAIN = 2


class AnimationType(enum.IntEnum):
    STEP = 0
    LINEAR = 1
    BEZIER = 2


class LayoutType(enum.IntEnum):
    NOT_DEFINED = 0
    RESERVED = 1
    SS_CONVENTION = 2  # loudspeakers sound-system convention
    BINAURAL = 3


class SoundSystem(enum.IntEnum):
    """BS.2051 sound systems A-J plus IAMF extensions."""

    A = 0  # 0+2+0 stereo
    B = 1  # 0+5+0
    C = 2  # 2+5+0
    D = 3  # 4+5+0
    E = 4  # 4+5+1
    F = 5  # 3+7+0
    G = 6  # 4+9+0
    H = 7  # 9+10+3
    I = 8  # 0+7+0
    J = 9  # 4+7+0
    EXT_712 = 10  # 2+7+0
    EXT_312 = 11  # 2+3+0
    MONO = 12  # 0+1+0


class ChannelLayout(enum.IntEnum):
    """IA scalable channel layout type (loudspeaker_layout 4-bit field)."""

    MONO = 0
    STEREO = 1
    L510 = 2
    L512 = 3
    L514 = 4
    L710 = 5
    L712 = 6
    L714 = 7
    L312 = 8
    BINAURAL = 9


class Codec(enum.IntEnum):
    UNKNOWN = 0
    OPUS = 1
    AAC = 2
    FLAC = 3
    PCM = 4


CODEC_4CC = {
    b"Opus": Codec.OPUS,
    b"mp4a": Codec.AAC,
    b"fLaC": Codec.FLAC,
    b"ipcm": Codec.PCM,
}
CODEC_NAMES = {
    Codec.OPUS: "OPUS",
    Codec.AAC: "AAC-LC",
    Codec.FLAC: "FLAC",
    Codec.PCM: "PCM",
}


class Profile(enum.IntEnum):
    SIMPLE = 0
    BASE = 1


class Channel(enum.IntEnum):
    """Individual loudspeaker channel identities (IAMF_types.h:61-90)."""

    INVALID = 0
    L7 = 1  # also L5
    R7 = 2  # also R5
    C = 3
    LFE = 4
    SL7 = 5
    SR7 = 6
    BL7 = 7
    BR7 = 8
    HFL = 9
    HFR = 10
    HBL = 11
    HBR = 12
    MONO = 13
    L2 = 14
    R2 = 15
    TL = 16
    TR = 17
    L3 = 18
    R3 = 19
    SL5 = 20
    SR5 = 21
    HL = 22
    HR = 23

    # aliases
    @classmethod
    def L5(cls):
        return cls.L7

    @classmethod
    def R5(cls):
        return cls.R7


CH = Channel  # short alias

MAX_LAYOUT_CHANNELS = 12

# Channel count per IA channel layout (IAMF_utils.c:111).
LAYOUT_CHANNEL_COUNT = {
    ChannelLayout.MONO: 1,
    ChannelLayout.STEREO: 2,
    ChannelLayout.L510: 6,
    ChannelLayout.L512: 8,
    ChannelLayout.L514: 10,
    ChannelLayout.L710: 8,
    ChannelLayout.L712: 10,
    ChannelLayout.L714: 12,
    ChannelLayout.L312: 6,
    ChannelLayout.BINAURAL: 2,
}

# Channels of each IA layout in *rendering* order (IAMF_utils.c:117-133).
LAYOUT_CHANNELS_RENDER = {
    ChannelLayout.MONO: (CH.MONO,),
    ChannelLayout.STEREO: (CH.L2, CH.R2),
    ChannelLayout.L510: (CH.L7, CH.R7, CH.C, CH.LFE, CH.SL5, CH.SR5),
    ChannelLayout.L512: (CH.L7, CH.R7, CH.C, CH.LFE, CH.SL5, CH.SR5, CH.HL, CH.HR),
    ChannelLayout.L514: (
        CH.L7, CH.R7, CH.C, CH.LFE, CH.SL5, CH.SR5,
        CH.HFL, CH.HFR, CH.HBL, CH.HBR,
    ),
    ChannelLayout.L710: (CH.L7, CH.R7, CH.C, CH.LFE, CH.SL7, CH.SR7, CH.BL7, CH.BR7),
    ChannelLayout.L712: (
        CH.L7, CH.R7, CH.C, CH.LFE, CH.SL7, CH.SR7, CH.BL7, CH.BR7, CH.HL, CH.HR,
    ),
    ChannelLayout.L714: (
        CH.L7, CH.R7, CH.C, CH.LFE, CH.SL7, CH.SR7, CH.BL7, CH.BR7,
        CH.HFL, CH.HFR, CH.HBL, CH.HBR,
    ),
    ChannelLayout.L312: (CH.L3, CH.R3, CH.C, CH.LFE, CH.TL, CH.TR),
    ChannelLayout.BINAURAL: (CH.L2, CH.R2),
}

# Channels of each IA layout in *codec/decoding* order (IAMF_utils.c:181-196):
# the order in which coupled/mono substreams contribute channels.
LAYOUT_CHANNELS_CODEC = {
    ChannelLayout.MONO: (CH.MONO,),
    ChannelLayout.STEREO: (CH.L2, CH.R2),
    ChannelLayout.L510: (CH.L7, CH.R7, CH.SL5, CH.SR5, CH.C, CH.LFE),
    ChannelLayout.L512: (CH.L7, CH.R7, CH.SL5, CH.SR5, CH.HL, CH.HR, CH.C, CH.LFE),
    ChannelLayout.L514: (
        CH.L7, CH.R7, CH.SL5, CH.SR5, CH.HFL, CH.HFR, CH.HBL, CH.HBR, CH.C, CH.LFE,
    ),
    ChannelLayout.L710: (CH.L7, CH.R7, CH.SL7, CH.SR7, CH.BL7, CH.BR7, CH.C, CH.LFE),
    ChannelLayout.L712: (
        CH.L7, CH.R7, CH.SL7, CH.SR7, CH.BL7, CH.BR7, CH.HL, CH.HR, CH.C, CH.LFE,
    ),
    ChannelLayout.L714: (
        CH.L7, CH.R7, CH.SL7, CH.SR7, CH.BL7, CH.BR7,
        CH.HFL, CH.HFR, CH.HBL, CH.HBR, CH.C, CH.LFE,
    ),
    ChannelLayout.L312: (CH.L3, CH.R3, CH.TL, CH.TR, CH.C, CH.LFE),
    ChannelLayout.BINAURAL: (CH.L2, CH.R2),
}

# (surround, weight, top) channel-category counts per layout (IAMF_utils.c:154-160).
LAYOUT_CATEGORY_COUNT = {
    ChannelLayout.MONO: (1, 0, 0),
    ChannelLayout.STEREO: (2, 0, 0),
    ChannelLayout.L510: (5, 1, 0),
    ChannelLayout.L512: (5, 1, 2),
    ChannelLayout.L514: (5, 1, 4),
    ChannelLayout.L710: (7, 1, 0),
    ChannelLayout.L712: (7, 1, 2),
    ChannelLayout.L714: (7, 1, 4),
    ChannelLayout.L312: (3, 1, 2),
    ChannelLayout.BINAURAL: (2, 0, 0),
}


def layout_surround_channels(layout: ChannelLayout) -> int:
    return LAYOUT_CATEGORY_COUNT[layout][0]


def layout_weight_channels(layout: ChannelLayout) -> int:
    return LAYOUT_CATEGORY_COUNT[layout][1]


def layout_top_channels(layout: ChannelLayout) -> int:
    return LAYOUT_CATEGORY_COUNT[layout][2]


# Demix factor table indexed by demixing mode 0..7: (alpha, beta, gamma, delta,
# w_idx_offset). Modes 3 and 7 are invalid (IAMF_utils.c:234-244).
DEMIX_FACTORS = {
    0: (1.0, 1.0, 0.707, 0.707, -1),
    1: (0.707, 0.707, 0.707, 0.707, -1),
    2: (1.0, 0.866, 0.866, 0.866, -1),
    4: (1.0, 1.0, 0.707, 0.707, 1),
    5: (0.707, 0.707, 0.707, 0.707, 1),
    6: (1.0, 0.866, 0.866, 0.866, 1),
}


def valid_demix_mode(mode: int) -> bool:
    return 0 <= mode < 7 and mode != 3


# w(k) values indexed by w_idx 0..10 (fixedp11_5.c:82-83).
W_IDX_TABLE = (
    0.0, 0.0179, 0.0391, 0.0658, 0.1038, 0.25, 0.3962, 0.4342, 0.4609, 0.4821, 0.5,
)
MIN_W_IDX = 0
MAX_W_IDX = 10


def step_w_idx(w_idx_offset: int, w_idx_prev: int) -> tuple[int, float]:
    """One step of the per-frame w-index Markov walk (fixedp11_5.c:84-91)."""
    if w_idx_offset > 0:
        w_idx = min(w_idx_prev + 1, MAX_W_IDX)
    else:
        w_idx = max(w_idx_prev - 1, MIN_W_IDX)
    return w_idx, W_IDX_TABLE[w_idx]


def get_w(w_idx: int) -> float:
    return W_IDX_TABLE[max(MIN_W_IDX, min(MAX_W_IDX, w_idx))]


# ---------------------------------------------------------------------------
# Sound system definitions.
# Mapping: sound system -> equivalent IA channel layout used by the renderer
# tables (IAMF_decoder.c:204-252 iamf_sound_system_get_rendering_id analogues).
# ---------------------------------------------------------------------------

SOUND_SYSTEM_CHANNEL_COUNT = {
    SoundSystem.A: 2,
    SoundSystem.B: 6,
    SoundSystem.C: 8,
    SoundSystem.D: 10,
    SoundSystem.E: 11,
    SoundSystem.F: 12,
    SoundSystem.G: 14,
    SoundSystem.H: 24,
    SoundSystem.I: 8,
    SoundSystem.J: 12,
    SoundSystem.EXT_712: 10,
    SoundSystem.EXT_312: 6,
    SoundSystem.MONO: 1,
}

# (height, surround, lfe) per sound system (BS.2051 x+y+z naming):
SOUND_SYSTEM_HSL = {
    SoundSystem.A: (0, 2, 0),
    SoundSystem.B: (0, 5, 1),
    SoundSystem.C: (2, 5, 1),
    SoundSystem.D: (4, 5, 1),
    SoundSystem.E: (4, 5, 2),
    SoundSystem.F: (3, 7, 2),
    SoundSystem.G: (4, 9, 1),
    SoundSystem.H: (9, 10, 3), # 22.2
    SoundSystem.I: (0, 7, 1),
    SoundSystem.J: (4, 7, 1),
    SoundSystem.EXT_712: (2, 7, 1),
    SoundSystem.EXT_312: (2, 3, 1),
    SoundSystem.MONO: (0, 1, 0),
}


def db_to_linear(db: float) -> float:
    return 10.0 ** (0.05 * db)


def q78_to_db(q: int) -> float:
    """Q7.8 signed fixed -> dB float (fixedp11_5.c q_to_float with frac=8)."""
    return float(q) * (2.0 ** -8)


def q08_to_float(q: int) -> float:
    """Q0.8 recon gain byte -> float in [0,1]: q/255 (fixedp11_5.c:53-55)."""
    return float(q) / 255.0


# Frame-size bounds (IAMF_types.h:117-122)
OPUS_FRAME_SIZE = 960
MAX_OPUS_FRAME_SIZE = OPUS_FRAME_SIZE * 6
AAC_FRAME_SIZE = 1024
MAX_AAC_FRAME_SIZE = 2048
MAX_FRAME_SIZE = AAC_FRAME_SIZE * 6
MAX_FLAC_FRAME_SIZE = 32768
MAX_STREAMS = 255

OUTPUT_SAMPLERATE = 48000
