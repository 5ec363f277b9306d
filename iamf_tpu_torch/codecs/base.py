"""Core codec abstraction (reference: IAMF_codec.h:59-68 vtable +
IAMF_core_decoder.c registry/ambisonics handling).

Each codec decodes one element's substream packets into planar float32
[channels, frame_size] (channel-major, coupled streams first). The
ambisonics mono remap / projection demix live in core/stream.py (they're
layout transforms, not codec work).
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence

import numpy as np

from ..constants import Codec


class CodecDecoder(abc.ABC):
    """One decoder instance per (element, layer): N streams, M coupled."""

    def __init__(
        self,
        decoder_conf: bytes,
        streams: int,
        coupled_streams: int,
        frame_size: int,
    ):
        self.decoder_conf = decoder_conf
        self.streams = streams
        self.coupled_streams = coupled_streams
        self.frame_size = frame_size
        self.channels = streams + coupled_streams
        self.delay = 0  # codec delay in samples (discovered after first frame)

    @abc.abstractmethod
    def decode(self, packets: Sequence[Optional[bytes]]) -> np.ndarray:
        """Decode one packet per substream -> [channels, samples] float32."""


_REGISTRY: dict[int, type] = {}


def register(codec: Codec):
    def wrap(cls):
        _REGISTRY[codec] = cls
        return cls

    return wrap


def open_decoder(
    codec: Codec,
    decoder_conf: bytes,
    streams: int,
    coupled_streams: int,
    frame_size: int,
) -> CodecDecoder:
    if codec not in _REGISTRY:
        raise NotImplementedError(f"codec {codec!r} not available")
    return _REGISTRY[codec](decoder_conf, streams, coupled_streams, frame_size)


def available_codecs() -> list[Codec]:
    return sorted(_REGISTRY)


def _ensure_registered() -> None:
    from . import pcm  # noqa: F401

    try:
        from .flac import decoder as _flac  # noqa: F401
    except ImportError:
        pass
    try:
        from .opus import decoder as _opus  # noqa: F401
    except ImportError:
        pass
    try:
        from .aac import decoder as _aac  # noqa: F401
    except ImportError:
        pass


_ensure_registered()
