"""ipcm codec: vectorized de-interleave + scale (reference:
pcm/IAMF_pcm_decoder.c:52-151).

decoder_conf: [sample_format_flags u8][sample_size u8][sample_rate u32be];
flags != 0 => little-endian. Coupled substreams carry 2 interleaved
channels; output is planar float32 with scale 2^(sample_size-1). Pure numpy
byte swizzle — this feeds the device pipeline directly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..constants import Codec
from .base import CodecDecoder, register


def _unpack_native(buf: bytes, sample_size: int, little_endian: bool) -> np.ndarray:
    """Raw PCM bytes -> narrowest native int array (no float conversion)."""
    if sample_size == 16:
        dt = "<i2" if little_endian else ">i2"
        return np.ascontiguousarray(np.frombuffer(buf, dtype=dt)).astype(
            np.int16, copy=False
        )
    return _unpack(buf, sample_size, little_endian)


def _unpack(buf: bytes, sample_size: int, little_endian: bool) -> np.ndarray:
    """Raw PCM bytes -> int32 sample vector."""
    if sample_size == 16:
        dt = "<i2" if little_endian else ">i2"
        return np.frombuffer(buf, dtype=dt).astype(np.int32)
    if sample_size == 32:
        dt = "<i4" if little_endian else ">i4"
        return np.frombuffer(buf, dtype=dt).astype(np.int32)
    if sample_size == 24:
        b = np.frombuffer(buf, dtype=np.uint8)
        n = len(b) // 3
        b = b[: n * 3].reshape(n, 3).astype(np.uint32)
        if little_endian:
            v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        else:
            v = b[:, 2] | (b[:, 1] << 8) | (b[:, 0] << 16)
        v = v.astype(np.int32)
        return (v << 8) >> 8  # sign extend
    raise ValueError(f"bad pcm sample size {sample_size}")


@register(Codec.PCM)
class PCMDecoder(CodecDecoder):
    def __init__(self, decoder_conf, streams, coupled_streams, frame_size):
        super().__init__(decoder_conf, streams, coupled_streams, frame_size)
        self.flags = decoder_conf[0]
        self.sample_size = decoder_conf[1]
        self.sample_rate = int.from_bytes(decoder_conf[2:6], "big")
        self.little_endian = self.flags != 0
        self.scale = np.float32(2.0 ** (self.sample_size - 1))

    def decode_batch_raw(
        self, packets_per_substream: Sequence[Sequence[bytes]], frame_size: int
    ) -> tuple[np.ndarray, float]:
        """Vectorized whole-stream unpack to INTEGER samples.

        Returns ([n_frames, channels, frame_size] int16/int32, input_scale);
        the float conversion (x * input_scale) runs on the device, fused into
        the pipeline — raw integers halve host->device transfer volume.
        """
        n_frames = min(len(p) for p in packets_per_substream)
        # write each substream straight into the final [n, C, T] planar
        # array: the transpose+concatenate formulation copied the whole
        # 35 MB/30 s stream twice more (~80 ms of the pcm host path)
        first = _unpack_native(
            b"".join(packets_per_substream[0][:n_frames]),
            self.sample_size, self.little_endian)
        x = np.empty((n_frames, self.channels, frame_size), first.dtype)
        ch = 0
        for i in range(self.streams):
            v = first if i == 0 else _unpack_native(
                b"".join(packets_per_substream[i][:n_frames]),
                self.sample_size, self.little_endian)
            if i < self.coupled_streams:
                v = v.reshape(n_frames, frame_size, 2)
                x[:, ch] = v[:, :, 0]
                x[:, ch + 1] = v[:, :, 1]
                ch += 2
            else:
                x[:, ch] = v.reshape(n_frames, frame_size)
                ch += 1
        return x, float(1.0 / self.scale)

    def decode_batch(self, packets_per_substream: Sequence[Sequence[bytes]],
                     frame_size: int) -> np.ndarray:
        """Float whole-stream unpack -> [n_frames, channels, frame_size]."""
        x, scale = self.decode_batch_raw(packets_per_substream, frame_size)
        return x.astype(np.float32) * np.float32(scale)

    def decode(self, packets: Sequence[Optional[bytes]]) -> np.ndarray:
        ssz = self.sample_size // 8
        if packets[0] is None:
            raise ValueError("missing sub packet")
        n0 = len(packets[0]) // ssz
        samples = n0 // 2 if self.coupled_streams else n0

        out = np.zeros((self.channels, samples), dtype=np.float32)
        ch = 0
        for i in range(self.coupled_streams):
            v = _unpack(packets[i], self.sample_size, self.little_endian)
            v = v[: samples * 2].reshape(samples, 2)
            out[ch] = v[:, 0].astype(np.float32) / self.scale
            out[ch + 1] = v[:, 1].astype(np.float32) / self.scale
            ch += 2
        for i in range(self.coupled_streams, self.streams):
            v = _unpack(packets[i], self.sample_size, self.little_endian)
            out[ch] = v[:samples].astype(np.float32) / self.scale
            ch += 1
        return out
