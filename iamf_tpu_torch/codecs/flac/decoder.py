"""FLAC multistream decoder (bit-exact lossless path).

Each IAMF substream is an independent FLAC stream; packets carry one
complete FLAC frame (reference: flac_multistream_decoder.c feeds packets to
per-stream libFLAC instances). The frame decode itself runs in the
framework's native C++ component (native/src/flac_frame.cc, loaded via
ctypes); int32 samples are scaled to float by 2^(streaminfo_bits-1)
(IAMF_flac_decoder.c:74-82).

decoder_conf: FLAC METADATA_BLOCK stream: STREAMINFO (+ others), without
the "fLaC" magic (codec config OBU carries the raw metadata blocks).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

from ...constants import Codec
from ...obu.bitstream import BitReader
from ..base import CodecDecoder, register

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "lib", "libiamf_native.so")

_lib = None


def _load_native():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR], check=True, capture_output=True
            )
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            raise NotImplementedError(f"native FLAC lib unavailable: {e}")
    _lib = ctypes.CDLL(_LIB_PATH)
    _lib.iamf_flac_decode_frame.restype = ctypes.c_int
    _lib.iamf_flac_decode_frame.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    _lib.iamf_flac_decode_batch.restype = ctypes.c_int
    _lib.iamf_flac_decode_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    return _lib


def parse_streaminfo(decoder_conf: bytes) -> dict:
    """Walk METADATA_BLOCKs for STREAMINFO (same walk as
    iamf_codec_conf_get_sampling_rate, IAMF_decoder.c:736-750)."""
    br = BitReader(decoder_conf)
    while True:
        last = br.bits(1)
        btype = br.bits(7)
        size = br.bits(24)
        if btype == 0:
            min_bs = br.bits(16)
            max_bs = br.bits(16)
            br.bits(24)  # min frame size
            br.bits(24)  # max frame size
            rate = br.bits(20)
            channels = br.bits(3) + 1
            bits = br.bits(5) + 1
            total = br.bits(36)
            return {
                "min_block": min_bs,
                "max_block": max_bs,
                "sample_rate": rate,
                "channels": channels,
                "bits": bits,
                "total_samples": total,
            }
        br.skip_bits(size * 8)
        if last:
            raise ValueError("no STREAMINFO in FLAC decoder config")


def decode_frame_native(packet: bytes, streaminfo_bits: int,
                        max_samples: int = 32768):
    """Decode one FLAC frame -> (int32 [nch, n], bps)."""
    lib = _load_native()
    buf = (ctypes.c_uint8 * len(packet)).from_buffer_copy(packet)
    out = np.zeros(8 * max_samples, dtype=np.int32)
    nch = ctypes.c_int(0)
    bps = ctypes.c_int(0)
    n = lib.iamf_flac_decode_frame(
        buf,
        len(packet),
        streaminfo_bits,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_samples,
        ctypes.byref(nch),
        ctypes.byref(bps),
    )
    if n <= 0:
        raise ValueError(f"FLAC frame decode failed: {n}")
    return out[: nch.value * n].reshape(nch.value, n), bps.value


@register(Codec.FLAC)
class FLACDecoder(CodecDecoder):
    def __init__(self, decoder_conf, streams, coupled_streams, frame_size):
        super().__init__(decoder_conf, streams, coupled_streams, frame_size)
        self.info = parse_streaminfo(decoder_conf)
        self.bits = self.info["bits"]
        self.sample_rate = self.info["sample_rate"]
        self.scale = np.float32(float(1 << (self.bits - 1)))
        _load_native()

    def decode_batch_raw(
        self, packets_per_substream: Sequence[Sequence[bytes]],
        frame_size: int,
    ) -> tuple[np.ndarray, float]:
        """Vectorized whole-stream decode to INTEGER samples: one GIL-free
        native call per substream (native/src/flac_frame.cc batch entry),
        eliminating the per-(frame,substream) ctypes round-trips that made
        the host path ~40x realtime. Returns ([n, C, T] int32, input_scale)
        — float conversion runs on the device like the PCM path."""
        import concurrent.futures as cf

        lib = _load_native()
        n_frames = min(len(p) for p in packets_per_substream)
        x = np.empty((n_frames, self.channels, frame_size), np.int32)
        starts = []
        ch = 0
        for i in range(self.streams):
            want = 2 if i < self.coupled_streams else 1
            starts.append((ch, want))
            ch += want

        def _decode_sub(i):
            ch0, want = starts[i]
            pkts = packets_per_substream[i][:n_frames]
            blob = b"".join(pkts)
            sizes = (ctypes.c_int * n_frames)(*[len(p) for p in pkts])
            sub = np.empty((n_frames, want, frame_size), np.int32)
            r = lib.iamf_flac_decode_batch(
                blob, sizes, n_frames, self.bits, want,
                sub.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                frame_size)
            if r != n_frames:
                raise ValueError(f"FLAC batch decode failed: {r}")
            x[:, ch0:ch0 + want] = sub
            return None

        # substreams are independent FLAC streams (per spec); the native
        # call releases the GIL, so they decode on parallel host threads
        workers = min(self.streams, os.cpu_count() or 1)
        if workers > 1:
            with cf.ThreadPoolExecutor(workers) as ex:
                list(ex.map(_decode_sub, range(self.streams)))
        else:
            for i in range(self.streams):
                _decode_sub(i)
        return x, float(1.0 / self.scale)

    def decode(self, packets: Sequence[Optional[bytes]]) -> np.ndarray:
        outs = []
        n_samples = None
        for i in range(self.streams):
            pkt = packets[i]
            if pkt is None:
                raise ValueError("missing FLAC sub packet")
            samples, _ = decode_frame_native(pkt, self.bits)
            want = 2 if i < self.coupled_streams else 1
            samples = samples[:want]
            if samples.shape[0] < want:
                samples = np.vstack(
                    [samples] + [samples[-1:]] * (want - samples.shape[0])
                )
            outs.append(samples)
            n_samples = samples.shape[1]
        x = np.concatenate(outs, axis=0)
        return x.astype(np.float32) / self.scale
