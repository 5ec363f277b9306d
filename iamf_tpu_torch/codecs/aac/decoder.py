"""AAC-LC multistream decoder for IAMF substreams.

Mirrors the reference AAC path (IAMF_aac_decoder.c:83-161,
aac_multistream_decoder.c:82-218): the IAMF decoder config is an MP4
DecoderConfigDescriptor; the AudioSpecificConfig is extracted from the
DecSpecificInfo tag and its channelConfiguration field is patched per
substream (2 for coupled pairs, 1 for mono). Each substream gets its own
decoder instance fed RAW access units.

Decode backend: the framework's from-scratch AAC-LC decoder
(native/src/aac/aac_frame.cc, ISO/IEC 14496-3 subpart 4), validated
>80 dB SNR packet-for-packet against fdk-aac.

The host half of iamf_tpu/codecs/aac/decoder.py, copied without its fdk
backend (IAMF_AAC_BACKEND=fdk, the differential oracle loaded from the
reference's prebuilt binary, which this package does not carry).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

from ...constants import Codec
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
            raise NotImplementedError(f"native aac lib unavailable: {e}")
    _lib = ctypes.CDLL(_LIB_PATH)
    _lib.iamf_aac_open.restype = ctypes.c_void_p
    _lib.iamf_aac_open.argtypes = [ctypes.c_int, ctypes.c_int]
    _lib.iamf_aac_close.argtypes = [ctypes.c_void_p]
    _lib.iamf_aac_decode.restype = ctypes.c_int
    _lib.iamf_aac_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    _lib.iamf_aac_decode_spectrum.restype = ctypes.c_int
    _lib.iamf_aac_decode_spectrum.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
    ]
    _lib.iamf_aac_decode_spectrum_batch.restype = ctypes.c_int
    _lib.iamf_aac_decode_spectrum_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.c_longlong,
    ]
    return _lib


def parse_asc(asc: bytes) -> tuple[int, int, int]:
    """AudioSpecificConfig -> (audio_object_type, sr_index, chan_config)."""
    if len(asc) < 2:
        raise ValueError("short ASC")
    aot = asc[0] >> 3
    freq_idx = ((asc[0] & 7) << 1) | (asc[1] >> 7)
    if freq_idx == 0xF:
        if len(asc) < 5:
            raise ValueError("short ASC (escaped rate)")
        chan = (asc[4] >> 3) & 0xF
    else:
        chan = (asc[1] >> 3) & 0xF
    return aot, freq_idx, chan


def extract_asc(decoder_conf: bytes) -> bytes:
    """DecoderConfigDescriptor -> AudioSpecificConfig.

    IAMF's AAC decoder_config uses FIXED-layout descriptors (no expandable
    length fields): tag 0x04, objectTypeIndication 0x40 at [1], streamType
    byte at [2], bufferSizeDB u24, maxBitrate u32, avgBitrate u32, then
    DecSpecificInfoTag 0x05 at [14] and the raw ASC from [15]
    (IAMF_aac_decoder.c:83-96 parses exactly this)."""
    d = bytes(decoder_conf)
    if len(d) < 16 or d[0] != 0x04:
        raise ValueError("bad DecoderConfigDescriptor")
    if d[1] != 0x40 or (d[2] >> 2) & 0x3F != 5 or (d[2] >> 1) & 1:
        raise ValueError("not an MPEG-4 audio stream descriptor")
    if d[14] != 0x05:
        raise ValueError("missing DecSpecificInfoTag")
    return d[15:]


@register(Codec.AAC)
class AACDecoder(CodecDecoder):
    def __init__(self, decoder_conf, streams, coupled_streams, frame_size):
        super().__init__(decoder_conf, streams, coupled_streams, frame_size)
        asc = extract_asc(decoder_conf)
        self._decoders = []
        aot, sr_index, _ = parse_asc(asc)
        if aot != 2:
            raise ValueError(f"not AAC-LC (AOT {aot})")
        lib = _load_native()
        for i in range(streams):
            ch = 2 if i < coupled_streams else 1
            h = lib.iamf_aac_open(sr_index, ch)
            if not h:
                raise ValueError("bad AAC config")
            self._decoders.append((h, ch))
        self.delay = 0  # AAC-LC RAW carries no codec delay of its own
        # error/loss concealment (the reference's fdk AAC_CONCEAL_METHOD=1
        # analogue): energy-fade repeat of the last good frame
        self._conceal = os.environ.get("IAMF_AAC_CONCEAL", "1") != "0"
        self._plc: dict = {}

    def __del__(self):
        try:
            lib = _load_native()
            for h, _ in getattr(self, "_decoders", []):
                lib.iamf_aac_close(h)
        except Exception:
            pass

    def decode(self, packets: Sequence[Optional[bytes]]) -> np.ndarray:
        outs = []
        lib = _load_native()
        for i, (h, ch) in enumerate(self._decoders):
            pkt = packets[i]
            buf = np.zeros(self.frame_size * ch, np.float32)
            r = -1
            if pkt is not None:
                r = lib.iamf_aac_decode(
                    h, bytes(pkt), len(pkt),
                    buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if r < 0:
                # lost/corrupt access unit: energy-fade concealment of the
                # last good frame (the reference sets fdk's
                # AAC_CONCEAL_METHOD=1 for the same situation,
                # aac_multistream_decoder.c:204-224)
                if not self._conceal:
                    raise ValueError(
                        "missing aac sub packet" if pkt is None
                        else f"aac decode failed ({r})")
                last, gain = self._plc.get(i, (None, 1.0))
                gain *= 0.5
                y = (last * np.float32(gain) if last is not None
                     else np.zeros((ch, self.frame_size), np.float32))
                self._plc[i] = (last, gain)
                outs.append(y)
                continue
            # match the reference wrapper's s16 -> float conversion,
            # including its round-to-int quantization
            s16 = np.clip(np.rint(buf), -32768, 32767)
            y = (s16.astype(np.float32) / 32768.0).reshape(ch, -1)
            self._plc[i] = (y, 1.0)
            outs.append(y)
        return np.concatenate(outs, axis=0)

    def decode_spectrum_batch(self, frames):
        """Parse+dequantize a batch of frames to spectra for a device
        filterbank (the reference's is iamf_tpu/codecs/aac/tpu_synth.py, not
        ported yet).

        frames: [B] lists of per-substream packets. Returns dict of numpy
        arrays: spec [B, L, 1024], win_seq/shape/prev_shape [B, L]
        (L = total planar channels, coupled substreams first).
        """
        lib = _load_native()
        B = len(frames)
        L = sum(ch for _, ch in self._decoders)
        spec = np.zeros((B, L, 1024), np.float32)
        meta = np.zeros((B, L, 3), np.int32)
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        lane = 0
        for i, (h, ch) in enumerate(self._decoders):
            # ONE GIL-free native call per substream for the whole batch
            # (iamf_aac_decode_spectrum_batch, aac_frame.cc): the old
            # per-(frame, substream) loop cost ~900 ctypes round-trips per
            # 128-frame batch — the same wall the FLAC path removed in
            # round 4 — and serialized the host entropy on the GIL under
            # aggregate serving
            pkts = [frames[b][i] for b in range(B)]
            if any(p is None for p in pkts):
                raise ValueError("missing aac sub packet")
            blob = b"".join(bytes(p) for p in pkts)
            sizes = np.array([len(p) for p in pkts], np.int32)
            r = lib.iamf_aac_decode_spectrum_batch(
                h, blob, sizes.ctypes.data_as(ip), B,
                ctypes.c_longlong(L * 1024), ctypes.c_longlong(1024),
                spec[:, lane:].ctypes.data_as(fp),
                meta[:, lane:].ctypes.data_as(ip),
                ctypes.c_longlong(L * 3))
            if r != B:
                raise ValueError(f"aac spectrum decode failed ({r})")
            lane += ch
        return dict(spec=spec, win_seq=meta[..., 0], shape=meta[..., 1],
                    prev_shape=meta[..., 2])
