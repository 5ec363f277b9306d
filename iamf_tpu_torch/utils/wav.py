"""Minimal RIFF/WAVE reader+writer for 16/24/32-bit integer PCM.

TPU-native framework equivalent of the reference wav writer
(dep_external/src/wav/dep_wavwriter.c) plus a reader for golden comparison.
"""

from __future__ import annotations

import struct

import numpy as np


def write_wav(path: str, pcm: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """Write interleaved integer PCM.

    pcm: int array shaped [frames, channels] (int16 for 16-bit, int32 holding
    sign-extended values for 24/32-bit).
    """
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    frames, channels = pcm.shape
    bytes_per = bits // 8
    data_size = frames * channels * bytes_per

    if bits == 16:
        payload = pcm.astype("<i2").tobytes()
    elif bits == 32:
        payload = pcm.astype("<i4").tobytes()
    elif bits == 24:
        as32 = pcm.astype("<i4")
        b = as32.view(np.uint8).reshape(frames * channels, 4)
        payload = np.ascontiguousarray(b[:, :3]).tobytes()
    else:
        raise ValueError(f"unsupported bit depth {bits}")

    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + data_size))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(
            struct.pack(
                "<IHHIIHH",
                16,
                1,  # PCM
                channels,
                sample_rate,
                sample_rate * channels * bytes_per,
                channels * bytes_per,
                bits,
            )
        )
        f.write(b"data")
        f.write(struct.pack("<I", data_size))
        f.write(payload)


def read_wav(path: str) -> tuple[np.ndarray, int, int]:
    """Read integer PCM wav -> (pcm [frames, channels] int array, rate, bits).

    24-bit samples are sign-extended into int32.
    """
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        csize = struct.unpack("<I", raw[pos + 4 : pos + 8])[0]
        body = raw[pos + 8 : pos + 8 + csize]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + csize + (csize & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    _, channels, rate, _, _, bits = fmt
    if bits == 16:
        pcm = np.frombuffer(data, dtype="<i2").astype(np.int32)
    elif bits == 32:
        pcm = np.frombuffer(data, dtype="<i4").astype(np.int32)
    elif bits == 24:
        b = np.frombuffer(data, dtype=np.uint8)
        n = len(b) // 3
        b = b[: n * 3].reshape(n, 3).astype(np.uint32)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        pcm = v.astype(np.int32)
        pcm = (pcm << 8) >> 8  # sign extend
    else:
        raise ValueError(f"unsupported wav bit depth {bits}")
    frames = len(pcm) // channels
    return pcm[: frames * channels].reshape(frames, channels), rate, bits
