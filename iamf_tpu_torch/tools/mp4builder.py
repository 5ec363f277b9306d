"""Minimal MP4 muxer for IAMF tracks (test-vector side).

Writes a non-fragmented .mp4 with one 'soun' track whose sample entry is
'iamf' (descriptor OBUs after the 28-byte AudioSampleEntry header), matching
what the reference demuxer reads (mp4demux.c mov_read_iamf :512-573).
Samples are temporal units: parameter OBUs + audio frame OBUs per access
unit (without descriptor OBUs).
"""

from __future__ import annotations

import struct
from typing import Sequence


def _box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + btype + payload


def _full(btype: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(btype, struct.pack(">I", (version << 24) | flags) + payload)


def mux_iamf_mp4(
    descriptors: bytes,
    samples: Sequence[bytes],
    frame_size: int = 960,
    timescale: int = 48000,
    channels: int = 2,
    bits: int = 16,
    media_time: int = 0,
    roll_distance: int | None = None,
) -> bytes:
    """Build a complete .mp4 byte string.

    roll_distance: when set, writes the 'roll' sample-group boxes
    (sbgp + sgpd v1 with a signed-16 roll distance entry) the IAMF-in-MP4
    encapsulation prescribes for pre-roll signalling; the reference reads
    the box only under SUPPORT_VERIFIER (mp4demux.c:88,849 vlogs it raw),
    our demuxer also surfaces it as Track.roll_distance.
    """
    n = len(samples)
    duration = n * frame_size

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiamf")

    # mdat first so chunk offsets are easy to compute afterwards
    mdat_payload = b"".join(samples)

    # --- stbl ---
    entry = (
        struct.pack(">IHH", 0, 0, 1)  # reserved, reserved, data_ref_idx
        + struct.pack(">II", 0, 0)  # reserved
        + struct.pack(">HHHH", channels, bits, 0, 0)
        + struct.pack(">I", timescale << 16)
        + descriptors
    )
    stsd = _full(
        b"stsd", 0, 0, struct.pack(">I", 1) + _box(b"iamf", entry)
    )
    stts = _full(
        b"stts", 0, 0, struct.pack(">II", 1, 0)[:4]
        + struct.pack(">II", n, frame_size)
    )
    stsc = _full(b"stsc", 0, 0, struct.pack(">I", 1) + struct.pack(">III", 1, n, 1))
    stsz = _full(
        b"stsz", 0, 0,
        struct.pack(">II", 0, n) + b"".join(struct.pack(">I", len(s)) for s in samples),
    )
    # stco patched after layout known
    stco_placeholder = _full(b"stco", 0, 0, struct.pack(">II", 1, 0))
    group = b""
    if roll_distance is not None:
        sbgp = _full(b"sbgp", 0, 0,
                     b"roll" + struct.pack(">III", 1, n, 1))
        sgpd = _full(b"sgpd", 1, 0,
                     b"roll" + struct.pack(">IIh", 2, 1, roll_distance))
        group = sbgp + sgpd
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco_placeholder + group)

    smhd = _full(b"smhd", 0, 0, struct.pack(">HH", 0, 0))
    dref = _full(
        b"dref", 0, 0, struct.pack(">I", 1) + _full(b"url ", 0, 1, b"")
    )
    dinf = _box(b"dinf", dref)
    minf = _box(b"minf", smhd + dinf + stbl)

    mdhd = _full(
        b"mdhd", 0, 0,
        struct.pack(">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0),
    )
    hdlr = _full(
        b"hdlr", 0, 0,
        struct.pack(">I", 0) + b"soun" + b"\x00" * 12 + b"iamf\x00",
    )
    mdia = _box(b"mdia", mdhd + hdlr + minf)

    tkhd = _full(
        b"tkhd", 0, 7,
        struct.pack(">IIIII", 0, 0, 1, 0, duration)
        + b"\x00" * 8
        + struct.pack(">HHHH", 0, 0, 0x0100, 0)
        + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + struct.pack(">II", 0, 0),
    )
    edts = b""
    if media_time:
        elst = _full(
            b"elst", 0, 0,
            struct.pack(">I", 1) + struct.pack(">IiHH", duration, media_time, 1, 0),
        )
        edts = _box(b"edts", elst)
    trak = _box(b"trak", tkhd + edts + mdia)

    mvhd = _full(
        b"mvhd", 0, 0,
        struct.pack(">IIII", 0, 0, timescale, duration)
        + struct.pack(">IHH", 0x10000, 0x0100, 0)
        + b"\x00" * 8
        + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + b"\x00" * 24
        + struct.pack(">I", 2),
    )
    moov = _box(b"moov", mvhd + trak)

    # layout: ftyp, moov, mdat. chunk offset = start of mdat payload.
    mdat = _box(b"mdat", mdat_payload)
    chunk_offset = len(ftyp) + len(moov) + 8
    moov = moov.replace(
        _full(b"stco", 0, 0, struct.pack(">II", 1, 0)),
        _full(b"stco", 0, 0, struct.pack(">II", 1, chunk_offset)),
    )
    return ftyp + moov + mdat


def mux_iamf_fmp4(
    descriptors: bytes,
    samples: Sequence[bytes],
    frame_size: int = 960,
    timescale: int = 48000,
    channels: int = 2,
    bits: int = 16,
    fragments: int = 2,
    base_data_offset: bool = False,
) -> bytes:
    """Fragmented variant: moov with EMPTY sample tables (the reference
    demuxer flips to fragment mode when the moov track has zero samples,
    mp4demux.c:1513-1517) followed by [moof(traf(tfhd+trun)) mdat] per
    fragment. With base_data_offset=True the tfhd carries the (redundant)
    explicit 64-bit base offset — the reference reads and discards it,
    always using the moof position (mov_read_tfhd mp4demux.c:930-934), but
    its verifier logs it through the malformed "%0x08x,%08x" format
    (vlogging_iamfmp4_sr.c:464)."""
    n = len(samples)
    duration = n * frame_size

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiamf")

    entry = (
        struct.pack(">IHH", 0, 0, 1)
        + struct.pack(">II", 0, 0)
        + struct.pack(">HHHH", channels, bits, 0, 0)
        + struct.pack(">I", timescale << 16)
        + descriptors
    )
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1) + _box(b"iamf", entry))
    stts = _full(b"stts", 0, 0, struct.pack(">I", 0))
    stsc = _full(b"stsc", 0, 0, struct.pack(">I", 0))
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, 0))
    stco = _full(b"stco", 0, 0, struct.pack(">I", 0))
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)

    smhd = _full(b"smhd", 0, 0, struct.pack(">HH", 0, 0))
    dref = _full(b"dref", 0, 0, struct.pack(">I", 1) + _full(b"url ", 0, 1, b""))
    dinf = _box(b"dinf", dref)
    minf = _box(b"minf", smhd + dinf + stbl)
    mdhd = _full(
        b"mdhd", 0, 0,
        struct.pack(">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0),
    )
    hdlr = _full(
        b"hdlr", 0, 0,
        struct.pack(">I", 0) + b"soun" + b"\x00" * 12 + b"iamf\x00",
    )
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    tkhd = _full(
        b"tkhd", 0, 7,
        struct.pack(">IIIII", 0, 0, 1, 0, duration)
        + b"\x00" * 8
        + struct.pack(">HHHH", 0, 0, 0x0100, 0)
        + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + struct.pack(">II", 0, 0),
    )
    trak = _box(b"trak", tkhd + mdia)
    mvhd = _full(
        b"mvhd", 0, 0,
        struct.pack(">IIII", 0, 0, timescale, duration)
        + struct.pack(">IHH", 0x10000, 0x0100, 0)
        + b"\x00" * 8
        + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + b"\x00" * 24
        + struct.pack(">I", 2),
    )
    moov = _box(b"moov", mvhd + trak)

    out = bytearray(ftyp + moov)
    per = -(-n // max(1, fragments))
    for f0 in range(0, n, per):
        frag = samples[f0:f0 + per]
        moof_pos = len(out)

        def make_moof(bdo: int) -> bytes:
            mfhd = _full(b"mfhd", 0, 0, struct.pack(">I", f0 // per + 1))
            tf_flags = 0x8 | (0x1 if base_data_offset else 0)
            tf = struct.pack(">I", 1)  # track id
            if base_data_offset:
                tf += struct.pack(">Q", bdo)
            tf += struct.pack(">I", frame_size)  # default duration
            tfhd = _full(b"tfhd", 0, tf_flags, tf)
            # trun: data offset (relative to moof start) + per-sample sizes
            tr = struct.pack(">Ii", len(frag), 0)  # count, offset patched
            tr += b"".join(struct.pack(">I", len(s)) for s in frag)
            trun = _full(b"trun", 0, 0x201, tr)
            traf = _box(b"traf", tfhd + trun)
            return _box(b"moof", mfhd + traf)

        moof = make_moof(moof_pos)
        data_off = len(moof) + 8  # samples start after the mdat header
        moof = make_moof(moof_pos)  # same size; now patch trun offset
        moof = moof.replace(
            struct.pack(">Ii", len(frag), 0),
            struct.pack(">Ii", len(frag), data_off), 1)
        out += moof
        out += _box(b"mdat", b"".join(frag))
    return bytes(out)
