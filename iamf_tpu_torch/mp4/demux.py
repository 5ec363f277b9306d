"""Minimal MP4/fMP4 demuxer for IAMF tracks (host side).

Equivalent of the reference mov box parser (test/tools/iamfplayer/src/
mp4demux.c): walks ftyp/moov/trak/mdhd/hdlr/stbl/stsd ('iamf' sample entry,
mov_read_iamf :512-573)/stts/stsc/stsz/stco+co64/edts.elst/mvex, builds
chunk->sample maps, and re-parses moof/traf/trun fragments for fMP4.
Descriptor OBUs live in the 'iamf' sample entry after the 28-byte
AudioSampleEntry header.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator, Optional


def _u32(b, off):
    return struct.unpack_from(">I", b, off)[0]


def _u64(b, off):
    return struct.unpack_from(">Q", b, off)[0]


@dataclasses.dataclass
class SampleEntryIAMF:
    channels: int
    bits: int
    descriptors: bytes  # descriptor OBUs
    skip: int = 0
    timescale: int = 0


@dataclasses.dataclass
class Track:
    track_id: int = 0
    timescale: int = 0
    duration: int = 0
    handler: bytes = b""
    entries: list = dataclasses.field(default_factory=list)  # SampleEntryIAMF
    # sample tables
    stts: list = dataclasses.field(default_factory=list)  # (count, delta)
    stsc: list = dataclasses.field(default_factory=list)  # (first_chunk, spc, sdi)
    sizes: list = dataclasses.field(default_factory=list)
    chunk_offsets: list = dataclasses.field(default_factory=list)
    elst_media_time: int = 0
    default_sample_duration: int = 0
    default_sample_size: int = 0
    # 'roll' sample-group pre-roll distance (sgpd box; the reference reads
    # this box only under SUPPORT_VERIFIER — mp4demux.c:88,849 — and takes
    # roll from the Codec Config OBU; we surface both, see iamf_track)
    roll_distance: Optional[int] = None
    # flattened per-sample (offset, size, sample_desc_index)
    samples: list = dataclasses.field(default_factory=list)
    deltas: list = dataclasses.field(default_factory=list)
    # fMP4: (moof_start, moof_end, samples_in_fragment) per moof — used by
    # the vlogger to interleave box logs with packet OBU logs in the
    # reference verifier's parse order (moof boxes log when the previous
    # fragment's samples are exhausted, mp4demux.c mp4demux_parse)
    fragments: list = dataclasses.field(default_factory=list)


class MP4Demuxer:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = f.read()
        self.tracks: list[Track] = []
        self.iamf_track: Optional[Track] = None
        self.fragmented = False
        self._parse_top()
        if self.iamf_track is not None and not self.iamf_track.samples:
            self._flatten_samples(self.iamf_track)
        if self.fragmented:
            self._parse_fragments()

    # -- box walking ------------------------------------------------------

    def _boxes(self, start: int, end: int) -> Iterator[tuple[bytes, int, int]]:
        pos = start
        while pos + 8 <= end:
            size = _u32(self.data, pos)
            btype = self.data[pos + 4 : pos + 8]
            hdr = 8
            if size == 1:
                size = _u64(self.data, pos + 8)
                hdr = 16
            elif size == 0:
                size = end - pos
            if size < hdr or pos + size > end:
                return
            yield btype, pos + hdr, pos + size
            pos += size

    def _parse_top(self) -> None:
        for btype, body, bend in self._boxes(0, len(self.data)):
            if btype == b"moov":
                self._parse_moov(body, bend)
            elif btype == b"moof":
                self.fragmented = True

    def _parse_moov(self, start: int, end: int) -> None:
        for btype, body, bend in self._boxes(start, end):
            if btype == b"trak":
                trk = Track()
                self._parse_trak(trk, body, bend)
                self.tracks.append(trk)
                if trk.handler == b"soun" and trk.entries:
                    self.iamf_track = trk
            elif btype == b"mvex":
                for bt2, b2, e2 in self._boxes(body, bend):
                    if bt2 == b"trex":
                        # track_id, default sample desc/duration/size
                        d = self.data
                        tid = _u32(d, b2 + 4)
                        for trk in self.tracks:
                            if trk.track_id == tid:
                                trk.default_sample_duration = _u32(d, b2 + 12)
                                trk.default_sample_size = _u32(d, b2 + 16)

    def _parse_trak(self, trk: Track, start: int, end: int) -> None:
        for btype, body, bend in self._boxes(start, end):
            if btype == b"tkhd":
                ver = self.data[body]
                trk.track_id = _u32(self.data, body + (20 if ver else 12))
            elif btype == b"edts":
                for bt2, b2, e2 in self._boxes(body, bend):
                    if bt2 == b"elst":
                        self._parse_elst(trk, b2)
            elif btype == b"mdia":
                self._parse_mdia(trk, body, bend)

    def _parse_elst(self, trk: Track, body: int) -> None:
        d = self.data
        ver = d[body]
        n = _u32(d, body + 4)
        off = body + 8
        media_time = 0
        for _ in range(n):
            if ver == 1:
                media_time = struct.unpack_from(">q", d, off + 8)[0]
                off += 20
            else:
                media_time = struct.unpack_from(">i", d, off + 4)[0]
                off += 12
        if media_time > 0 and not trk.elst_media_time:
            trk.elst_media_time = media_time

    def _parse_mdia(self, trk: Track, start: int, end: int) -> None:
        for btype, body, bend in self._boxes(start, end):
            if btype == b"mdhd":
                ver = self.data[body]
                if ver == 1:
                    trk.timescale = _u32(self.data, body + 20)
                    trk.duration = _u64(self.data, body + 24)
                else:
                    trk.timescale = _u32(self.data, body + 12)
                    trk.duration = _u32(self.data, body + 16)
            elif btype == b"hdlr":
                trk.handler = self.data[body + 8 : body + 12]
            elif btype == b"minf":
                for bt2, b2, e2 in self._boxes(body, bend):
                    if bt2 == b"stbl":
                        self._parse_stbl(trk, b2, e2)

    def _parse_stbl(self, trk: Track, start: int, end: int) -> None:
        d = self.data
        for btype, body, bend in self._boxes(start, end):
            if btype == b"stsd":
                n = _u32(d, body + 4)
                pos = body + 8
                for _ in range(n):
                    esize = _u32(d, pos)
                    etype = d[pos + 4 : pos + 8]
                    if etype == b"iamf":
                        # AudioSampleEntry: 8 rsvd/dri + 8 rsvd + ch(2) +
                        # bits(2) + predef(2) + rsvd(2) + rate(4) = 28 bytes
                        eb = pos + 8
                        channels = struct.unpack_from(">H", d, eb + 16)[0]
                        bits = struct.unpack_from(">H", d, eb + 18)[0]
                        desc = bytes(d[eb + 28 : pos + esize])
                        trk.entries.append(
                            SampleEntryIAMF(channels=channels, bits=bits,
                                            descriptors=desc)
                        )
                    pos += esize
            elif btype == b"stts":
                n = _u32(d, body + 4)
                off = body + 8
                for _ in range(n):
                    trk.stts.append((_u32(d, off), _u32(d, off + 4)))
                    off += 8
            elif btype == b"stsc":
                n = _u32(d, body + 4)
                off = body + 8
                for _ in range(n):
                    trk.stsc.append(
                        (_u32(d, off), _u32(d, off + 4), _u32(d, off + 8))
                    )
                    off += 12
            elif btype == b"stsz":
                uniform = _u32(d, body + 4)
                n = _u32(d, body + 8)
                if uniform:
                    trk.sizes = [uniform] * n
                else:
                    off = body + 12
                    trk.sizes = [
                        _u32(d, off + 4 * i) for i in range(n)
                    ]
            elif btype == b"stco":
                n = _u32(d, body + 4)
                off = body + 8
                trk.chunk_offsets = [_u32(d, off + 4 * i) for i in range(n)]
            elif btype == b"co64":
                n = _u32(d, body + 4)
                off = body + 8
                trk.chunk_offsets = [_u64(d, off + 8 * i) for i in range(n)]
            elif btype == b"sgpd":
                ver = d[body]
                if d[body + 4 : body + 8] != b"roll":
                    continue
                off = body + 8
                default_length = 0
                if ver >= 1:
                    default_length = _u32(d, off)
                    off += 4
                if ver >= 2:
                    off += 4  # default_sample_description_index
                n = _u32(d, off)
                off += 4
                if n >= 1:
                    if ver == 1 and default_length == 0:
                        off += 4  # per-entry description_length
                    trk.roll_distance = struct.unpack_from(">h", d, off)[0]

    def _flatten_samples(self, trk: Track) -> None:
        """Build per-sample (offset, size, desc_index) from chunk maps."""
        samples: list[tuple[int, int, int]] = []
        n_samples = len(trk.sizes)
        if not trk.stsc or not trk.chunk_offsets:
            return
        stsc = trk.stsc
        n_chunks = len(trk.chunk_offsets)
        si = 0
        for ci in range(n_chunks):
            # find applicable stsc entry
            spc, sdi = 1, 1
            for k in range(len(stsc)):
                first, spc_k, sdi_k = stsc[k]
                if ci + 1 >= first:
                    spc, sdi = spc_k, sdi_k
                else:
                    break
            off = trk.chunk_offsets[ci]
            for _ in range(spc):
                if si >= n_samples:
                    break
                samples.append((off, trk.sizes[si], sdi))
                off += trk.sizes[si]
                si += 1
        trk.samples = samples
        deltas = []
        for count, delta in trk.stts:
            deltas += [delta] * count
        trk.deltas = deltas[: len(samples)]

    def _parse_fragments(self) -> None:
        """moof/traf/tfhd/trun walk (mov_read_moof/trun analogues)."""
        trk = self.iamf_track
        if trk is None:
            return
        for btype, body, bend in self._boxes(0, len(self.data)):
            if btype != b"moof":
                continue
            moof_start = body - 8
            n_before = len(trk.samples)
            for bt2, b2, e2 in self._boxes(body, bend):
                if bt2 != b"traf":
                    continue
                base_offset = moof_start
                default_size = trk.default_sample_size
                default_dur = trk.default_sample_duration
                d = self.data
                for bt3, b3, e3 in self._boxes(b2, e2):
                    if bt3 == b"tfhd":
                        flags = _u32(d, b3) & 0xFFFFFF
                        off = b3 + 8
                        if flags & 0x1:  # base data offset
                            base_offset = _u64(d, off)
                            off += 8
                        if flags & 0x2:  # sample description index
                            off += 4
                        if flags & 0x8:
                            default_dur = _u32(d, off)
                            off += 4
                        if flags & 0x10:
                            default_size = _u32(d, off)
                            off += 4
                    elif bt3 == b"trun":
                        flags = _u32(d, b3) & 0xFFFFFF
                        count = _u32(d, b3 + 4)
                        off = b3 + 8
                        data_offset = 0
                        if flags & 0x1:
                            data_offset = struct.unpack_from(">i", d, off)[0]
                            off += 4
                        if flags & 0x4:  # first sample flags
                            off += 4
                        pos = base_offset + data_offset
                        for _ in range(count):
                            dur = default_dur
                            size = default_size
                            if flags & 0x100:
                                dur = _u32(d, off)
                                off += 4
                            if flags & 0x200:
                                size = _u32(d, off)
                                off += 4
                            if flags & 0x400:
                                off += 4
                            if flags & 0x800:
                                off += 4
                            trk.samples.append((pos, size, len(trk.entries)))
                            trk.deltas.append(dur)
                            pos += size
            trk.fragments.append(
                (moof_start, bend, len(trk.samples) - n_before))

    # -- public -----------------------------------------------------------

    def sample(self, index: int) -> Optional[bytes]:
        trk = self.iamf_track
        if trk is None or index >= len(trk.samples):
            return None
        off, size, _ = trk.samples[index]
        return bytes(self.data[off : off + size])

    def sample_desc_index(self, index: int) -> int:
        trk = self.iamf_track
        if trk is None or index >= len(trk.samples):
            return 1
        return trk.samples[index][2]

    @property
    def n_samples(self) -> int:
        return len(self.iamf_track.samples) if self.iamf_track else 0
