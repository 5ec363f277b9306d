"""MP4 box-tree dump + conformance YAML vlogger.

Framework equivalents of the reference verifier tooling: `atom_dump`
(test/tools/iamfplayer/src/atom.c:294+, pretty-prints the box tree) and the
MP4 YAML vlogger (vlogging_iamfmp4_sr.c:193-1672 `write_*_atom_log`,
dispatched from the demuxer's box readers, mp4demux.c `vlog_atom` calls).
The YAML output is byte-identical to a `-DSUPPORT_VERIFIER=1` reference
player run on mp4 input (tests/test_vlogger_diff.py), including the
reference's quirks: the 1904-epoch date rendering via gmtime+1834, the
`%016x` box-offset entry names, TrackWidth/Height read as u16 but advanced
by 4, and the box subset the demuxer actually vlogs (no minf/smhd/mdat).
Exposed through the player's -v flag for -i1 (mp4) inputs.
"""

from __future__ import annotations

import time
from typing import TextIO

_CONTAINERS = {
    b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"moof",
    b"traf", b"mvex", b"udta", b"dinf",
}


def _u(b, off, n):
    return int.from_bytes(b[off:off + n], "big")


def _s(b, off, n):
    return int.from_bytes(b[off:off + n], "big", signed=True)


def iter_boxes(data, start, end):
    pos = start
    while pos + 8 <= end:
        size = _u(data, pos, 4)
        btype = bytes(data[pos + 4:pos + 8])
        body = pos + 8
        if size == 1:
            size = _u(data, pos + 8, 8)
            body = pos + 16
        elif size == 0:
            size = end - pos
        if size < 8 or pos + size > end:
            return
        yield btype, body, pos + size
        pos += size


def atom_dump(data: bytes, out: TextIO) -> int:
    """Pretty-print the full box tree (atom.c:294 atom_dump analogue).
    Returns the box count."""
    n = 0

    def walk(start, end, depth):
        nonlocal n
        for btype, body, bend in iter_boxes(data, start, end):
            name = btype.decode("latin1")
            out.write(f"{'  ' * depth}{name} size={bend - (body - 8)}"
                      f" @{body - 8}\n")
            n += 1
            if btype in _CONTAINERS:
                walk(body, bend, depth + 1)

    walk(0, len(data), 0)
    return n


def _utc(val: int) -> str:
    """utc2rstring (vlogging_iamfmp4_sr.c:103-132): gmtime of the raw field
    with tm_year+1834 — i.e. the Unix-epoch calendar shifted to 1904."""
    t = time.gmtime(val)
    return (f"{t.tm_year - 66:04d}-{t.tm_mon:02d}-{t.tm_mday:02d} "
            f"{t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d} UTC")


def _read_obu_header(d, pos, end):
    """read_IAMF_OBU subset: returns (obu_type, payload_off, next_pos) or
    None. Payload skips trims/extension like the reference's walk."""
    if end - pos < 2:
        return None
    val = d[pos]
    obu_type = (val & 0xF8) >> 3
    trimming = (val & 0x02) >> 1
    extension = val & 0x01
    i = pos + 1
    size = 0
    shift = 0
    while i < end:
        byte = d[i]
        size |= (byte & 0x7F) << shift
        shift += 7
        i += 1
        if not (byte & 0x80):
            break
    obu_end = i + size
    if obu_end > end:
        return None
    p = i
    if trimming:
        for _ in range(2):  # trim_end, trim_start leb128s
            while p < end and d[p] & 0x80:
                p += 1
            p += 1
    if extension:
        ext = 0
        shift = 0
        while p < end:
            byte = d[p]
            ext |= (byte & 0x7F) << shift
            shift += 7
            p += 1
            if not (byte & 0x80):
                break
        p += ext
    return obu_type, p, obu_end


def _leb128(d, pos):
    ret = 0
    for i in range(8):
        byte = d[pos + i]
        ret |= (byte & 0x7F) << (i * 7)
        if not (byte & 0x80):
            return ret, pos + i + 1
    return ret, pos + 8


class MP4VLogger:
    """YAML per-box logs byte-identical to vlogging_iamfmp4_sr.c."""

    def __init__(self, f: TextIO):
        self.f = f
        self.count = 0

    def _entry(self, name: str, addr: int, lines) -> None:
        self.f.write(f"#1\n{name}_{addr:016x}:\n")
        for ln in lines:
            self.f.write(f"- {ln}\n")
        self.f.write("##\n")
        self.count += 1

    def log(self, data: bytes) -> int:
        self._walk(data, 0, len(data))
        return self.count

    def _walk(self, data, start, end):
        for btype, body, bend in iter_boxes(data, start, end):
            self._box(data, btype, body, bend)
            if btype in _CONTAINERS:
                self._walk(data, body, bend)

    def _version_flags(self, d, b):
        val = _u(d, b, 4)
        return (val >> 24) & 0xFF, val & 0xFFFFFF

    def _matrix(self, d, off):
        return " ".join(f"0x{_u(d, off + 4 * x, 4):08x}" for x in range(9))

    def _box(self, d, t, b, e):
        addr = b - 8
        name = t.decode("latin1")
        if t == b"ftyp":
            # queue_rstring: compatible brands concatenated, NUL/size bound
            brands = bytes(d[b + 8:e]).split(b"\0")[0].decode("latin1")
            self._entry(name, addr, [
                f"MajorBrands: {bytes(d[b:b + 4]).decode('latin1')}",
                f"Version: {_u(d, b + 4, 4)}",
                f"CompatibleBrands: {brands}",
            ])
        elif t in (b"moov", b"trak", b"stbl", b"edts", b"moof", b"traf"):
            self._entry(name, addr, [])
        elif t == b"mvhd":
            ver, flags = self._version_flags(d, b)
            self._entry(name, addr, [
                f"Version: {ver}", f"Flags: {flags}",
                f"CreationTime: {_utc(_u(d, b + 4, 4))}",
                f"ModificationTime: {_utc(_u(d, b + 8, 4))}",
                f"TimeScale: {_u(d, b + 12, 4)}",
                f"Duration: {_u(d, b + 16, 4)}",
                f"PreferedRate: {_u(d, b + 20, 4)}",
                f"PreferedVolume: {_u(d, b + 24, 2)}",
                f"Reserved1: {_u(d, b + 26, 2)}",
                f"Reserved2: {_u(d, b + 28, 4)}",
                f"Reserved3: {_u(d, b + 32, 4)}",
                f"MatrixStructure: {self._matrix(d, b + 36)}",
                f"PreviewTime: {_u(d, b + 72, 4)}",
                f"PreviewDuration: {_u(d, b + 76, 4)}",
                f"PosterTime: {_u(d, b + 80, 4)}",
                f"SelectionTime: {_u(d, b + 84, 4)}",
                f"SelectionDuration: {_u(d, b + 88, 4)}",
                f"CurrentTime: {_u(d, b + 92, 4)}",
                f"NextTrackID: {_u(d, b + 96, 4)}",
            ])
        elif t == b"tkhd":
            ver, flags = self._version_flags(d, b)
            self._entry(name, addr, [
                f"Version: {ver}", f"Flags: {flags}",
                f"CreationTime: {_utc(_u(d, b + 4, 4))}",
                f"ModificationTime: {_utc(_u(d, b + 8, 4))}",
                f"TrackID: {_u(d, b + 12, 4)}",
                f"Reserved1: {_u(d, b + 16, 4)}",
                f"Duration: {_u(d, b + 20, 4)}",
                f"Reserved2: {_u(d, b + 24, 4)}",
                f"Reserved3: {_u(d, b + 28, 4)}",
                f"Layer: {_u(d, b + 32, 2)}",
                f"AlternativeGroup: {_u(d, b + 34, 2)}",
                f"Volume: {_u(d, b + 36, 2)}",
                f"Reserved4: {_u(d, b + 38, 2)}",
                f"MatrixStructure: {self._matrix(d, b + 40)}",
                # u16 reads advanced by 4 in the reference (:399-407)
                f"TrackWidth: {_u(d, b + 76, 2)}",
                f"TrackHeight: {_u(d, b + 80, 2)}",
            ])
        elif t == b"mdhd":
            ver, flags = self._version_flags(d, b)
            self._entry(name, addr, [
                f"Version: {ver}", f"Flags: {flags}",
                f"CreationTime: {_utc(_u(d, b + 4, 4))}",
                f"ModificationTime: {_utc(_u(d, b + 8, 4))}",
                f"TimeScale: {_u(d, b + 12, 4)}",
                f"Duration: {_u(d, b + 16, 4)}",
                f"Language: {_u(d, b + 20, 2)}",
                f"Quality: {_u(d, b + 22, 2)}",
            ])
        elif t == b"hdlr":
            ver, flags = self._version_flags(d, b)
            nm = bytes(d[b + 24:e]).split(b"\0")[0].decode("latin1")
            self._entry(name, addr, [
                f"Version: {ver}", f"Flags: {flags}",
                f"PreDefined: {_u(d, b + 4, 4)}",
                f"ComponentSubtype: {_u(d, b + 8, 4)}",
                f"Reserved1: {_u(d, b + 12, 4)}",
                f"Reserved2: {_u(d, b + 16, 4)}",
                f"Reserved3: {_u(d, b + 20, 4)}",
                f'Name: "{nm}"',
            ])
        elif t == b"elst":
            ver, flags = self._version_flags(d, b)
            cnt = _u(d, b + 4, 4)
            lines = [f"Version: {ver}", f"Flags: {flags}",
                     f"EntryCount: {cnt}"]
            off = b + 8
            for i in range(cnt):
                if ver == 1:
                    lines.append(f"SegmentDuration_{i}: {_s(d, off, 8)}")
                    lines.append(f"MediaTime_{i}: {_s(d, off + 8, 8)}")
                    off += 16
                else:
                    lines.append(f"SegmentDuration_{i}: {_u(d, off, 4)}")
                    lines.append(f"MediaTime_{i}: {_u(d, off + 4, 4)}")
                    off += 8
                lines.append(f"MediaRateInteger_{i}: {_u(d, off, 2)}")
                lines.append(f"MediaRateFraction_{i}: {_u(d, off + 2, 2)}")
                off += 4
            self._entry(name, addr, lines)
        elif t == b"stsd":
            ver, flags = self._version_flags(d, b)
            self._entry(name, addr, [
                f"Version: {ver}", f"Flags: {flags}",
                f"EntryCount: {_u(d, b + 4, 4)}",
            ])
            # the demuxer vlogs the iamf sample entry as its own box
            for bt2, b2, e2 in iter_boxes(d, b + 8, e):
                if bt2 == b"iamf":
                    self._iamf_entry(d, b2, e2)
        elif t == b"stts":
            ver, flags = self._version_flags(d, b)
            cnt = _u(d, b + 4, 4)
            lines = [f"Version: {ver}", f"Flags: {flags}",
                     f"EntryCount: {cnt}"]
            for i in range(cnt):
                lines.append(f"SampleCount_{i}: {_u(d, b + 8 + 8 * i, 4)}")
                lines.append(f"SampleDelta_{i}: {_u(d, b + 12 + 8 * i, 4)}")
            self._entry(name, addr, lines)
        elif t == b"stsc":
            ver, flags = self._version_flags(d, b)
            cnt = _u(d, b + 4, 4)
            lines = [f"Version: {ver}", f"Flags: {flags}",
                     f"EntryCount: {cnt}"]
            for i in range(cnt):
                o = b + 8 + 12 * i
                lines.append(f"FirstChunk_{i}: {_u(d, o, 4)}")
                lines.append(f"SamplePerChunk_{i}: {_u(d, o + 4, 4)}")
                lines.append(f"SampleDescriptionIndex_{i}: {_u(d, o + 8, 4)}")
            self._entry(name, addr, lines)
        elif t == b"stsz":
            ver, flags = self._version_flags(d, b)
            ssize = _u(d, b + 4, 4)
            cnt = _u(d, b + 8, 4)
            lines = [f"Version: {ver}", f"Flags: {flags}",
                     f"SampleSize: {ssize}", f"SampleCount: {cnt}"]
            if ssize == 0:
                for i in range(cnt):
                    lines.append(f"EntrySize_{i}: {_u(d, b + 12 + 4 * i, 4)}")
            self._entry(name, addr, lines)
        elif t == b"stco":
            ver, flags = self._version_flags(d, b)
            cnt = _u(d, b + 4, 4)
            lines = [f"Version: {ver}", f"Flags: {flags}",
                     f"EntryCount: {cnt}"]
            for i in range(cnt):
                lines.append(f"ChunkOffset_{i}: {_u(d, b + 8 + 4 * i, 4)}")
            self._entry(name, addr, lines)
        elif t == b"sgpd":
            ver, flags = self._version_flags(d, b)
            lines = [f"Version: {ver}", f"Flags: {flags}"]
            off = b + 4
            lines.append(f"GroupingType: {_u(d, off, 4)}")
            off += 4
            default_length = 0
            if ver >= 1:
                default_length = _u(d, off, 4)
                lines.append(f"DefaultLength: {default_length}")
                off += 4
            if ver >= 2:
                lines.append(
                    f"DefaultGroupDescriptionIndex: {_u(d, off, 4)}")
                off += 4
            cnt = _u(d, off, 4)
            lines.append(f"EntryCount: {cnt}")
            off += 4
            for i in range(cnt):
                if ver >= 1:
                    if default_length == 0:
                        lines.append(
                            f"DescriptionLength_{i}: {_u(d, off, 4)}")
                        off += 4
                    elif default_length == 1:
                        lines.append(f"GroupingEntryVal_{i}: {_s(d, off, 1)}")
                        off += 1
                    elif default_length == 2:
                        lines.append(f"GroupingEntryVal_{i}: {_s(d, off, 2)}")
                        off += 2
                    elif default_length == 4:
                        lines.append(f"GroupingEntryVal_{i}: {_s(d, off, 4)}")
                        off += 4
            self._entry(name, addr, lines)
        elif t == b"tfhd":
            ver, flags = self._version_flags(d, b)
            # reference prints TrackID masked to 24 bits (:458)
            lines = [f"Version: {ver}", f"Flags: {flags}",
                     f"TrackID: {_u(d, b + 4, 4) & 0xFFFFFF}"]
            off = b + 8
            if flags & 0x01:
                # reference prints the 64-bit BaseDataOffset through the
                # malformed format "%0x08x,%08x" (:464): "%0x" renders the
                # high word as bare hex, "08x," is literal, low word is
                # zero-padded hex — replicated byte-for-byte
                hi, lo = _u(d, off, 4), _u(d, off + 4, 4)
                lines.append(f"BaseDataOffset: {hi:x}08x,{lo:08x}")
                off += 8
            if flags & 0x02:
                lines.append(f"SampleDescriptionIndex: {_u(d, off, 4)}")
                off += 4
            if flags & 0x08:
                lines.append(f"DefaultSampleDuration: {_u(d, off, 4)}")
                off += 4
            if flags & 0x10:
                lines.append(f"DefaultSampleSize: {_u(d, off, 4)}")
                off += 4
            if flags & 0x20:
                lines.append(f"DefaultSampleFlag: {_u(d, off, 4)}")
                off += 4
            self._entry(name, addr, lines)
        elif t == b"trun":
            ver, flags = self._version_flags(d, b)
            cnt = _u(d, b + 4, 4)
            lines = [f"Version: {ver}", f"Flags: {flags}",
                     f"SampleCount: {cnt}"]
            off = b + 8
            if flags & 0x1:
                lines.append(f"DataOffset: {_u(d, off, 4)}")
                off += 4
            if flags & 0x4:
                lines.append(f"FirstSampleFlags: {_u(d, off, 4)}")
                off += 4
            for i in range(cnt):
                if flags & 0x100:
                    lines.append(f"SampleDuration_{i}: {_u(d, off, 4)}")
                    off += 4
                if flags & 0x200:
                    lines.append(f"SampleSize_{i}: {_u(d, off, 4)}")
                    off += 4
                if flags & 0x400:
                    lines.append(f"SampleFlags_{i}: {_u(d, off, 4)}")
                    off += 4
                if flags & 0x800:
                    lines.append(
                        f"SampleCompositionTimeOffset_{i}: {_u(d, off, 4)}")
                    off += 4
            self._entry(name, addr, lines)

    def _iamf_entry(self, d, b, e):
        """IAMF sample entry (write_iamf_atom_log :1156-1301): the 28-byte
        AudioSampleEntry fields, then the codec-config OBU from the inline
        configOBUs description."""
        lines = [
            f"Reserved1: {_u(d, b, 4)}",
            f"Reserved2: {_u(d, b + 4, 2)}",
            f"DataReferenceIndex: {_u(d, b + 6, 2)}",
            f"Reserved3: {_u(d, b + 8, 4)}",
            f"Reserved4: {_u(d, b + 12, 4)}",
            f"ChannelCount: {_u(d, b + 16, 2)}",
            f"SampleSize: {_u(d, b + 18, 2)}",
            f"Predefined: {_u(d, b + 20, 2)}",
            f"Reserved5: {_u(d, b + 22, 2)}",
            f"SampleRate: {_u(d, b + 24, 4) >> 16}",
        ]
        pos = b + 28
        while pos < e:
            hdr = _read_obu_header(d, pos, e)
            if hdr is None:
                break
            obu_type, payload, nxt = hdr
            if obu_type == 0:  # codec config
                ccid, p = _leb128(d, payload)
                lines.append(f"codec_config_id: {ccid}")
                fourcc = bytes(d[p:p + 4])
                if fourcc in (b"Opus", b"mp4a", b"fLaC", b"ipcm"):
                    lines.append(f"codec_id: {fourcc.decode('latin1')}")
                nspf, p2 = _leb128(d, p + 4)
                lines.append(f"num_samples_per_frame: {nspf}")
                lines.append(f"audio_roll_distance: {_s(d, p2, 2)}")
            pos = nxt
        self._entry("iamf", b - 8, lines)


def vlog_mp4(data: bytes, out: TextIO) -> int:
    """Log every box the reference demuxer vlogs; returns the entry count."""
    return MP4VLogger(out).log(data)
