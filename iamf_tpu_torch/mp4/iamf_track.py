"""IAMF-in-MP4 track parser (reference: mp4iamfpar.c).

Wraps the box-level demuxer: exposes descriptor OBUs (from the 'iamf'
sample entry), per-packet reads that re-emit descriptors on sample-
description change (mp4_iamf_parser_read_packet :111-189), and
seek-to-seconds by walking sample deltas (:203-233).
"""

from __future__ import annotations

from typing import Iterator, Optional

from .demux import MP4Demuxer


class MP4IAMFParser:
    def __init__(self, path: str):
        self.demux = MP4Demuxer(path)
        trk = self.demux.iamf_track
        if trk is None or not trk.entries:
            raise ValueError(f"{path}: no IAMF audio track")
        self.track = trk
        self.timescale = trk.timescale or 48000
        self.skip_samples = trk.elst_media_time
        self.start_index = 0
        self._cur_desc = 1

    @property
    def descriptors(self) -> bytes:
        return self.track.entries[0].descriptors

    def seek(self, seconds: float) -> int:
        """Walk sample deltas to the target time; returns start sample index
        (mp4_iamf_parser_set_starting_time)."""
        target = int(seconds * self.timescale)
        t = 0
        for i, delta in enumerate(self.track.deltas):
            if t + delta > target:
                self.start_index = i
                return i
            t += delta
        self.start_index = len(self.track.deltas)
        return self.start_index

    def packets(self) -> Iterator[tuple[bytes, Optional[bytes]]]:
        """Yield (packet_bytes, new_descriptor_obus_or_None)."""
        for i in range(self.start_index, self.demux.n_samples):
            pkt = self.demux.sample(i)
            if pkt is None:
                return
            sdi = self.demux.sample_desc_index(i)
            new_desc = None
            if sdi != self._cur_desc and 0 < sdi <= len(self.track.entries):
                new_desc = self.track.entries[sdi - 1].descriptors
                self._cur_desc = sdi
            yield pkt, new_desc
