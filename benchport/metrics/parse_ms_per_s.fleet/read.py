"""parse_ms_per_s.fleet: host milliseconds inside the program's front.parse
spans, the OBU parse and database of every stream (BatchedStreamDecoder's
constructor up to the elements' open), a second of audio completed in the
window (program spans on the host clock)."""

from harness import spans


def read(run):
    return spans.ms_per_s(run, "front.parse")
