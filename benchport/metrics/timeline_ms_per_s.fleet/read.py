"""timeline_ms_per_s.fleet: host milliseconds inside the program's
front.timeline spans, the parameter timeline replay of every stream, a
second of audio completed in the window (program spans on the host clock)."""

from harness import spans


def read(run):
    return spans.ms_per_s(run, "front.timeline")
