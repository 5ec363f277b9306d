"""elements_ms_per_s.fleet: host milliseconds inside the program's
front.elements spans, every element's open (codecs, matrices, the HRIR bank,
synthesis constants), a second of audio completed in the window (program
spans on the host clock)."""

from harness import spans


def read(run):
    return spans.ms_per_s(run, "front.elements")
