"""put_ms_per_s.fleet: host milliseconds inside the program's plan.put
spans, each fill of a call's inputs into its host staging buffer (the
blocking copy that follows is copy_ms_per_s.fleet's), a second of audio
completed in the window (program spans on the host clock)."""

from harness import spans


def read(run):
    return spans.ms_per_s(run, "plan.put")
