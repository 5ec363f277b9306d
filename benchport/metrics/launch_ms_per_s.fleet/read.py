"""launch_ms_per_s.fleet: host milliseconds inside the program's plan.launch
spans, every fused_decode call (the host's time to issue one decode step), a
second of audio completed in the window (program spans on the host clock)."""

from harness import spans


def read(run):
    return spans.ms_per_s(run, "plan.launch")
