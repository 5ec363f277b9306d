"""copy_ms_per_s.fleet: host milliseconds inside the program's plan.copy
spans, each blocking copy of a call's staging buffer to the device: the
wait for the kernels queued before it, then the transfer (put_gbps.fleet
times the transfer alone), a second of audio completed in the window
(program spans on the host clock)."""

from harness import spans


def read(run):
    return spans.ms_per_s(run, "plan.copy")
