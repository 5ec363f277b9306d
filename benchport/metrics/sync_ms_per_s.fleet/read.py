"""sync_ms_per_s.fleet: host milliseconds inside the program's plan.sync spans,
the wait for the device that ends each bucket, a second of audio completed
in the window (program spans on the host clock)."""

from harness import spans


def read(run):
    return spans.ms_per_s(run, "plan.sync")
