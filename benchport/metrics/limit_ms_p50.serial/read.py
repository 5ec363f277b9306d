"""limit_ms_p50.serial: the median over the window's decode() calls
(serial.decode, the root span) of each call's host milliseconds inside its
serial.limit spans: the limiter, quantize and the copy of the PCM to the
host (program spans on the host clock)."""

from harness import spans


def read(run):
    return spans.per_call_ms_p50(run, "serial.limit")
