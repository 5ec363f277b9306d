"""put_gbps.fleet: the bytes the program filled for the device (its counter
h2d_bytes) over the device seconds of the host-to-device copies inside its
plan.copy spans, GB/s: the transfer's own rate, without the wait for the
device that the blocking copy's host time holds (device trace; the spans
placed on it by spans.clock_fit)."""

from harness import spans


def read(run):
    return spans.h2d_gbps(run)
