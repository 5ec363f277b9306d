"""idle_front_pct.fleet: 100 × the seconds device 0 sat idle while the main
thread's innermost open program span was the constructor (front.construct
and the spans inside it), over the traced window (device trace; the spans
placed on it by spans.clock_fit)."""

from harness import spans


def read(run):
    return spans.idle_pct(run, "front.")
