"""idle_codec_pct.serial: 100 × the seconds device 0 sat idle while the main
thread's innermost open program span was the serial call's codec decode
(serial.codec), over the traced window (device trace; the spans placed on it
by spans.clock_fit)."""

from harness import spans


def read(run):
    return spans.idle_pct(run, "serial.codec")
