"""idle_inputs_pct.sharded: 100 × the seconds device 0 sat idle while the main
thread's innermost open program span was the sharded decoder's whole-stream
host entropy (mesh.inputs), over the traced window (device trace; the spans
placed on it by spans.clock_fit)."""

from harness import spans


def read(run):
    return spans.idle_pct(run, "mesh.inputs")
