"""plan_ms_per_s.fleet: host milliseconds inside the program's plan.build
spans, every host plan (_HostPlan: whole-stream parameters, PCM unpack,
carries), a second of audio completed in the window (program spans on the
host clock)."""

from harness import spans


def read(run):
    return spans.ms_per_s(run, "plan.build")
