"""k8_roofline_pct.fleet: K8's function (HRTF convolution of the bed to two
ears): its bound over its device time in the traced window, %. The bound
(harness/roofline.py: bytes over 3.35 TB/s or the fewest operations over
67 TFLOP/s, H100 SXM at 700 W) is of the work the streams completed in the
window need: every sample of every stream's loudspeaker bed once. The
device time is that of the kernels named under kernels/ (device trace)."""

from harness import roofline


def read(run):
    if run.trace is None or not run.win.streams_done:
        return None
    t = run.trace.kernel_s(run.symbols)
    if t <= 0:
        return None
    cfg = run.cfg
    bound = sum(roofline.k8_bound(s.units * s.frame, cfg["channels"],
                                  cfg["hrir"]["taps"])
                for s in run.win.streams_done)
    return 100.0 * bound / t
