"""k3_roofline_pct.fleet: K3's function (limiter + s16 of the mix): its bound
over its device time in the traced window, %. The bound
(harness/roofline.py: bytes over 3.35 TB/s or the fewest operations over
67 TFLOP/s, H100 SXM at 700 W) is of the work the streams completed in the
window need: every output sample of every stream once. The device time is
that of the kernels named under kernels/ (device trace)."""

from harness import roofline


def read(run):
    if run.trace is None or not run.win.streams_done:
        return None
    t = run.trace.kernel_s(run.symbols)
    if t <= 0:
        return None
    cfg = run.cfg
    out = 2 if cfg["binaural"] else len(cfg["output_channels"])
    bound = sum(roofline.k3_bound(s.units * s.frame, out)
                for s in run.win.streams_done)
    return 100.0 * bound / t
