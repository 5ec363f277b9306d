"""device_idle_pct.sharded: 100 - the share of the traced window in which
an operation (kernel, copy, memset) ran on the device, averaged over the
cards (device trace)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s(run.devices) / t.window_s)
