"""The program's own spans (iamf_tpu_torch.utils.trace), for the per-layer
readers.

The program records spans while a torch.profiler is active, so the
``--trace 1`` window holds them; the readers take those inside the window
(from the first of the benchmark's host ranges to the end of the last).
A program without the recorder, or a window with none of a reader's
spans, gives None.

The device trace's times are the profiler's, in microseconds; the spans'
and the benchmark's host ranges are ``time.perf_counter``'s. The
benchmark's ranges are on both clocks (``run.win.spans`` and
``run.trace.ranges``), so clock_fit fits ``t_device_us = a + b·t_perf``
over their edges by least squares (Fit), idle_under places each idle
interval of device 0 under the innermost program span that the main
thread had open, and h2d_gbps times the program's input copies on the
device.
"""

from __future__ import annotations

import sys
import threading

import numpy as np


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from iamf_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def window_ns(run) -> tuple[int, int] | None:
    """The window on perf_counter_ns: the benchmark's ranges' extent."""
    ranges = [r for v in run.win.spans.values() for r in v]
    if not ranges:
        return None
    return (int(min(a for a, _ in ranges) * 1e9),
            int(max(b for _, b in ranges) * 1e9))


def in_window(run) -> list:
    """The program's spans that lie inside the window."""
    rec, w = recorder(), window_ns(run)
    if rec is None or w is None:
        return []
    return [r for r in rec.records()
            if r.start_ns >= w[0] and r.end_ns <= w[1]]


def ms_per_s(run, name: str) -> float | None:
    """Host milliseconds inside the window's spans of `name`, a second of
    audio completed in the window."""
    recs = [r for r in in_window(run) if r.name == name]
    if not recs or run.win.audio_s <= 0:
        return None
    return sum(r.end_ns - r.start_ns for r in recs) / 1e6 / run.win.audio_s


def per_call_ms_p50(run, name: str, root: str = "serial.decode"
                    ) -> float | None:
    """The median over the window's calls (root spans) of each call's
    milliseconds inside spans of `name`, grouped by request id."""
    recs = in_window(run)
    if not any(r.name == name for r in recs):
        return None
    total = {r.id: 0 for r in recs if r.name == root}
    for r in recs:
        if r.name == name and r.request in total:
            total[r.request] += r.end_ns - r.start_ns
    if not total:
        return None
    return float(np.median(list(total.values()))) / 1e6


class Fit:
    """t_device_us = a + b·(t_perf_s - x0) + c·end, least squares over
    the range edges (end: 1 at a range's end, 0 at its start). The
    benchmark takes its host clock outside its record_function range, so
    a start edge carries the range's entry cost and an end edge its exit
    cost: each kind gets its own offset, and a time maps with their mean.
    An edge whose residual is past OUTLIER times the median (a pause
    between the host clock and the range's edge) is dropped, and the fit
    made again, until none is. Residuals in us: median and largest of the
    kept edges, largest of all."""

    OUTLIER = 10.0

    def __init__(self, x: np.ndarray, y: np.ndarray, end: np.ndarray,
                 drop: bool = True):
        self.x0 = float(x.mean())
        keep = np.ones(len(x), bool)
        design = np.stack([np.ones(len(x)), x - self.x0,
                           end.astype(np.float64)], axis=1)
        while True:
            coef = np.linalg.lstsq(design[keep], y[keep], rcond=None)[0]
            signed = y - design @ coef
            res = np.abs(signed)
            cut = max(self.OUTLIER * float(np.median(res[keep])), 10.0)
            drop_now = keep & (res > cut)
            if not drop or not drop_now.any():
                break
            keep &= ~drop_now
        self.a, self.b, self.c = (float(v) for v in coef)
        self.pairs = len(x)
        self.keep, self.signed = keep, signed
        self.dropped = int((~keep).sum())
        self.median_us = float(np.median(res[keep]))
        self.max_us = float(res[keep].max())
        self.max_all_us = float(res.max())

    def dropped_edges(self, x: np.ndarray, end: np.ndarray) -> str:
        """Where the dropped edges lie, against a pause and a drift. A
        pause between the host clock and the range's edge puts a start
        edge late on the device (residual > 0) and an end edge early
        (< 0), each edge alone; a drift moves both edges of a range the
        same way, and the kept edges near it."""
        out = ~self.keep
        if not out.any():
            return "none dropped"
        s, e = out & (end == 0), out & (end == 1)
        where = (x - x.min()) / max(float(np.ptp(x)), 1e-12)
        # the other edge of each dropped one (edges come start, end)
        alone = int((out & self.keep[np.arange(len(x)) ^ 1]).sum())
        tenth = np.minimum((10 * where).astype(int), 9)
        drift = max(abs(float(self.signed[self.keep & (tenth == k)].mean()))
                    for k in range(10) if (self.keep & (tenth == k)).any())
        pos = np.quantile(where[out], [0, .25, .5, .75, 1])
        res = np.sort(self.signed[out])[[0, -1]]
        return (f"{int(s.sum())} start edges, "
                f"{int((self.signed[s] > 0).sum())} of them late; "
                f"{int(e.sum())} end edges, "
                f"{int((self.signed[e] < 0).sum())} of them early; "
                f"{alone} with the range's other edge kept; at "
                f"{np.round(pos, 3).tolist()} of the window (min, "
                f"quartiles, max); residuals {np.round(res, 1).tolist()} us "
                f"(least, most); the kept edges' mean residual by tenth of "
                f"the window within {drift:.3f} us")

    def us(self, t_s):
        return (self.a + self.c / 2
                + self.b * (np.asarray(t_s, np.float64) - self.x0))


def _edges(run):
    """The range edges on both clocks: each start and end of
    run.win.spans[k] paired with the range of the same name and order in
    run.trace.ranges."""
    xs, ys, ends = [], [], []
    for name, host in run.win.spans.items():
        dev = [r for r in run.trace.ranges if r[0] == name]
        for (a, b), (_, da, db) in zip(sorted(host), dev):
            xs += [a, b]
            ys += [da, db]
            ends += [0, 1]
    return (np.array(xs, np.float64), np.array(ys, np.float64),
            np.array(ends))


def clock_fit(run, drop: bool = True) -> Fit | None:
    """The fit of the device trace's clock on perf_counter over the range
    edges (drop=False: over all of them, no edge dropped). Printed once a
    run on standard error, with where the dropped edges lie."""
    key = "_clock_fit" if drop else "_clock_fit_all"
    if getattr(run, key, None) is not None:
        return getattr(run, key)
    if run.trace is None:
        return None
    x, y, end = _edges(run)
    if len(x) < 6:
        return None
    fit = Fit(x, y, end, drop)
    setattr(run, key, fit)
    if drop:
        print(f"clock fit (perf_counter to the device trace): {fit.pairs} "
              f"edges, {fit.dropped} dropped; median |residual| "
              f"{fit.median_us:.3f} us, largest {fit.max_us:.3f} us (of "
              f"all {fit.max_all_us:.3f}); end edges {fit.c:+.3f} us from "
              f"starts; dropped: {fit.dropped_edges(x, end)}",
              file=sys.stderr)
    return fit


def self_intervals(recs: list) -> list:
    """[(start_ns, end_ns, name)]: where each span of one thread is the
    innermost open one (its interval less its children's)."""
    kids: dict = {}
    ids = {r.id for r in recs}
    for r in recs:
        if r.parent in ids:
            kids.setdefault(r.parent, []).append(r)
    out = []
    for r in recs:
        t = r.start_ns
        for c in sorted(kids.get(r.id, []), key=lambda c: c.start_ns):
            if c.start_ns > t:
                out.append((t, c.start_ns, r.name))
            t = max(t, c.end_ns)
        if r.end_ns > t:
            out.append((t, r.end_ns, r.name))
    return sorted(out)


def idle_intervals(trace, device: int = 0) -> list:
    """[(start_us, end_us)]: where `device` ran nothing in the window."""
    t = trace.t0
    out = []
    for a, b in trace.busy().get(device, []):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if trace.t1 > t:
        out.append((t, trace.t1))
    return out


def idle_under(run, prefix: str, thread: int | None = None,
               drop: bool = True) -> float | None:
    """Seconds device 0 sat idle in the window while the innermost span
    open on `thread` (the main thread by default) had a name starting with
    `prefix`, the spans placed by clock_fit(run, drop). None without a
    device trace holding device 0's work, a clock fit or such a span."""
    t = run.trace
    if t is None or not t.busy().get(0):
        return None
    thread = threading.main_thread().ident if thread is None else thread
    recs = [r for r in in_window(run) if r.thread == thread]
    if not any(r.name.startswith(prefix) for r in recs):
        return None
    fit = clock_fit(run, drop)
    if fit is None:
        return None
    mine = [(a, b) for a, b, n in self_intervals(recs)
            if n.startswith(prefix)]
    if not mine:
        return None
    ends = fit.us(np.array(mine, np.float64) / 1e9)
    total, j = 0.0, 0
    idle = idle_intervals(t)
    for a, b in ends:
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < b:
            total += min(b, idle[k][1]) - max(a, idle[k][0])
            k += 1
    return total / 1e6


def idle_pct(run, prefix: str) -> float | None:
    """100 × idle_under(run, prefix) over the window's seconds. Where the
    fit dropped edges, the reading with the fit over all edges is printed
    beside it on standard error."""
    s = idle_under(run, prefix)
    if s is None or run.trace.window_s <= 0:
        return None
    if run._clock_fit.dropped:
        every = idle_under(run, prefix, drop=False)
        print(f"idle under {prefix}: {100.0 * s / run.trace.window_s:.4f} "
              f"% of the window on the fit over the kept edges, "
              f"{100.0 * every / run.trace.window_s:.4f} % on the fit over "
              "all edges", file=sys.stderr)
    return 100.0 * s / run.trace.window_s


def h2d_gbps(run) -> float | None:
    """GB/s of the program's input copies to device 0: the bytes of the
    counter h2d_bytes over the device seconds of the host-to-device copies
    whose middle lies inside a main-thread plan.copy span (placed by the
    clock fit). The counter counts while the recorder is on, in a
    ``--trace 1`` run the profiled window, whose copies all lie in the
    window's spans."""
    rec, t = recorder(), run.trace
    if rec is None or t is None:
        return None
    n = rec.counters().get("h2d_bytes", 0)
    main = threading.main_thread().ident
    mine = sorted((r.start_ns, r.end_ns) for r in in_window(run)
                  if r.name == "plan.copy" and r.thread == main)
    fit = clock_fit(run) if mine and n > 0 else None
    if fit is None:
        return None
    iv = fit.us(np.array(mine, np.float64) / 1e9)
    starts = iv[:, 0]
    us = 0.0
    for op, a, b, d in t.ops:
        if d != 0 or "HtoD" not in op:
            continue
        k = int(np.searchsorted(starts, (a + b) / 2, side="right")) - 1
        if k >= 0 and (a + b) / 2 <= iv[k, 1]:
            us += b - a
    if us <= 0:
        return None
    return n / us / 1e3
