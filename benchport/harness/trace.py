"""The device trace of a ``--trace 1`` run, reduced.

The window runs under ``torch.profiler`` with CPU and CUDA activity. The
benchmark marks its own calls into the program with
``torch.profiler.record_function`` ranges (``HOST_RANGES``); the reduction
reads those and the device's kernels, copies and memsets:
- the window: from the first range's start to the last one's end;
- busy: the union of the device's operations inside the window;
- the device operations that took most time, by name;
- the idle gaps, each named by the benchmark's range that was open at its
  middle (the innermost where ranges nest);
- each kernel's device time by name, for the per-layer readers.
"""

from __future__ import annotations

from collections import defaultdict

HOST_RANGES = ("constructor", "serve", "fetch", "decode_call",
               "shard_construct")


class DeviceTrace:
    """ops: [(name, start_us, end_us, device index)] of the device's
    operations; ranges: [(name, start_us, end_us)] of the benchmark's."""

    def __init__(self, ops: list, ranges: list):
        self.ranges = sorted(ranges, key=lambda r: r[1])
        self.t0 = min(r[1] for r in self.ranges)
        self.t1 = max(r[2] for r in self.ranges)
        self.ops = [(n, max(a, self.t0), min(b, self.t1), d)
                    for n, a, b, d in ops if b > self.t0 and a < self.t1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy(self) -> dict:
        """{device: [(start_us, end_us)]}: each device's busy intervals,
        merged."""
        by_dev = defaultdict(list)
        for _, a, b, d in self.ops:
            by_dev[d].append((a, b))
        out = {}
        for d, iv in by_dev.items():
            iv.sort()
            merged = [list(iv[0])]
            for a, b in iv[1:]:
                if a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            out[d] = [tuple(m) for m in merged]
        return out

    def busy_s(self, devices: int = 1) -> float:
        """Seconds the device ran an operation, averaged over `devices`."""
        return sum(b - a for iv in self.busy().values()
                   for a, b in iv) / 1e6 / devices

    def kernel_s(self, symbols: list) -> float:
        """Device seconds of the operations whose name holds a symbol."""
        return sum(b - a for n, a, b, _ in self.ops
                   if any(s in n for s in symbols)) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """The operations that took most device time: [name (its first
        100 characters), seconds]."""
        tot = defaultdict(float)
        for n, a, b, _ in self.ops:
            tot[n[:100]] += (b - a) / 1e6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:top]

    def _host_at(self, t: float) -> str:
        best = None
        for name, a, b in self.ranges:
            if a <= t < b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "between_calls"

    def idle_gaps(self, top: int = 10) -> list:
        """The longest idle spans of device 0 inside the window, each with
        the benchmark's range open at its middle."""
        iv = self.busy().get(0, [])
        edges = [self.t0] + [x for a, b in iv for x in (a, b)] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at((a + b) / 2), (b - a) / 1e6]
                for a, b in gaps[:top]]


def from_profiler(prof) -> DeviceTrace:
    """A DeviceTrace of a finished torch.profiler.profile."""
    ops, ranges = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.name in HOST_RANGES:
            # a range also shows on the device's timeline as an
            # annotation; only the host's is a range, neither is work
            if ev.device_type.name == "CPU":
                ranges.append((ev.name, tr.start, tr.end))
        elif ev.device_type.name == "CUDA":
            ops.append((ev.name, tr.start, tr.end, ev.device_index))
    return DeviceTrace(ops, ranges)
