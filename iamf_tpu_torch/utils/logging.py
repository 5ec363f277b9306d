"""Leveled debug logging (reference: src/common/IAMF_debug.h ia_log* macros).

Level mask via env IAMF_DEBUG (e=error, w=warning, i=info, d=debug, t=trace;
e.g. IAMF_DEBUG=ewid) or set_level()."""

from __future__ import annotations

import os
import sys
import time

_LEVELS = {"e": 0, "w": 1, "i": 2, "d": 3, "t": 4}
_enabled = set(os.environ.get("IAMF_DEBUG", "ew"))


def set_level(levels: str) -> None:
    global _enabled
    _enabled = set(levels)


def _log(level: str, tag: str, msg: str) -> None:
    if level in _enabled:
        ts = time.strftime("%H:%M:%S")
        print(f"[{ts}][{level.upper()}][{tag}] {msg}", file=sys.stderr)


def loge(tag: str, msg: str) -> None:
    _log("e", tag, msg)


def logw(tag: str, msg: str) -> None:
    _log("w", tag, msg)


def logi(tag: str, msg: str) -> None:
    _log("i", tag, msg)


def logd(tag: str, msg: str) -> None:
    _log("d", tag, msg)


def logt(tag: str, msg: str) -> None:
    _log("t", tag, msg)


class StageTimer:
    """Per-stage wall-time accounting for realtime-factor metrics
    (framework equivalent of the reference's absent profiling; SURVEY §5)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def add(self, stage: str, seconds: float) -> None:
        self.totals[stage] = self.totals.get(stage, 0.0) + seconds
        self.counts[stage] = self.counts.get(stage, 0) + 1

    def report(self, audio_seconds: float) -> str:
        lines = []
        total = sum(self.totals.values())
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            t = self.totals[k]
            rtx = audio_seconds / t if t > 0 else float("inf")
            lines.append(
                f"  {k:<16} {t*1000:9.1f} ms  ({100*t/max(total,1e-12):5.1f}%)"
                f"  realtime x{rtx:,.0f}"
            )
        rtx = audio_seconds / total if total > 0 else float("inf")
        lines.append(f"  {'TOTAL':<16} {total*1000:9.1f} ms  realtime x{rtx:,.1f}")
        return "\n".join(lines)
