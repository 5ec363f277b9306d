"""frame_p50_ms.serial: the median of the same decode() calls as
frame_p95_ms (host clock)."""

import numpy as np


def read(run):
    calls = run.win.spans["decode_call"]
    if not calls:
        return None
    return float(np.median([(b - a) * 1e3 for a, b in calls]))
