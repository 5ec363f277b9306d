"""frame_p95_ms.serial: the 95th percentile (linear between order
statistics) of the same decode() calls as frame_p50_ms (host clock)."""

import numpy as np


def read(run):
    calls = run.win.spans["decode_call"]
    if not calls:
        return None
    return float(np.percentile([(b - a) * 1e3 for a, b in calls], 95))
