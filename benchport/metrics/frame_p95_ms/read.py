"""frame_p95_ms: the 95th percentile (linear between order statistics)
of every IAMFDecoder.decode() call of the window, each one temporal unit
to its host PCM, closed loop (host clock)."""

import numpy as np


def read(run):
    calls = run.win.spans["decode_call"]
    if not calls:
        return None
    return float(np.percentile([(b - a) * 1e3 for a, b in calls], 95))
