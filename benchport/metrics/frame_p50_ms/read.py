"""frame_p50_ms: the median of every IAMFDecoder.decode() call of the
window, each one temporal unit to its host PCM, closed loop (host clock).
The serial cell's end-to-end metric: the tail (frame_p95_ms.serial) moves
with stalls of the host of some seconds that a window may or may not
hold, the median does not."""

import numpy as np


def read(run):
    calls = run.win.spans["decode_call"]
    if not calls:
        return None
    return float(np.median([(b - a) * 1e3 for a, b in calls]))
