"""call_p95_ms: the 95th percentile of every call's wall time in the
window, in milliseconds (host clock; numpy's linear interpolation)."""

import numpy as np


def read(run):
    return float(np.percentile([c.seconds for c in run.calls], 95)) * 1e3
