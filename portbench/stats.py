"""Statistics the metric readers share."""
from __future__ import annotations

import math

import numpy as np


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all values (an infinite value,
    such as a request never answered, ranks last)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if not len(v):
        return math.nan
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


def idle_share_pct(run):
    """The share of the traced stretch in which nothing ran on the
    device, in %; None untraced or where the trace holds no device
    activity at all (a trace that failed, not an idle device)."""
    t = run.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
