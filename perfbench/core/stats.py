"""Percentiles and spreads on the harness's host-clock records."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float, missing: int = 0):
    """The nearest-rank q-th percentile (0 < q <= 100) of `values` plus
    `missing` samples that lie above every value (failed or unfinished
    requests). None where that rank falls on a missing sample or there
    is no sample."""
    n = len(values) + missing
    if n == 0:
        return None
    rank = max(1, math.ceil(q / 100.0 * n))
    vals = sorted(values)
    return vals[rank - 1] if rank <= len(vals) else None


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
