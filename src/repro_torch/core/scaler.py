"""Expert Scaler — paper Algorithm 1.

Greedy heuristic: start from one replica per expert; repeatedly pop the
most-loaded *replica group* from a max-heap and add one replica to that
expert (its load splits evenly across replicas), until either the
coefficient of variation of per-replica loads drops below the threshold V
or the per-layer memory cap M_cap (counted in replica slots) is reached.
"""
from __future__ import annotations

import heapq

import numpy as np


def coefficient_of_variation(x: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    m = x.mean()
    if m <= 0:
        return 0.0
    return float(x.std() / m)


def scale_layer(loads: np.ndarray, *, cv_threshold: float = 0.2,
                max_total_replicas: int = 0) -> np.ndarray:
    """Algorithm 1 for one layer.

    loads: (E,) predicted expert token loads W_{l,e}.
    max_total_replicas: the memory cap M_cap expressed in replica slots
    (0 => 2*E, a sensible default matching the paper's per-layer budget).
    Returns replicas (E,) int >= 1.
    """
    loads = np.asarray(loads, np.float64)
    e_count = loads.shape[0]
    cap = max_total_replicas or 2 * e_count
    cap = max(cap, e_count)            # at least one replica per expert
    replicas = np.ones(e_count, np.int64)

    # max-heap of (-per_replica_load, expert)
    heap = [(-loads[e], e) for e in range(e_count)]
    heapq.heapify(heap)

    def cv() -> float:
        per_rep = np.repeat(loads / replicas, replicas)
        return coefficient_of_variation(per_rep)

    total = e_count
    while total < cap and cv() > cv_threshold:
        neg, e = heapq.heappop(heap)
        if -neg <= 0:                  # all remaining loads zero: balanced
            heapq.heappush(heap, (neg, e))
            break
        replicas[e] += 1
        total += 1
        heapq.heappush(heap, (-loads[e] / replicas[e], e))
    return replicas


def target_forward_latency(loads: np.ndarray, replicas: np.ndarray,
                           alpha: float) -> float:
    """The layer's straggler-bound expert time max_{e,r} T_{l,e,r} (§3.3)."""
    per = loads / np.maximum(replicas, 1)
    return float(alpha * per.max())
