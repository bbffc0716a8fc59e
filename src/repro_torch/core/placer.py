"""Expert Placer — paper Algorithm 2.

Places replicas on devices most-loaded-first. If the previous plan already
has an alive replica of the same expert on some device (and that device
still has slot capacity), reuse it — a serverless *warm start* that avoids
weight transfer. Otherwise join-the-shortest-queue: the device with the
lowest aggregated load.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.plan import LayerPlan


def place_layer(loads: np.ndarray, replicas: np.ndarray, num_devices: int,
                prev: LayerPlan | None = None,
                *, alive: set | None = None,
                max_replicas_per_device: int = 0) -> LayerPlan:
    """Algorithm 2 for one layer.

    loads: (E,) expert loads; replicas: (E,) replica counts from the
    Scaler. Returns a LayerPlan. `max_replicas_per_device` models the
    per-GPU memory constraint M_g (0 => unconstrained). `alive` is the
    serverless pool's live {(expert, device)} set — keep-alive means warm
    replicas can outlive the previous plan, so warm-start reuse consults
    the pool, not just `prev` (paper §4.3 'kept alive on a GPU').
    """
    loads = np.asarray(loads, np.float64)
    e_count = loads.shape[0]
    per_replica = loads / np.maximum(replicas, 1)

    # all replicas, most-loaded first (ties: lower expert id first)
    todo = []
    for e in range(e_count):
        for r in range(int(replicas[e])):
            todo.append((per_replica[e], e, r))
    todo.sort(key=lambda t: (-t[0], t[1], t[2]))

    prev_alive = set(alive) if alive is not None else set()
    if prev is not None:
        prev_alive |= prev.alive_set()
    dev_load = np.zeros(num_devices)
    dev_count = np.zeros(num_devices, np.int64)
    placement = [[] for _ in range(e_count)]
    cap = max_replicas_per_device or (1 << 30)

    for w, e, _r in todo:
        used = set(placement[e])
        # warm start: an alive previous replica of e on a device we have
        # not already used for e in this plan
        warm = [g for (ee, g) in prev_alive
                if ee == e and g not in used and dev_count[g] < cap]
        if warm:
            g = min(warm, key=lambda g: dev_load[g])
        else:
            order = np.argsort(dev_load, kind="stable")
            g = next((int(gg) for gg in order
                      if dev_count[gg] < cap and int(gg) not in used),
                     int(order[0]))  # degenerate: more replicas than devices
        placement[e].append(int(g))
        dev_load[g] += w
        dev_count[g] += 1

    return LayerPlan(e_count, num_devices, replicas.astype(np.int64),
                     placement)


def placement_migrations(prev: LayerPlan | None, new: LayerPlan) -> int:
    """Number of replica slots that require a cold start (weight movement)
    relative to the previous plan."""
    if prev is None:
        return new.total_replicas
    alive = prev.alive_set()
    cold = 0
    for e in range(new.num_experts):
        for g in new.placement[e]:
            if (e, g) not in alive:
                cold += 1
    return cold
