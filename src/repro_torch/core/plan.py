"""Replica plans — the output of the Expert Scaler / Placer control plane.

A plan for one MoE layer says, for every expert e, how many replicas
R^{(l,e)} exist and on which device each replica lives (paper §3.3:
decision variables r^{(i,l,e)} and p^{(i,l,e)}_{r,g}).

On TPU the plan is materialised as fixed-size *slot tables* so the jitted
EP dispatch can consume it without recompilation: slot s holds
(expert_id, device_id, valid). ``max_slots`` is the serverless concurrency
limit analogue (DESIGN.md §2).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class LayerPlan:
    """Replica plan for a single MoE layer."""
    num_experts: int
    num_devices: int
    replicas: np.ndarray        # (E,) int — R^{(l,e)} >= 1
    placement: list             # placement[e] = list of device ids, len R_e

    def __post_init__(self):
        self.replicas = np.asarray(self.replicas, np.int64)
        assert len(self.placement) == self.num_experts
        for e in range(self.num_experts):
            assert len(self.placement[e]) == int(self.replicas[e]), \
                (e, self.placement[e], self.replicas[e])

    @property
    def total_replicas(self) -> int:
        return int(self.replicas.sum())

    def per_device_load(self, loads: np.ndarray) -> np.ndarray:
        """Aggregated per-GPU load W_g given expert loads (E,) — each
        expert's load split evenly across its replicas (paper step 4)."""
        w = np.zeros(self.num_devices)
        for e in range(self.num_experts):
            share = loads[e] / self.replicas[e]
            for g in self.placement[e]:
                w[g] += share
        return w

    def per_replica_load(self, loads: np.ndarray) -> np.ndarray:
        """W_{l,e,r} for every replica (flattened)."""
        out = []
        for e in range(self.num_experts):
            out.extend([loads[e] / self.replicas[e]] * int(self.replicas[e]))
        return np.asarray(out)

    def slot_tables(self, max_slots: int):
        """Fixed-size arrays for the jitted EP dispatch:
        (slot_expert (S,), slot_device (S,), slot_valid (S,),
         expert_nrep (E,), expert_slot_start (E,)).
        Replicas of one expert occupy contiguous slots."""
        assert self.total_replicas <= max_slots, \
            f"plan needs {self.total_replicas} slots > max {max_slots}"
        slot_expert = np.zeros(max_slots, np.int32)
        slot_device = np.zeros(max_slots, np.int32)
        slot_valid = np.zeros(max_slots, bool)
        start = np.zeros(self.num_experts, np.int32)
        s = 0
        for e in range(self.num_experts):
            start[e] = s
            for g in self.placement[e]:
                slot_expert[s] = e
                slot_device[s] = g
                slot_valid[s] = True
                s += 1
        return (slot_expert, slot_device, slot_valid,
                self.replicas.astype(np.int32), start)

    def alive_set(self) -> set:
        """{(expert, device)} pairs with a live replica — used by the
        placer's warm-start check and the serverless lifecycle."""
        return {(e, g) for e in range(self.num_experts)
                for g in self.placement[e]}

    def iter_replicas(self):
        """Yield every (expert, device) replica in the canonical commit
        order (expert-major, replica order within an expert). The
        analytic ``ServerlessExpertPool`` and the executing
        ``ExpertRuntime`` both walk plans in THIS order, so their
        cold/warm/prewarm classification of duplicate (expert, device)
        pairs agrees replica-for-replica."""
        for e in range(self.num_experts):
            for g in self.placement[e]:
                yield e, int(g)

    def diff_size(self, resident: set) -> int:
        """Number of replicas in this plan with no warm (expert, device)
        instance in `resident` — the minimal slot-transfer count needed
        to execute the plan (function locality: warm replicas are never
        re-copied)."""
        seen = set(resident)
        cold = 0
        for key in self.iter_replicas():
            if key not in seen:
                cold += 1
                seen.add(key)
        return cold


def static_plan(num_experts: int, num_devices: int) -> LayerPlan:
    """Megatron-LM baseline: one replica per expert, round-robin EP
    placement (expert e on device e % G)."""
    return LayerPlan(
        num_experts, num_devices,
        replicas=np.ones(num_experts, np.int64),
        placement=[[e % num_devices] for e in range(num_experts)])


@dataclass
class ModelPlan:
    """Plans for all MoE layers of a model."""
    layers: list = field(default_factory=list)   # list[LayerPlan]

    def __getitem__(self, i: int) -> LayerPlan:
        return self.layers[i]

    def __len__(self) -> int:
        return len(self.layers)

    def total_expert_memory(self, bytes_per_expert: float) -> float:
        return bytes_per_expert * sum(p.total_replicas for p in self.layers)
