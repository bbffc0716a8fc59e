"""Serverless expert-function lifecycle (paper §2.4/§5, adapted per
DESIGN.md §2 to TPU replica slots).

Each (layer, expert, device) replica is a *function instance* with the
standard serverless lifecycle: cold start (weight materialisation over
ICI + slot activation), warm reuse, fixed-duration keep-alive, and
pre-warming driven by the Expert Load Predictor's lead time. Instance-
seconds are metered for the pay-as-you-go cost model.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.costmodel import Hardware, V5E
from repro_torch.core.plan import LayerPlan


def cold_start_latency(expert_bytes: float, hw: Hardware = V5E) -> float:
    """Modeled cold start of ONE expert function instance: slot/program
    activation plus streaming the replica weights over ICI. Shared by the
    analytic ``ServerlessExpertPool`` and the executing
    ``serving.expert_runtime.ExpertRuntime`` so both classify a replica
    as prewarmed (hidden by the predictor's lead) or cold identically.

    `expert_bytes` must come from ``costmodel.param_bytes(cfg)`` (via
    ``derive_coeffs``): it is derived from the model dtype and the slot
    storage format (``cfg.moe.slot_dtype``), never hardcoded, so the
    cost model and the runtime can never silently disagree on the byte
    base — int8 slot banks really do cold-start ~4x faster and bill
    ~4x fewer GB-s."""
    return hw.instance_startup_s + expert_bytes / hw.ici_bw


@dataclass
class InstanceStats:
    cold_starts: int = 0
    warm_starts: int = 0
    prewarmed: int = 0
    instance_seconds_gb: float = 0.0   # metered GB-seconds of alive experts


@dataclass
class _Instance:
    born: float
    last_used: float


@dataclass
class ServerlessExpertPool:
    """Pool of expert function instances for ONE MoE layer."""
    expert_bytes: float
    keep_alive: float = 60.0
    hw: Hardware = field(default_factory=lambda: V5E)
    instances: dict = field(default_factory=dict)   # (e, g) -> _Instance
    stats: InstanceStats = field(default_factory=InstanceStats)

    def cold_start_latency(self) -> float:
        return cold_start_latency(self.expert_bytes, self.hw)

    def _reap(self, now: float) -> None:
        dead = [k for k, inst in self.instances.items()
                if now - inst.last_used > self.keep_alive]
        for k in dead:
            inst = self.instances.pop(k)
            alive = (inst.last_used + self.keep_alive) - inst.born
            self.stats.instance_seconds_gb += alive * self.expert_bytes / 1e9

    def commit(self, plan: LayerPlan, now: float, exec_time: float,
               lead_time: float) -> set:
        """Apply a placement plan decided at `now` for an execution at
        `now + lead_time`. Scaling is asynchronous (paper §5): replicas
        whose cold start is hidden by the prediction lead are ready;
        replicas still materialising serve from the NEXT iteration.
        Returns the set of (expert, device) pairs READY at exec time."""
        self._reap(now)
        ready = set()
        for key in plan.iter_replicas():
            if key in self.instances:
                self.instances[key].last_used = now + lead_time \
                    + exec_time
                self.stats.warm_starts += 1
                ready.add(key)
            else:
                cs = self.cold_start_latency()
                if cs <= lead_time:
                    self.stats.prewarmed += 1
                    ready.add(key)
                else:
                    self.stats.cold_starts += 1
                self.instances[key] = _Instance(
                    born=now, last_used=now + lead_time + exec_time)
        return ready

    def resident_bytes(self, now: float) -> float:
        self._reap(now)
        return len(self.instances) * self.expert_bytes

    def finalize(self, now: float) -> InstanceStats:
        for inst in self.instances.values():
            alive = min(now, inst.last_used + self.keep_alive) - inst.born
            self.stats.instance_seconds_gb += alive * self.expert_bytes / 1e9
        self.instances.clear()
        return self.stats
