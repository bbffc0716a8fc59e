"""Expert load-balancing strategies: the paper's baselines (§6.1) and
MoEless itself.

  MegatronStatic — EP with one replica per expert, fixed placement.
  EPLB           — DeepSeek's periodic balancer: every `period` seconds,
                   re-derive replica counts from the HISTORICAL average
                   loads within the window (fixed redundant-slot budget).
  OracleBalancer — lossy upper bound: perfect per-device balance ignoring
                   routing decisions.
  MoElessBalancer— predicted loads -> Scaler (Alg. 1) -> Placer (Alg. 2)
                   -> serverless pool commit, every iteration, per layer.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.placer import place_layer
from repro_torch.core.plan import LayerPlan, static_plan
from repro_torch.core.scaler import scale_layer
from repro_torch.core.serverless import ServerlessExpertPool


class MegatronStatic:
    """Megatron-LM baseline: static EP, no balancing."""

    name = "megatron-lm"
    serverless = False

    def __init__(self, num_experts: int, num_devices: int):
        self._plan = static_plan(num_experts, num_devices)

    def plan(self, t: float, layer: int, predicted: np.ndarray,
             actual: np.ndarray) -> tuple[LayerPlan, float]:
        return self._plan, 0.0

    def observe(self, t: float, layer: int, loads: np.ndarray) -> None:
        pass


class EPLB:
    """Periodic historical replication (DeepSeek EPLB).

    Every `period` seconds: replica counts proportional to the windowed
    mean loads (largest-remainder apportionment of `budget` total slots,
    min 1 each), greedy balanced placement. Between rebalances the plan is
    frozen — drift makes it stale."""

    name = "eplb"
    serverless = False

    def __init__(self, num_experts: int, num_devices: int, *,
                 budget: int = 0, period: float = 600.0):
        self.e, self.g = num_experts, num_devices
        self.budget = budget or 2 * num_experts
        self.period = period
        # per-LAYER histories and plans: averaging across layers would
        # smear each layer's distinct skew into one flat histogram
        self.hist: dict[int, list[np.ndarray]] = {}
        self.next_rebalance: dict[int, float] = {}
        self._plan: dict[int, LayerPlan] = {}
        self._default = static_plan(num_experts, num_devices)

    def observe(self, t: float, layer: int, loads: np.ndarray) -> None:
        h = self.hist.setdefault(layer, [])
        h.append(np.asarray(loads, np.float64))
        if len(h) > 4096:
            del h[:2048]

    def _rebalance(self, layer: int) -> None:
        h = self.hist.get(layer)
        mean = np.mean(h, axis=0) if h else np.ones(self.e)
        mean = np.maximum(mean, 1e-9)
        quota = mean / mean.sum() * self.budget
        reps = np.maximum(1, np.floor(quota)).astype(np.int64)
        rem = self.budget - reps.sum()
        if rem > 0:
            order = np.argsort(-(quota - reps))
            for i in range(int(rem)):
                reps[order[i % self.e]] += 1
        self._plan[layer] = place_layer(mean, reps, self.g)

    def plan(self, t: float, layer: int, predicted: np.ndarray,
             actual: np.ndarray) -> tuple[LayerPlan, float]:
        if t >= self.next_rebalance.get(layer, 0.0):
            self._rebalance(layer)
            self.next_rebalance[layer] = t + self.period
        return self._plan.get(layer, self._default), 0.0


class OracleBalancer:
    """Upper bound from [24]: ignores routing, spreads load perfectly.
    Lossy — it rewrites token->expert assignments (generation quality is
    affected, §6.1); modelled as exact per-device balance."""

    name = "oracle"
    serverless = False
    lossy = True

    def __init__(self, num_experts: int, num_devices: int):
        self.e, self.g = num_experts, num_devices

    def observe(self, t, layer, loads):
        pass

    def plan(self, t: float, layer: int, predicted: np.ndarray,
             actual: np.ndarray) -> tuple[LayerPlan, float]:
        # express perfect balance as an equal-share plan: every expert gets
        # one replica per ceil(E/G) devices so per-device load = W/G.
        total = float(np.sum(actual))
        flat = np.full(self.e, total / self.e)
        reps = np.ones(self.e, np.int64)
        plan = place_layer(flat, reps, self.g)
        plan._oracle_flat = flat        # simulator uses exact balance
        return plan, 0.0


@dataclass
class MoElessBalancer:
    """The paper's system: per-iteration predicted loads -> Alg.1 -> Alg.2
    with serverless warm-start reuse + pre-warming."""

    num_experts: int
    num_devices: int
    expert_bytes: float
    num_layers: int = 32
    cv_threshold: float = 0.2
    mem_cap_slots: int = 0              # M_cap in slots (0 => 2E)
    max_replicas_per_device: int = 0    # per-GPU slot cap M_g (0 => none)
    keep_alive: float = 60.0
    name: str = "moeless"
    serverless: bool = True
    prev: dict = field(default_factory=dict)
    pools: dict = field(default_factory=dict)

    def pool(self, layer: int) -> ServerlessExpertPool:
        if layer not in self.pools:
            self.pools[layer] = ServerlessExpertPool(
                expert_bytes=self.expert_bytes, keep_alive=self.keep_alive)
        return self.pools[layer]

    def observe(self, t, layer, loads):
        pass

    def plan(self, t: float, layer: int, predicted: np.ndarray,
             actual: np.ndarray, *, exec_time: float = 0.05,
             lead_time: float = 0.02) -> tuple[LayerPlan, float]:
        reps = scale_layer(predicted, cv_threshold=self.cv_threshold,
                           max_total_replicas=self.mem_cap_slots
                           or 2 * self.num_experts)
        pool = self.pool(layer)
        plan = place_layer(
            predicted, reps, self.num_devices, prev=self.prev.get(layer),
            alive=set(pool.instances),
            max_replicas_per_device=self.max_replicas_per_device)
        self.prev[layer] = plan
        ready = pool.commit(plan, t, exec_time, lead_time)
        # serve this iteration with the ready subset; still-cold replicas
        # join next iteration (asynchronous scaling, paper §5). If an
        # expert has no ready replica (only possible before any warmup)
        # the layer waits for its cold start.
        eff_placement, eff_reps, delay = [], [], 0.0
        for e in range(self.num_experts):
            got = [g for g in plan.placement[e] if (e, g) in ready]
            if not got:
                got = plan.placement[e][:1]
                delay = max(delay, pool.cold_start_latency() - lead_time)
            eff_placement.append(got)
            eff_reps.append(len(got))
        eff = LayerPlan(self.num_experts, self.num_devices,
                        np.asarray(eff_reps, np.int64), eff_placement)
        return eff, delay

    def prewarm(self, loads: np.ndarray) -> None:
        """Deployment-time provisioning (paper §5: standard pre-warming):
        commit an initial plan per layer with unlimited lead so the first
        requests hit warm instances."""
        for l in range(self.num_layers):
            self.plan(0.0, l, loads, loads, lead_time=float("inf"))

    def resident_bytes(self, t: float) -> float:
        return sum(p.resident_bytes(t) for p in self.pools.values())


_STRATEGY_KWARGS = {
    "megatron-lm": frozenset(),
    "oracle": frozenset(),
    "eplb": frozenset({"budget", "period"}),
    "moeless": frozenset({"cv_threshold", "mem_cap_slots",
                          "max_replicas_per_device", "keep_alive"}),
}


def make_balancer(kind: str, *, num_experts: int, num_devices: int,
                  expert_bytes: float = 0.0, num_layers: int = 32,
                  **kw):
    if kind not in _STRATEGY_KWARGS:
        raise KeyError(f"unknown balancing strategy {kind!r}; known: "
                       f"{sorted(_STRATEGY_KWARGS)}")
    unknown = set(kw) - _STRATEGY_KWARGS[kind]
    if unknown:
        raise TypeError(
            f"strategy {kind!r} does not accept kwargs "
            f"{sorted(unknown)}; allowed: "
            f"{sorted(_STRATEGY_KWARGS[kind]) or 'none'}")
    if kind == "megatron-lm":
        return MegatronStatic(num_experts, num_devices)
    if kind == "eplb":
        return EPLB(num_experts, num_devices, **kw)
    if kind == "oracle":
        return OracleBalancer(num_experts, num_devices)
    return MoElessBalancer(num_experts, num_devices, expert_bytes,
                           num_layers=num_layers, **kw)
