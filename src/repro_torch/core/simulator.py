"""Discrete-event serving simulator — replays an (Azure-like) trace
through a balancing strategy and meters the paper's two objectives:
per-layer MoE forward latency and total inference cost (§3.3, §6.1).

Billing semantics (DESIGN.md §2 / EXPERIMENTS.md):
  * serverful strategies are billed for the full static deployment —
    every expert replica of every layer is resident for the whole
    iteration (provisioned GPU memory);
  * MoEless is billed pay-as-you-go: an expert function's memory is
    billable only while that layer executes.
Non-expert (attention/gate/KV) memory M_misc is billed identically for
everyone.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import costmodel as CM
from repro_torch.core.control import (ControlPlane,  # noqa: F401 (re-export)
                                layer_iteration_cost, meter_layer)
from repro_torch.core.trace import (BatchIteration, ExpertLoadProcess,
                                    TraceConfig, batch_iterations,
                                    generate_requests)


@dataclass(frozen=True)
class PredictorErrorModel:
    """Analytic stand-in for the JAX predictor when simulating at scale:
    per-(layer, distance) accuracy calibrated to paper Figs. 6b/7, used to
    corrupt the actual loads into 'predicted' loads."""
    base: float = 0.95
    distance_slope: float = 0.05
    early_layer_penalty: float = 0.25
    early_layer_tau: float = 4.0
    finetuned: bool = True
    finetune_floor: float = 0.80       # layer-aware target threshold h

    def accuracy(self, layer: int, distance: int) -> float:
        acc = self.base - self.distance_slope * max(0, distance - 1) \
            - self.early_layer_penalty * np.exp(-layer /
                                                self.early_layer_tau)
        if self.finetuned:
            # fine-tuning lifts accuracy but its ceiling still decays with
            # lookahead distance (paper Fig. 7: ~0.93 at d=1 -> ~0.80 at
            # d=5 after fine-tuning)
            floor = (0.93 - 0.032 * (distance - 1)) \
                * (1 - 0.15 * np.exp(-layer / self.early_layer_tau))
            acc = max(acc, floor)
        return float(np.clip(acc, 0.05, 1.0))

    def predict(self, rng, actual: np.ndarray, layer: int,
                distance: int) -> np.ndarray:
        """Mispredicted mass goes to the WRONG experts (a random
        permutation of the true histogram) — mere attenuation would keep
        hot experts hot and hide the cost of low accuracy."""
        acc = self.accuracy(layer, distance)
        total = actual.sum()
        if total == 0:
            return actual.astype(np.float64)
        mis = actual[rng.permutation(actual.size)].astype(np.float64)
        return acc * actual + (1 - acc) * mis


@dataclass
class SimResult:
    strategy: str
    layer_forward_ms: np.ndarray       # all (iteration, layer) samples
    total_cost: float
    mean_replicas_per_layer: float
    cold_starts: int = 0
    prewarmed: int = 0

    def mean_ms(self) -> float:
        return float(self.layer_forward_ms.mean())

    def p99_ms(self) -> float:
        return float(np.percentile(self.layer_forward_ms, 99))

    def cdf(self):
        xs = np.sort(self.layer_forward_ms)
        return xs, np.arange(1, xs.size + 1) / xs.size


@dataclass
class ServingSimulator:
    cfg: "ModelConfig"                 # repro_torch.configs ModelConfig (MoE)
    num_devices: int = 8
    trace: TraceConfig = field(default_factory=TraceConfig)
    prediction_distance: int = 1
    cv_threshold: float = 0.2
    error_model: PredictorErrorModel = field(
        default_factory=PredictorErrorModel)
    seed: int = 0

    def __post_init__(self):
        assert self.cfg.is_moe, "simulator serves MoE models"
        self.num_moe_layers = self.cfg.num_layers \
            // self.cfg.moe.every_n_layers
        self.coeffs = CM.derive_coeffs(self.cfg)
        self.m_misc = CM.misc_memory_bytes(self.cfg)

    def _workload(self):
        reqs = generate_requests(self.trace)
        iters = batch_iterations(reqs, self.trace.duration_s)
        proc = ExpertLoadProcess(
            self.num_moe_layers, self.cfg.moe.num_experts,
            self.cfg.moe.top_k, seed=self.seed)
        return iters, proc

    def run(self, strategy: str, **bal_kw) -> SimResult:
        """Replay the synthetic trace through the ONE control-plane
        implementation (``core.control.ControlPlane``) — identical
        plan/meter/bill semantics to the real-model serving path, with
        the analytic error model standing in for the JAX predictor."""
        iters, proc = self._workload()
        cp = ControlPlane(
            self.cfg, strategy, num_devices=self.num_devices,
            error_model=self.error_model if strategy == "moeless" else None,
            prediction_distance=self.prediction_distance,
            cv_threshold=self.cv_threshold, seed=self.seed + 1, **bal_kw)
        for it in iters:
            cp.step(it.t, None, proc.loads(it.t, it.tokens))
        res = SimResult(
            strategy=strategy,
            layer_forward_ms=np.asarray(cp.layer_latency) * 1e3,
            total_cost=cp.cost,
            mean_replicas_per_layer=float(np.mean(cp.replica_counts)))
        if hasattr(cp.bal, "pools"):
            stats = [p.stats for p in cp.bal.pools.values()]
            res.cold_starts = sum(s.cold_starts for s in stats)
            res.prewarmed = sum(s.prewarmed for s in stats)
        return res

    def run_all(self, strategies=("megatron-lm", "eplb", "oracle",
                                  "moeless")) -> dict:
        return {s: self.run(s) for s in strategies}
