"""The ONE control-plane implementation (paper §3.2 workflow).

Every consumer — the real-model ``ServingEngine``, the analytic
``core.simulator``, and ``benchmarks/serving_bench.py`` — drives the
same entry point:

    ControlPlane.step(t, gate_inputs, actual_loads, token_mask,
                      dropped=, phase=)
        -> IterationOutcome(latency_s, cost, plans)

One ``step`` call plans EVERY MoE layer for one serving iteration under
the configured balancing strategy, meters the paper's two objectives
(modeled per-layer MoE forward latency + pay-as-you-go cost with the
billing semantics of DESIGN.md §2), and returns the modeled iteration
latency that advances the serving clock.

Predicted loads come from one of three interchangeable sources:
  * a real ``LoadPredictor`` (gate replicas, one jitted batched call,
    ONE device->host transfer per iteration — ``host_transfers`` counts
    them),
  * an analytic ``PredictorErrorModel`` (simulator path: host arrays,
    accuracy-calibrated corruption of the actual loads),
  * the actual loads themselves (non-predictive strategies).

``MoElessController`` is a thin adapter over the same class that only
adds EP slot-table export (``plan_tables``) for the EP slot data
plane — the scale/place/meter loop is NOT duplicated there.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core import costmodel as CM
from repro_torch.core.balancer import make_balancer
from repro_torch.core.costmodel import derive_coeffs


# ------------------------------------------------------------- metering

# modeled per-layer execution time a serverless commit extends an
# instance's keep-alive by (paper §5 asynchronous scaling); shared with
# the executing ExpertRuntime so pool and runtime lifecycles agree
MOELESS_EXEC_TIME = 0.05


def default_slots_per_device(num_experts: int, num_devices: int) -> int:
    """Per-device expert slot cap covering the scaler's 2E replica
    budget with headroom — the ONE default shared by the controller's
    slot-table export and the executing ExpertRuntime, so plan and
    execution always agree on slot geometry."""
    return max(2, (2 * num_experts) // num_devices + 1)


def moeless_lead_time(actual: np.ndarray, *, coeffs, num_devices: int,
                      prediction_distance: int = 1) -> float:
    """The predictor's lead: forward time of `distance` earlier layers —
    the window a cold start can hide inside (paper §5)."""
    return prediction_distance * (coeffs.t_misc + coeffs.alpha
                                  * actual.sum() / num_devices)


def meter_layer(bal, t: float, layer: int, predicted: np.ndarray,
                actual: np.ndarray, *, coeffs, num_devices: int,
                prediction_distance: int = 1):
    """Plan + meter ONE (iteration, layer) under a balancer — the single
    source of the control-plane latency semantics. MoEless gets its
    prediction lead (forward time of `distance` earlier layers); lossy
    strategies are timed at perfect balance. Returns
    (t_fwd_seconds, plan)."""
    if bal.name == "moeless":
        lead = moeless_lead_time(actual, coeffs=coeffs,
                                 num_devices=num_devices,
                                 prediction_distance=prediction_distance)
        plan, delay = bal.plan(t, layer, predicted, actual,
                               lead_time=lead, exec_time=MOELESS_EXEC_TIME)
    else:
        plan, delay = bal.plan(t, layer, predicted, actual)
    bal.observe(t, layer, actual)
    if getattr(bal, "lossy", False):
        t_fwd = CM.oracle_forward_time(actual, num_devices, coeffs)
    else:
        t_fwd = CM.layer_forward_time(plan, actual, coeffs)
    return t_fwd + delay, plan


def layer_iteration_cost(bal, plan, t_fwd: float, *, coeffs,
                         full_expert_bytes: float, m_misc: float) -> float:
    """Billing for ONE (iteration, layer) — serverless strategies pay for
    the replicas actually resident during the layer, serverful ones for
    the full static deployment; misc memory is billed identically."""
    layer_bytes = (plan.total_replicas * coeffs.expert_bytes
                   if getattr(bal, "serverless", False)
                   else full_expert_bytes)
    return CM.iteration_cost(t_fwd, layer_bytes) \
        + CM.iteration_cost(coeffs.t_misc, m_misc)


def _to_host(a):
    """A device tensor (or host array) as a numpy array: one
    ``.detach().cpu().numpy()`` per tensor."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _fetch_loads(predictor, top_k, gate_inputs, actual_loads, token_mask,
                 dropped=None):
    """(predicted, actual, dropped) per-layer loads on host, fetched
    once per iteration: one ``.detach().cpu().numpy()`` per tensor, so
    the iteration still costs ONE host sync (the first copy waits for
    the device; the rest find their inputs ready). With a predictor the
    batched gate-replica call runs on device first; without one the
    actual loads serve as the prediction. `dropped` (the data plane's
    per-layer dropped-token counts, or None) rides the same sync —
    metering drops must not add a second host round-trip to the
    iteration."""
    if predictor is not None and gate_inputs is not None:
        dev = predictor.predict_loads_all(gate_inputs, actual_loads, top_k,
                                          token_mask=token_mask)
        pred = _to_host(dev)
        acts = _to_host(actual_loads)
    else:
        acts = _to_host(actual_loads)
        pred = acts
    drp = None if dropped is None else _to_host(dropped)
    return (np.maximum(np.asarray(pred, np.float64), 0),
            np.asarray(acts, np.float64),
            None if drp is None else np.asarray(drp, np.float64))


@dataclass(frozen=True)
class PlanEvent:
    """Everything the data plane needs to EXECUTE one (iteration, layer)
    planning decision (consumed by ``serving.expert_runtime``):

      plan       — the FULL replica plan (every replica, warm or cold);
                   slot transfers are diffed against this.
      served     — the effective warm-subset plan routed THIS iteration
                   (replicas whose cold start the lead time could not
                   hide join from the next iteration; serverful
                   strategies: identical to `plan`).
      lead_time  — the predictor's lead the commit happened under
                   (``math.inf`` for serverful strategies: weights are
                   statically resident, nothing is ever cold).
      exec_time  — modeled layer execution time extending keep-alive.
      serverless — serverless lifecycle: instances idle out via
                   keep-alive. Serverful (False): a new plan REPLACES
                   the deployment — replicas absent from it release
                   their slot immediately (otherwise a periodic
                   rebalancer like EPLB would pin every historical
                   placement forever and exhaust the slot pool).
    """
    plan: object
    served: object
    lead_time: float = math.inf
    exec_time: float = 0.0
    serverless: bool = False


class IterationOutcome:
    """What one control-plane iteration produced: the modeled iteration
    latency (the serving-clock advance), the cost billed for this
    iteration, the per-MoE-layer warm-subset plans that route the next
    iteration, and the per-layer ``PlanEvent`` records an executing
    expert runtime applies as slot diffs."""

    __slots__ = ("latency_s", "cost", "plans", "events")

    def __init__(self, latency_s: float, cost: float, plans: list,
                 events: list | None = None):
        self.latency_s = latency_s
        self.cost = cost
        self.plans = plans
        self.events = events if events is not None else [
            PlanEvent(plan=p, served=p) for p in plans]

    def __repr__(self):
        return (f"IterationOutcome(latency_s={self.latency_s:.6f}, "
                f"cost={self.cost:.6g}, plans={len(self.plans)} layers)")


class ControlPlane:
    """THE control-plane protocol implementation: any
    ``repro_torch.core.balancer`` strategy driven from per-iteration expert
    loads, real or synthetic.

    step(t, gate_inputs, actual_loads, token_mask) -> IterationOutcome

    gate_inputs: (Lm, N, D) device array of this iteration's gate inputs
    (or None when no predictor consumes them); actual_loads: (Lm, E)
    per-layer routed loads (device or host array); token_mask excludes
    inactive continuous-batching slots from predicted histograms.
    """

    def __init__(self, cfg, strategy: str, *, num_devices: int = 8,
                 predictor=None, error_model=None,
                 prediction_distance: int = 1, cv_threshold: float = 0.2,
                 seed: int = 0, prewarm: bool = True, telemetry=None,
                 track: str = "control", straggler_factor: float = 2.0,
                 **bal_kw):
        assert cfg.is_moe, "control plane serves MoE models"
        if predictor is not None and error_model is not None:
            raise ValueError("pass a LoadPredictor or a PredictorErrorModel"
                             ", not both")
        self.cfg = cfg
        self.strategy = strategy
        self.num_devices = num_devices
        self.predictor = predictor
        self.error_model = error_model
        self.prediction_distance = prediction_distance
        self.n_layers = cfg.num_layers // cfg.moe.every_n_layers
        self.coeffs = derive_coeffs(cfg)
        self.bal = make_balancer(
            strategy, num_experts=cfg.moe.num_experts,
            num_devices=num_devices, expert_bytes=self.coeffs.expert_bytes,
            num_layers=self.n_layers,
            **({"cv_threshold": cv_threshold} if strategy == "moeless"
               else {}), **bal_kw)
        from repro_torch.obs.telemetry import NOOP
        # observation-only: never touches plans, latency, or cost.
        # `track` names this plane's trace lane; a layer whose max/mean
        # load exceeds `straggler_factor` is flagged (paper §4 straggler
        # identification) as a counter bump + instant trace event.
        self.telemetry = NOOP if telemetry is None else telemetry
        self.track = track
        self.straggler_factor = straggler_factor
        self.m_misc = CM.misc_memory_bytes(cfg)
        self.full_expert_bytes = (self.n_layers * cfg.moe.num_experts
                                  * self.coeffs.expert_bytes)
        self._rng = np.random.default_rng(seed)
        # meters
        self.layer_latency: list[float] = []
        self.iter_latency: list[float] = []
        self.replica_counts: list[int] = []
        self.cost = 0.0
        self.host_transfers = 0    # device->host syncs (<=1 per iteration)
        self.iterations = 0
        # phase meters: prefill and decode iterations drive the SAME
        # step with the same token_mask semantics (a (N,) per-token mask
        # over the gate inputs — padded prompt tail at prefill, inactive
        # KV slots at decode); counted separately so drop rates and
        # latencies can be attributed per phase
        self.phase_iterations: dict[str, int] = {}
        self.dropped_tokens = 0.0  # data-plane drops, cumulative
        self.phase_dropped: dict[str, float] = {}
        self.last_plans: list = []
        if prewarm and hasattr(self.bal, "prewarm"):
            self.bal.prewarm(np.full(cfg.moe.num_experts, 1.0))

    # ----------------------------------------------------------- loads

    def _loads(self, gate_inputs, actual_loads, token_mask, dropped=None):
        """(predicted, actual, dropped) as float64 host arrays (dropped
        may be None)."""
        if self.error_model is not None:
            acts = np.asarray(actual_loads, np.float64)
            pred = np.stack([
                self.error_model.predict(self._rng, acts[l], l,
                                         self.prediction_distance)
                for l in range(acts.shape[0])])
            drp = None if dropped is None \
                else np.asarray(dropped, np.float64)
            return np.maximum(pred, 0), acts, drp
        pred, acts, drp = _fetch_loads(self.predictor, self.cfg.moe.top_k,
                                       gate_inputs, actual_loads,
                                       token_mask, dropped)
        self.host_transfers += 1
        return pred, acts, drp

    # ------------------------------------------------------------ step

    def step(self, t: float, gate_inputs, actual_loads,
             token_mask=None, *, dropped=None,
             phase: str = "decode") -> IterationOutcome:
        """One serving iteration: plan + meter every MoE layer. Returns
        the iteration's outcome; cumulative meters stay on the instance
        (``layer_latency``, ``iter_latency``, ``cost``,
        ``host_transfers``). `phase` tags the iteration ('prefill' or
        'decode' — both drive this one entry point with identical
        token_mask semantics); `dropped` (Lm,) is the data plane's
        per-layer dropped-token count, fetched inside the iteration's
        single host sync and accumulated into ``dropped_tokens`` /
        ``phase_dropped``."""
        pred, acts, drp = self._loads(gate_inputs, actual_loads,
                                      token_mask, dropped)
        tel = self.telemetry
        self.phase_iterations[phase] = \
            self.phase_iterations.get(phase, 0) + 1
        if tel.enabled:
            tel.control_iterations.labels(phase=phase).inc()
        if drp is not None:
            d = float(np.sum(drp))
            self.dropped_tokens += d
            self.phase_dropped[phase] = \
                self.phase_dropped.get(phase, 0.0) + d
            if tel.enabled:
                tel.control_dropped.labels(phase=phase).inc(d)
        total = 0.0
        cost0 = self.cost
        serverless = bool(getattr(self.bal, "serverless", False))
        plans = []
        events = []
        for l in range(acts.shape[0]):
            t_fwd, plan = meter_layer(
                self.bal, t, l, pred[l], acts[l], coeffs=self.coeffs,
                num_devices=self.num_devices,
                prediction_distance=self.prediction_distance)
            self.layer_latency.append(t_fwd)
            self.replica_counts.append(plan.total_replicas)
            total += t_fwd
            self.cost += layer_iteration_cost(
                self.bal, plan, t_fwd, coeffs=self.coeffs,
                full_expert_bytes=self.full_expert_bytes,
                m_misc=self.m_misc)
            plans.append(plan)
            if serverless:
                # the balancer returned the warm-subset plan; the FULL
                # plan (incl. still-materialising replicas) is what the
                # runtime diffs its slot state against
                events.append(PlanEvent(
                    plan=self.bal.prev[l], served=plan,
                    lead_time=moeless_lead_time(
                        acts[l], coeffs=self.coeffs,
                        num_devices=self.num_devices,
                        prediction_distance=self.prediction_distance),
                    exec_time=MOELESS_EXEC_TIME, serverless=True))
            else:
                events.append(PlanEvent(plan=plan, served=plan))
            if tel.enabled:
                # the paper's Fig. 11/12 signals, per layer: predicted vs
                # actual load L1 error, and the max/mean imbalance factor
                # whose excess flags a straggler
                tel.control_layer_latency.observe(t_fwd)
                tel.control_l1_error.labels(layer=l).set(
                    float(np.abs(pred[l] - acts[l]).sum()))
                mx = float(acts[l].max()) if acts[l].size else 0.0
                mean = float(acts[l].mean()) if acts[l].size else 0.0
                imb = mx / mean if mean > 0 else 0.0
                tel.control_imbalance.labels(layer=l).set(imb)
                tel.control_load_max.labels(layer=l).set(mx)
                tel.control_load_mean.labels(layer=l).set(mean)
                if imb > self.straggler_factor:
                    tel.control_stragglers.inc()
                    tel.instant(self.track, "straggler", t,
                                args={"layer": l, "imbalance": imb})
        self.iter_latency.append(total)
        self.iterations += 1
        self.last_plans = plans
        return IterationOutcome(latency_s=total, cost=self.cost - cost0,
                                plans=plans, events=events)

    # --------------------------------------------------------- summary

    def mean_layer_ms(self) -> float:
        return 1e3 * float(np.mean(self.layer_latency)) \
            if self.layer_latency else 0.0

    def p99_layer_ms(self) -> float:
        return 1e3 * float(np.percentile(self.layer_latency, 99)) \
            if self.layer_latency else 0.0


class MoElessController(ControlPlane):
    """The paper's control plane bound to a real model: exactly
    ``ControlPlane(strategy='moeless')`` plus EP slot-table export for
    the EP slot data plane (``plan_tables``, ``distributed/ep.py``). The
    scale/place/meter loop lives ONLY in ``ControlPlane.step``."""

    def __init__(self, cfg, *, num_devices: int = 8,
                 cv_threshold: float = 0.2, prediction_distance: int = 1,
                 slots_per_device: int = 0, predictor=None,
                 telemetry=None, track: str = "control",
                 straggler_factor: float = 2.0):
        e = cfg.moe.num_experts
        self.slots_per_device = slots_per_device \
            or default_slots_per_device(e, num_devices)
        super().__init__(
            cfg, "moeless", num_devices=num_devices, predictor=predictor,
            prediction_distance=prediction_distance,
            cv_threshold=cv_threshold, telemetry=telemetry, track=track,
            straggler_factor=straggler_factor,
            max_replicas_per_device=self.slots_per_device)

    def pool(self, layer: int):
        return self.bal.pool(layer)

    @property
    def plans(self) -> list:
        """Per-layer FULL plans (all replicas, warm or cold) — what the
        slot tables export; ``last_plans`` holds the effective (warm-
        subset) plans the meter served with."""
        return [self.bal.prev[l] for l in range(len(self.bal.prev))]

    def plan_tables(self, layer: int, ep: int | None = None):
        """Slot tables for the EP slot data plane (``distributed/ep.py``).

        `ep` overrides the EP degree (default: the gcd factorisation of
        experts x devices). The plan's logical devices are projected onto
        the ep ranks with the block mapping (``distributed.ep.
        device_rank``), and each rank's slot count is the total logical
        slot budget split over ranks — the geometry
        ``serving.expert_runtime.ExpertRuntime`` executes. The tables are
        numpy and valid for any `ep`."""
        from repro_torch.distributed.ep import ep_factorisation, \
            plan_to_tables
        if ep is None:
            ep, _ = ep_factorisation(self.cfg.moe.num_experts,
                                     self.num_devices)
        per_rank = -(-self.num_devices * self.slots_per_device
                     // ep)
        return plan_to_tables(self.plans[layer], ep=ep,
                              slots_per_device=per_rank,
                              num_devices=self.num_devices)
