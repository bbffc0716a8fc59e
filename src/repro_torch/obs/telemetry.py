"""The ``Telemetry`` handle — ONE object threaded through the serving
stack (engine, scheduler accounting, expert runtime, control plane,
gateway router/driver/server, launchers) that carries

  * a ``MetricsRegistry`` holding the whole metric taxonomy (declared
    HERE, in one place, so names never drift between subsystems), and
  * optionally a ``Tracer`` collecting Chrome trace-event spans /
    instants (``tracing`` is True only when a tracer is attached).

Default is the ``NOOP`` singleton: ``enabled`` is False and every
metric/trace call is swallowed, so un-instrumented runs (tier-1 tests,
committed BENCH baselines) pay one attribute load + branch per
instrumentation site and nothing else. Instrument sites guard with
``if tel.enabled:`` before computing label values.

Metric naming follows Prometheus conventions —
``<subsystem>_<name>_<unit>[_total]`` with the subsystem one of
``scheduler`` / ``engine`` / ``runtime`` / ``control`` / ``router``
(+ per-replica ``replica_*`` gauges). The README's Observability
section tables the full taxonomy.
"""
from __future__ import annotations

from repro_torch.obs.registry import TIME_BUCKETS, MetricsRegistry
from repro_torch.obs.tracing import Tracer

# byte-ish histograms use wider buckets than latencies
BYTE_BUCKETS = (1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9)


class Telemetry:
    """Live telemetry: a registry (always) + a tracer (optional)."""

    enabled = True

    def __init__(self, registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None):
        self.registry = MetricsRegistry() if registry is None else registry
        self.tracer = tracer
        r = self.registry
        # ---------------------------------------------------- scheduler
        self.sched_admitted = r.counter(
            "scheduler_admitted_total",
            "requests admitted into the running batch")
        self.sched_rejected = r.counter(
            "scheduler_rejected_total",
            "requests rejected at admission control", labels=("reason",))
        self.sched_finished = r.counter(
            "scheduler_finished_total",
            "requests finished, by finish reason", labels=("reason",))
        self.sched_cancelled = r.counter(
            "scheduler_cancelled_total",
            "requests cancelled (client disconnect / replica failure)")
        self.sched_pending = r.gauge(
            "scheduler_pending", "requests waiting for a KV slot")
        self.sched_queue_delay = r.histogram(
            "scheduler_queue_delay_seconds",
            "arrival -> admission delay on the serving clock")
        # ------------------------------------------------------- engine
        self.engine_steps = r.counter(
            "engine_steps_total", "engine iterations, by phase",
            labels=("phase",))
        self.engine_tokens = r.counter(
            "engine_tokens_total", "tokens generated")
        self.engine_step_seconds = r.histogram(
            "engine_step_seconds",
            "wall time of one engine iteration, by phase",
            labels=("phase",))
        self.engine_host_sync = r.histogram(
            "engine_host_sync_seconds",
            "wall time blocked on the device->host token fetch")
        self.engine_occupancy = r.gauge(
            "engine_batch_occupancy",
            "active slots in the batched decode step")
        # ----------------------------------------------------- paged KV
        self.kv_blocks_used = r.gauge(
            "kv_blocks_used", "paged-KV pool blocks currently referenced")
        self.kv_blocks_free = r.gauge(
            "kv_blocks_free", "paged-KV pool blocks on the free list")
        self.kv_prefix_hits = r.counter(
            "kv_prefix_hits_total",
            "admissions that matched a cached prompt prefix")
        self.kv_prefix_tokens_saved = r.counter(
            "kv_prefix_tokens_saved_total",
            "prompt tokens served from the prefix cache (prefill FLOPs "
            "and KV writes skipped)")
        self.kv_cow_copies = r.counter(
            "kv_cow_copies_total",
            "shared blocks copied on first divergent write")
        # ----------------------------------------- expert runtime
        self.runtime_starts = r.counter(
            "runtime_replica_starts_total",
            "expert replica starts, by lifecycle kind "
            "(cold / warm / prewarmed)", labels=("kind",))
        self.runtime_transfers = r.counter(
            "runtime_transfers_total", "slot weight copies performed")
        self.runtime_bytes = r.counter(
            "runtime_bytes_moved_total",
            "bytes written into expert slot banks")
        self.runtime_rank_bytes = r.counter(
            "runtime_rank_bytes_total",
            "slot-bank bytes written per EP mesh rank", labels=("rank",))
        self.runtime_evictions = r.counter(
            "runtime_evictions_total", "keep-alive / plan evictions")
        self.runtime_overlap_copies = r.counter(
            "runtime_overlap_copies_total",
            "slot copies by overlap class (eligible hide under compute; "
            "exposed block the next dispatch)", labels=("kind",))
        self.runtime_overlap_hidden = r.counter(
            "runtime_overlap_hidden_seconds_total",
            "modeled copy seconds hidden under compute")
        self.runtime_resident = r.gauge(
            "runtime_resident_replicas",
            "expert replicas currently resident in slot banks")
        self.runtime_flush_seconds = r.histogram(
            "runtime_bank_flush_seconds",
            "wall time to dispatch one slot-bank flush (double-buffered "
            "scatter)")
        # ------------------------------------------------------ control
        self.control_iterations = r.counter(
            "control_iterations_total",
            "control-plane iterations, by phase", labels=("phase",))
        self.control_dropped = r.counter(
            "control_dropped_tokens_total",
            "MoE capacity-dropped tokens, by phase", labels=("phase",))
        self.control_stragglers = r.counter(
            "control_stragglers_total",
            "layer iterations whose load imbalance flagged a straggler")
        self.control_l1_error = r.gauge(
            "control_pred_load_l1_error",
            "L1 error of predicted vs actual expert load, per layer "
            "(paper Fig. 11/12)", labels=("layer",))
        self.control_imbalance = r.gauge(
            "control_imbalance_factor",
            "max/mean expert load of the last iteration, per layer",
            labels=("layer",))
        self.control_load_max = r.gauge(
            "control_load_max",
            "max expert load of the last iteration, per layer",
            labels=("layer",))
        self.control_load_mean = r.gauge(
            "control_load_mean",
            "mean expert load of the last iteration, per layer",
            labels=("layer",))
        self.control_layer_latency = r.histogram(
            "control_layer_latency_seconds",
            "modeled per-layer MoE forward latency")
        # ------------------------------------------------------- router
        self.router_requests = r.counter(
            "router_requests_total",
            "gateway requests, by outcome", labels=("outcome",))
        self.router_scale_events = r.counter(
            "router_scale_events_total",
            "autoscaler decisions, by action", labels=("action",))
        self.router_replicas = r.gauge(
            "router_replicas", "live engine replicas behind the router")
        self.router_http_seconds = r.histogram(
            "router_http_request_seconds",
            "gateway HTTP request handling wall time, by route",
            labels=("route",))
        self.replica_pending = r.gauge(
            "replica_pending", "pending requests", labels=("replica",))
        self.replica_running = r.gauge(
            "replica_running", "running requests", labels=("replica",))
        self.replica_outstanding = r.gauge(
            "replica_outstanding_tokens",
            "token budget still owed", labels=("replica",))
        self.replica_queue_delay = r.gauge(
            "replica_queue_delay_seconds",
            "age of the oldest pending request", labels=("replica",))
        self.replica_gb_seconds = r.gauge(
            "replica_gb_seconds", "metered GB-s of residency",
            labels=("replica",))
        self.replica_healthy = r.gauge(
            "replica_healthy", "1 while the replica serves",
            labels=("replica",))

    # ------------------------------------------------------- tracing

    @property
    def tracing(self) -> bool:
        return self.tracer is not None

    def span(self, track: str, name: str, t0: float, t1: float,
             args: dict | None = None) -> None:
        if self.tracer is not None:
            self.tracer.span(track, name, t0, t1, args)

    def instant(self, track: str, name: str, t: float,
                args: dict | None = None) -> None:
        if self.tracer is not None:
            self.tracer.instant(track, name, t, args)


class _NoopMetric:
    """Swallows every metric call (defensive: instrument sites guard on
    ``tel.enabled`` and should never reach these)."""

    def labels(self, **kv):
        return self

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


_NOOP_METRIC = _NoopMetric()


class NullTelemetry:
    """The disabled default: no registry, no tracer, no overhead."""

    enabled = False
    tracing = False
    registry = None
    tracer = None

    def __getattr__(self, name):
        return _NOOP_METRIC

    def span(self, track, name, t0, t1, args=None) -> None:
        pass

    def instant(self, track, name, t, args=None) -> None:
        pass


NOOP = NullTelemetry()
