"""Multi-replica router + meter-driven autoscaler (Ray-Serve-style).

The ``Router`` load-balances gateway requests across N in-process
``ServingEngine`` replicas (each an ``EngineDriver``) with a
least-outstanding-tokens policy over healthy, non-draining replicas,
and autoscales the replica count between min/max bounds off the cost
model's meters — the serverless economics MoEless argues (and Remoe's
serverless MoE cost efficiency, arXiv 2512.18674) applied one level
up, at replica granularity:

  * SCALE UP on sustained queue delay: when the worst replica's oldest
    pending request has waited longer than ``queue_delay_up_s`` for
    ``sustain`` consecutive observations, a replica is added (cold
    capacity chases the latency SLO);
  * SCALE DOWN on idle GB-s burn: an idle replica keeps billing its
    resident bytes (misc memory + every expert replica's footprint,
    the cost model's byte base) — once a replica has burned
    ``idle_gb_s_down`` GB-s doing nothing, it is retired (pay-as-you-go
    beats keep-alive).

Every decision is recorded as a ``ScaleEvent``; the deterministic
benchmark lane replays a modeled-clock scenario through this exact
logic and commits the event counts to ``BENCH_serving.json``.

The router is thread-agnostic: with ``threaded=True`` each replica
runs its own background step loop (the HTTP path); with
``threaded=False`` the caller drives ``step_all`` manually
(deterministic tests/bench).
"""
from __future__ import annotations

import itertools
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.obs.telemetry import NOOP
from repro_torch.serving.gateway.driver import (Backpressure, EngineDriver,
                                                ReplicaMeters)
from repro_torch.serving.gateway.protocol import RequestError
from repro_torch.serving.scheduler import GenRequest

# a long-lived gateway keeps only the newest scale decisions in the
# /metrics.json payload; `events_total` stays the monotonic count
SCALE_EVENT_RING = 64


@dataclass(frozen=True)
class ScaleEvent:
    """One autoscaler decision."""
    t: float
    action: str                # "up" | "down"
    n_before: int
    n_after: int
    reason: str


@dataclass(frozen=True)
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 1
    queue_delay_up_s: float = 0.5      # sustained delay that adds a replica
    sustain: int = 3                   # consecutive hot observations
    idle_gb_s_down: float = 1.0        # idle burn that retires a replica
    cooldown_s: float = 1.0            # min gap between scale events

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}:{self.max_replicas}")


class Autoscaler:
    """Pure decision logic over replica meter snapshots — no threads,
    no engines, fully deterministic given the observation sequence."""

    def __init__(self, cfg: AutoscalerConfig, resident_gb: float):
        self.cfg = cfg
        self.resident_gb = resident_gb   # GB an idle replica keeps billing
        # bounded ring: the payload keeps the newest decisions; the
        # monotonic total survives the ring's evictions
        self.events: deque[ScaleEvent] = deque(maxlen=SCALE_EVENT_RING)
        self.events_total = 0
        self._hot_streak = 0
        self._last_event_t = -math.inf
        self._last_t: float | None = None
        self._idle_gb_s: dict[int, float] = {}

    def observe(self, now: float, meters: list[ReplicaMeters]
                ) -> tuple[int, int | None]:
        """One observation -> (desired_replica_count, replica_id to
        retire or None). Records the decision in ``events``."""
        cfg = self.cfg
        dt = max(0.0, now - self._last_t) if self._last_t is not None \
            else 0.0
        self._last_t = now
        live = [m for m in meters if m.healthy and not m.draining]
        n = len(live)
        # integrate idle residency burn per replica (GB-s); any work
        # resets the meter — only CONTIGUOUS idleness counts
        seen = set()
        for m in live:
            seen.add(m.replica_id)
            if m.idle:
                self._idle_gb_s[m.replica_id] = \
                    self._idle_gb_s.get(m.replica_id, 0.0) \
                    + dt * self.resident_gb
            else:
                self._idle_gb_s[m.replica_id] = 0.0
        for rid in list(self._idle_gb_s):
            if rid not in seen:
                del self._idle_gb_s[rid]
        max_delay = max((m.queue_delay_s for m in live), default=0.0)
        self._hot_streak = self._hot_streak + 1 \
            if max_delay > cfg.queue_delay_up_s else 0
        if now - self._last_event_t < cfg.cooldown_s:
            return n, None
        if self._hot_streak >= cfg.sustain and n < cfg.max_replicas:
            self.events.append(ScaleEvent(
                t=now, action="up", n_before=n, n_after=n + 1,
                reason=f"queue delay {max_delay:.3g}s > "
                       f"{cfg.queue_delay_up_s:.3g}s for "
                       f"{self._hot_streak} observations"))
            self.events_total += 1
            self._hot_streak = 0
            self._last_event_t = now
            return n + 1, None
        if n > cfg.min_replicas and self._hot_streak == 0:
            idle = [(self._idle_gb_s.get(m.replica_id, 0.0), m.replica_id)
                    for m in live if m.idle]
            idle = [(burn, rid) for burn, rid in idle
                    if burn >= cfg.idle_gb_s_down]
            if idle:
                burn, rid = max(idle)
                self.events.append(ScaleEvent(
                    t=now, action="down", n_before=n, n_after=n - 1,
                    reason=f"replica {rid} idle-burned {burn:.3g} GB-s "
                           f">= {cfg.idle_gb_s_down:.3g} GB-s"))
                self.events_total += 1
                self._last_event_t = now
                del self._idle_gb_s[rid]
                return n - 1, rid
        return n, None


@dataclass
class RouterCounters:
    admitted: int = 0
    rejected: int = 0          # backpressure (HTTP 429)
    cancelled: int = 0
    scale_ups: int = 0
    scale_downs: int = 0
    max_replicas_seen: int = field(default=0)


class Router:
    """Least-outstanding-tokens load balancer over N engine replicas
    with per-replica health and meter-driven autoscaling."""

    def __init__(self, factory: Callable[[int], EngineDriver], *,
                 scaler: AutoscalerConfig | None = None,
                 threaded: bool = True, telemetry=None):
        """`factory(replica_id)` builds one started session's driver
        (it must pass `replica_id` through to the ``EngineDriver``)."""
        self.factory = factory
        self.threaded = threaded
        self.telemetry = NOOP if telemetry is None else telemetry
        self.scaler_cfg = scaler or AutoscalerConfig()
        self.replicas: dict[int, EngineDriver] = {}
        self.counters = RouterCounters()
        self._rids = itertools.count()
        self._next_replica = 0
        # work finished on replicas retired since startup — keeps the
        # completed/cancelled totals monotonic across scale-downs
        self._retired_completed = 0
        self._retired_cancelled = 0
        for _ in range(self.scaler_cfg.min_replicas):
            self._spawn()
        first = next(iter(self.replicas.values()))
        self.scaler = Autoscaler(self.scaler_cfg, first.resident_gb)

    # ------------------------------------------------------- replicas

    def _spawn(self) -> EngineDriver:
        d = self.factory(self._next_replica)
        if d.replica_id != self._next_replica:
            raise ValueError("factory must pass replica_id through to "
                             "the EngineDriver")
        self._next_replica += 1
        self.replicas[d.replica_id] = d
        if self.threaded:
            d.start()
        self.counters.max_replicas_seen = max(
            self.counters.max_replicas_seen, len(self.live_replicas()))
        return d

    def _retire(self, rid: int) -> None:
        """Retire a (scale-down, hence idle) replica and release its
        session EAGERLY — the whole point of scaling down is to stop the
        resident-GB-s burn now, not at a future gc pass. ``join=False``
        keeps the asyncio autoscale loop from blocking on the step
        thread: the thread closes the session itself as it exits (and
        with no thread — unthreaded bench/tests — the close is
        synchronous)."""
        d = self.replicas.pop(rid, None)
        if d is not None:
            m = d.meters()
            self._retired_completed += m.completed
            self._retired_cancelled += m.cancelled
            d.draining = True
            d.stop(join=False, close=True)

    def live_replicas(self) -> list[EngineDriver]:
        return [d for d in self.replicas.values()
                if d.healthy and not d.draining]

    def mark_unhealthy(self, rid: int) -> None:
        """Operator/health-check hook: fail the replica now (its waiting
        clients get terminal events; new requests fail over)."""
        d = self.replicas.get(rid)
        if d is not None:
            d.fail()

    # -------------------------------------------------------- routing

    def next_rid(self) -> int:
        return next(self._rids)

    def route(self) -> EngineDriver:
        """Healthy replica with the least outstanding token budget
        (ties to the lowest replica id); 503 when none is healthy."""
        live = self.live_replicas()
        if not live:
            raise RequestError(503, "no healthy replicas",
                               etype="server_error")
        return min(live,
                   key=lambda d: (d.outstanding_tokens, d.replica_id))

    def submit(self, req: GenRequest, *, sink=None
               ) -> tuple[EngineDriver, "object"]:
        """Route + submit; optionally installs `sink` for the request's
        token events. Raises ``Backpressure`` (counted) when the chosen
        replica's pending queue is full.

        The sink is installed BEFORE the submit: ``driver.submit`` wakes
        the background step thread, which can emit the first tokens —
        for a short request, the whole completion — before control
        returns here, and events with no sink are dropped. The rid is
        fresh (``next_rid``), so no stray events can reach the sink
        before the submit lands; on backpressure/reject it is simply
        uninstalled."""
        driver = self.route()
        if sink is not None:
            driver.subscribe(req.rid, sink)
        try:
            handle = driver.submit(req)
        except Backpressure:
            if sink is not None:
                driver.unsubscribe(req.rid)
            self.counters.rejected += 1
            if self.telemetry.enabled:
                self.telemetry.router_requests.labels(
                    outcome="backpressure").inc()
            raise
        if handle.status == "rejected":
            if sink is not None:
                driver.unsubscribe(req.rid)
            if self.telemetry.enabled:
                self.telemetry.router_requests.labels(
                    outcome="rejected").inc()
            return driver, handle
        self.counters.admitted += 1
        if self.telemetry.enabled:
            self.telemetry.router_requests.labels(outcome="admitted").inc()
        return driver, handle

    def cancel(self, driver: EngineDriver, handle) -> bool:
        ok = driver.cancel(handle)
        if ok:
            self.counters.cancelled += 1
            if self.telemetry.enabled:
                self.telemetry.router_requests.labels(
                    outcome="cancelled").inc()
        return ok

    # ---------------------------------------------------- autoscaling

    def clock(self) -> float:
        """Router time = max replica session clock (modeled when the
        control plane is attached, wall otherwise) — deterministic under
        the modeled clock."""
        return max((d.meters().clock_s for d in self.replicas.values()),
                   default=0.0)

    def autoscale(self, now: float) -> list[ScaleEvent]:
        """One autoscaler observation; applies the decision (spawn or
        retire an idle replica). Returns the new events."""
        total0 = self.scaler.events_total
        meters = [d.meters() for d in self.replicas.values()]
        desired, retire_rid = self.scaler.observe(now, meters)
        n = len(self.live_replicas())
        if desired > n:
            self._spawn()
            self.counters.scale_ups += 1
        elif retire_rid is not None:
            self._retire(retire_rid)
            self.counters.scale_downs += 1
        # observe() appends at most one event per call, so the newest
        # ring entry IS the new event whenever the total advanced
        new = [self.scaler.events[-1]] \
            if self.scaler.events_total > total0 else []
        tel = self.telemetry
        if tel.enabled:
            for e in new:
                tel.router_scale_events.labels(action=e.action).inc()
                tel.instant("router", f"ScaleEvent:{e.action}", e.t,
                            args={"n_before": e.n_before,
                                  "n_after": e.n_after,
                                  "reason": e.reason})
            tel.router_replicas.set(len(self.live_replicas()))
        return new

    # ----------------------------------------------- sync drive (bench)

    def step_all(self) -> int:
        """Unthreaded mode: one step on every replica with work.
        Returns the number of token events generated."""
        n = 0
        for d in list(self.replicas.values()):
            if d.healthy and d.engine.has_work:
                n += len(d.step_once())
        return n

    def drain(self, *, autoscale_dt: float = 0.0, max_steps: int = 10_000
              ) -> None:
        """Unthreaded mode: step until every replica is idle, observing
        the autoscaler each round (at the router clock, plus
        `autoscale_dt` per round so cooldowns advance even when the
        modeled clock stalls)."""
        extra = 0.0
        for _ in range(max_steps):
            if not any(d.engine.has_work for d in self.replicas.values()
                       if d.healthy):
                return
            self.step_all()
            extra += autoscale_dt
            self.autoscale(self.clock() + extra)
        raise RuntimeError("drain did not converge")

    # ---------------------------------------------------------- status

    def stop(self) -> None:
        for d in self.replicas.values():
            d.stop(join=self.threaded, close=True)

    def refresh_telemetry(self) -> None:
        """Snapshot per-replica meters into the registry's gauges —
        called at scrape time (``GET /metrics``) so gauge values are
        current without a per-step polling loop."""
        tel = self.telemetry
        if not tel.enabled:
            return
        tel.router_replicas.set(len(self.live_replicas()))
        for d in sorted(self.replicas.values(), key=lambda d: d.replica_id):
            m = d.meters()
            rid = str(m.replica_id)
            tel.replica_pending.labels(replica=rid).set(m.pending)
            tel.replica_running.labels(replica=rid).set(m.running)
            tel.replica_outstanding.labels(replica=rid).set(
                m.outstanding_tokens)
            tel.replica_queue_delay.labels(replica=rid).set(
                m.queue_delay_s)
            tel.replica_gb_seconds.labels(replica=rid).set(m.gb_s)
            tel.replica_healthy.labels(replica=rid).set(
                1 if m.healthy and not m.draining else 0)

    def metrics(self) -> dict:
        """The `/metrics.json` payload: per-replica meters + router
        counters + the newest autoscale events (bounded ring; the
        monotonic total rides along as ``scale_events_total``)."""
        reps = []
        completed = self._retired_completed
        cancelled = self._retired_cancelled
        for d in sorted(self.replicas.values(),
                        key=lambda d: d.replica_id):
            m = d.meters()
            completed += m.completed
            cancelled += m.cancelled
            reps.append({
                "id": m.replica_id, "healthy": m.healthy,
                "draining": m.draining, "pending": m.pending,
                "running": m.running, "free_slots": m.free_slots,
                "outstanding_tokens": m.outstanding_tokens,
                "queue_delay_s": m.queue_delay_s,
                "completed": m.completed, "cancelled": m.cancelled,
                "clock_s": m.clock_s, "gb_s": m.gb_s, "idle": m.idle,
            })
        c = self.counters
        return {
            "replicas": reps,
            "router": {
                "num_replicas": len(self.replicas),
                "admitted": c.admitted, "rejected": c.rejected,
                "cancelled": cancelled, "completed": completed,
                "scale_ups": c.scale_ups, "scale_downs": c.scale_downs,
                "max_replicas_seen": c.max_replicas_seen,
                "scale_events_total": self.scaler.events_total,
                "scale_events": [
                    {"t": e.t, "action": e.action, "n_before": e.n_before,
                     "n_after": e.n_after, "reason": e.reason}
                    for e in self.scaler.events],
            },
        }
