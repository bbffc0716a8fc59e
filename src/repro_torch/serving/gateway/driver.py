"""Async engine driver: one serving replica behind the gateway.

``EngineDriver`` wraps one synchronous ``ServingEngine`` session and
decouples request submission from token generation ("Toward
Cost-Efficient Serving of MoE with Asynchrony", arXiv 2505.08944):

  * the step loop runs in a BACKGROUND THREAD (``start``), woken by
    submissions and parked when the session drains — the asyncio
    front-end never blocks on a decode iteration;
  * every ``TokenEvent`` the engine emits is fanned out to the
    submitting client's sink (an ``loop.call_soon_threadsafe`` push
    onto a per-request asyncio queue, installed via ``subscribe``) from
    the engine's step hook, still under the engine lock — no event is
    ever dropped or reordered;
  * admission control/backpressure: a bounded pending queue — when
    ``max_pending`` requests are already waiting, ``submit`` raises
    ``Backpressure`` (the HTTP layer maps it to 429 + Retry-After)
    instead of letting the backlog grow without bound;
  * client disconnects call ``cancel`` which recycles the KV slot
    mid-decode and pushes a final cancelled event to the sink.

``meters()`` snapshots the replica signals the router's autoscaler
consumes: pending depth, queue delay (age of the oldest waiting
request on the session clock), outstanding token budget, GB-s of
residency (the cost model's byte base — actual runtime meters when the
expert runtime is attached), and idleness.

The driver also works UNTHREADED (never call ``start``): the bench and
tests drive ``step_once`` manually for deterministic, wall-clock-free
scenarios under the modeled serving clock.
"""
from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass
from typing import Callable

from repro_torch.serving.engine import RequestHandle, ServingEngine, TokenEvent
from repro_torch.serving.scheduler import GenRequest

# sentinel tokens pushed to a sink on abnormal termination — sinks
# treat done=True with token < 0 as "no token". CANCEL_TOKEN means the
# client cancelled (disconnect); FAIL_TOKEN means the REPLICA died, so
# the HTTP layer must surface an error (5xx / finish_reason
# "replica_failed"), never a fake success
CANCEL_TOKEN = -1
FAIL_TOKEN = -2


class Backpressure(Exception):
    """Pending queue full — retry after `retry_after` seconds."""

    def __init__(self, pending: int, limit: int, retry_after: float):
        self.pending = pending
        self.limit = limit
        self.retry_after = retry_after
        super().__init__(
            f"pending queue full ({pending}/{limit}); "
            f"retry after {retry_after:.3g}s")


@dataclass(frozen=True)
class ReplicaMeters:
    """One autoscaler observation of one replica."""
    replica_id: int
    healthy: bool
    draining: bool
    pending: int
    running: int
    free_slots: int
    outstanding_tokens: int
    queue_delay_s: float
    completed: int
    cancelled: int
    clock_s: float
    gb_s: float                 # metered GB-s of residency so far
    idle: bool                  # no pending and no running work


class EngineDriver:
    """One gateway replica: a ``ServingEngine`` session + background
    step thread + per-request event fan-out + admission control."""

    def __init__(self, engine: ServingEngine, *, replica_id: int = 0,
                 num_slots: int = 8, max_pending: int = 64,
                 control=None, eos_id=None, time_scale: float = 1.0):
        self.engine = engine
        self.replica_id = replica_id
        self.max_pending = max_pending
        self.healthy = True
        self.draining = False          # no new routes; finish in-flight
        self._sinks: dict[int, Callable[[TokenEvent], None]] = {}
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._stop = False
        self._closed = False
        self._close_on_exit = False
        engine.start(num_slots=num_slots, control=control, eos_id=eos_id,
                     time_scale=time_scale)
        engine.add_step_hook(self._on_events)
        # resident GB for the autoscaler's idle-burn model: the cost
        # model's byte base (misc memory + every expert replica's
        # footprint at the configured slot_dtype) — what an idle replica
        # keeps billing per second, serverless-style
        from repro_torch.core import costmodel as CM
        cfg = engine.cfg
        resident = CM.misc_memory_bytes(cfg)
        if cfg.is_moe:
            coeffs = CM.derive_coeffs(cfg)
            n_moe = cfg.num_layers // cfg.moe.every_n_layers
            resident += n_moe * cfg.moe.num_experts * coeffs.expert_bytes
        self.resident_gb = float(resident) / 1e9

    # ------------------------------------------------------- submission

    def _retry_after(self) -> float:
        sess = self.engine._session
        return round(max(0.1, sess.sched.queue_delay(sess.now)), 3)

    def submit(self, req: GenRequest) -> RequestHandle:
        """Thread-safe submit with backpressure: raises ``Backpressure``
        when the bounded pending queue is full; the returned handle is
        `rejected` when the request can never fit a KV slot."""
        eng = self.engine
        with eng._lock:
            sched = eng._sess.sched
            if sched.num_pending >= self.max_pending:
                raise Backpressure(sched.num_pending, self.max_pending,
                                   self._retry_after())
            handle = eng.submit(req)
        with self._cv:
            self._cv.notify()
        return handle

    def subscribe(self, rid: int,
                  sink: Callable[[TokenEvent], None]) -> None:
        """Install `sink` for `rid`'s token events (called from the step
        thread, under the engine lock — keep it non-blocking; the HTTP
        layer passes a ``call_soon_threadsafe`` queue push)."""
        with self.engine._lock:
            self._sinks[rid] = sink

    def unsubscribe(self, rid: int) -> None:
        """Drop `rid`'s sink (a submission that never made it in —
        backpressure or admission reject)."""
        with self.engine._lock:
            self._sinks.pop(rid, None)

    def _on_events(self, events: list[TokenEvent]) -> None:
        for ev in events:
            sink = self._sinks.get(ev.rid)
            if sink is not None:
                sink(ev)
                if ev.done:
                    self._sinks.pop(ev.rid, None)

    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel a queued or mid-decode request (client disconnect):
        the KV slot is recycled for the next arrival and the sink gets a
        final cancelled event. False if it already finished."""
        with self.engine._lock:
            ok = self.engine.cancel(handle)
            sink = self._sinks.pop(handle.rid, None) if ok else None
        if sink is not None:
            sink(TokenEvent(handle.rid, CANCEL_TOKEN, True))
        return ok

    # -------------------------------------------------------- stepping

    def step_once(self) -> list[TokenEvent]:
        """One engine iteration (events also reach the sinks via the
        step hook). Marks the replica unhealthy on an engine fault."""
        try:
            return self.engine.step()
        except Exception:
            self.fail(traceback.format_exc())
            raise

    def fail(self, why: str = "") -> None:
        """Mark the replica unhealthy, cancel its in-flight work (KV
        slots freed, handles carry finish_reason "replica_failed"), and
        deliver terminal FAIL_TOKEN events to every waiting sink — no
        client hangs on, or reads a fake success from, a dead replica."""
        self.healthy = False
        with self.engine._lock:
            sess = self.engine._session
            if sess is not None:
                sched = sess.sched
                doomed = list(sched.pending) + list(sched.running.values())
                for req in doomed:
                    sched.cancel(req, sess.now, reason="replica_failed")
            sinks = list(self._sinks.items())
            self._sinks.clear()
        for rid, sink in sinks:
            sink(TokenEvent(rid, FAIL_TOKEN, True))
        if why:
            print(f"[gateway] replica {self.replica_id} failed:\n{why}")

    def _run(self) -> None:
        try:
            while True:
                with self._cv:
                    while not self._stop and not self.engine.has_work:
                        self._cv.wait(timeout=0.05)
                    if self._stop:
                        return
                try:
                    self.engine.step()
                except Exception:
                    self.fail(traceback.format_exc())
                    return
        finally:
            # retire path (stop(join=False, close=True)): the step
            # thread releases the session itself as it exits, so an
            # asyncio caller never blocks on the join
            if self._close_on_exit:
                self.close()

    def start(self) -> None:
        """Start the background step-loop thread."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name=f"engine-driver-{self.replica_id}",
            daemon=True)
        self._thread.start()

    def stop(self, join: bool = True, *, close: bool = False) -> None:
        """Stop the step loop. ``close=True`` releases the engine
        session eagerly (see ``close``): synchronously when there is no
        live thread or after a successful join, otherwise by the step
        thread itself as it exits — so a ``join=False`` caller (the
        asyncio autoscale path) never blocks."""
        with self._cv:
            self._stop = True
            if close:
                self._close_on_exit = True
            self._cv.notify_all()
        t = self._thread
        if t is not None and join:
            t.join(timeout=5.0)
        if close and (t is None or not t.is_alive()):
            self.close()

    def close(self) -> None:
        """Release the engine session now (KV cache, slot banks,
        control plane) and detach the step hook — breaking the
        engine<->driver reference cycle so a retired replica stops
        billing immediately instead of at some future gc pass.
        Idempotent."""
        with self.engine._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self.engine.remove_step_hook(self._on_events)
        except ValueError:
            pass
        self.engine.close()

    # ---------------------------------------------------------- meters

    def meters(self) -> ReplicaMeters:
        """Snapshot the autoscaler/router signals (thread-safe)."""
        eng = self.engine
        with eng._lock:
            sess = eng._session
            if sess is None:           # closed/retired: nothing resident
                return ReplicaMeters(
                    replica_id=self.replica_id, healthy=self.healthy,
                    draining=self.draining, pending=0, running=0,
                    free_slots=0, outstanding_tokens=0, queue_delay_s=0.0,
                    completed=0, cancelled=0, clock_s=0.0, gb_s=0.0,
                    idle=True)
            sched = sess.sched
            gb_s = 0.0
            if sess.runtime is not None:
                gb_s = float(sess.runtime.stats.instance_seconds_gb)
            elif sess.control is not None:
                # no executing runtime: the control plane's cumulative
                # modeled residency cost is the best metered proxy
                gb_s = float(sess.control.cost)
            pending = sched.num_pending
            running = len(sched.running)
            return ReplicaMeters(
                replica_id=self.replica_id, healthy=self.healthy,
                draining=self.draining, pending=pending, running=running,
                free_slots=sess.kv.num_free,
                outstanding_tokens=sched.outstanding_tokens(),
                queue_delay_s=sched.queue_delay(sess.now),
                completed=len(sched.finished),
                cancelled=len(sched.cancelled),
                clock_s=sess.now, gb_s=gb_s,
                idle=pending == 0 and running == 0)

    @property
    def outstanding_tokens(self) -> int:
        eng = self.engine
        with eng._lock:
            sess = eng._session
            return 0 if sess is None else sess.sched.outstanding_tokens()
