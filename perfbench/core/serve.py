"""The system under test and the loop that drives it.

``build`` makes the port's ``ServingEngine`` for a cell as a deployment
would run it; ``Session`` drives it through ``submit`` and ``step``, and
times every request on the host clock, from the moment it was due to
each token event ``step`` hands back. The engine's own serving clock,
records and summaries are never read for a metric.

The harness wraps the controller it builds (``Probe``) to keep what the
engine hands it each call: the phase, the routed loads of every MoE
layer, the dropped assignments, and the replica plans the call returns
(which the expert runtime turns into the next call's slot tables).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench.core import traffic as TR


def span(name: str, on: bool):
    """A host span the profiler records (``pb:<name>``) in traced runs."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"pb:{name}")


@dataclass
class Call:
    """One call of the controller: the routed loads (Lm, E), the dropped
    assignments (Lm,) or None, the replicas of the slot tables the
    engine's model call ran on (None: no runtime; ``replica_slots``),
    and, on the device, the experts each MoE layer sent each token to
    (Lm, N, k) and the token mask the engine passed."""
    loads: np.ndarray
    dropped: np.ndarray | None
    slots: np.ndarray | None
    phase: str = ""
    routes: object = None
    mask: object = None


class Probe:
    """Records every call of the controller object `ctrl`. From the gate
    inputs the engine hands it (each MoE layer's normed input, every
    token of the call) it recomputes each token's top-k experts with the
    router product the program uses (`ep`: the EP slot plane's matmul,
    else the GShard dispatch's einsum), so the reference can follow the
    program's routing; the loads those routes give are checked against
    the ones the engine handed over.

    This is a copy of the program's router arithmetic (the product in
    bfloat16, its order of accumulation, ties to the lower expert) and,
    in ``replica_slots``, of the runtime's slot keying: it is pinned to
    them, and a change to either in the program needs the same change
    here. Its work runs inside the window, under the span ``probe``; the
    trace reader leaves the kernels it launches out of the program's."""

    def __init__(self, ctrl, traced: bool, router, top_k: int, ep: bool,
                 slots0=None):
        self.calls: list[Call] = []
        self.slots = slots0        # the replicas in force
        self._host = None
        self.router, self.k, self.ep = router, top_k, ep
        loads, step = ctrl._loads, ctrl.step

        def _loads(gate_inputs, actual_loads, token_mask, *a, **k):
            pred, acts, drp = loads(gate_inputs, actual_loads, token_mask,
                                    *a, **k)
            with span("probe", traced):
                routes = self.routes(gate_inputs)
            self._host = (np.array(acts), None if drp is None
                          else np.array(drp), routes, token_mask)
            return pred, acts, drp

        def _step(*a, **k):
            with span("control.step", traced):
                out = step(*a, **k)
            acts, drp, routes, mask = self._host
            self.calls.append(Call(acts, drp, self.slots,
                                   k.get("phase", ""), routes, mask))
            if self.slots is not None:
                self.slots = replica_slots([ev.served for ev in out.events],
                                           ctrl.num_devices)
            return out
        ctrl._loads, ctrl.step = _loads, _step

    def routes(self, gi):
        """(Lm, N, k) int8 top-k experts of gate inputs gi (Lm, N, D),
        ties to the lower index, on the device, with no host sync."""
        out = []
        for li in range(gi.shape[0]):
            h, w = gi[li], self.router[li]
            if self.ep:
                lg = h @ w
            else:
                n = h.shape[0]
                g = dispatch_groups(n)
                lg = torch.einsum("gtd,de->gte", h.reshape(g, n // g, -1),
                                  w).reshape(n, -1)
            out.append(torch.sort(lg.float(), dim=-1, descending=True,
                                  stable=True)[1][:, :self.k])
        return torch.stack(out).to(torch.int8)

    def take(self) -> list[Call]:
        out, self.calls = self.calls, []
        return out


def dispatch_groups(n: int) -> int:
    """The GShard dispatch's groups for n tokens of one sequence batch:
    groups of at most 2048 tokens, fewer where they do not divide."""
    g = max(1, min(n // 2048, n))
    while n % g:
        g -= 1
    return g


def replica_slots(plans, num_devices: int) -> np.ndarray:
    """(Lm, E, R) the slot of each replica of each expert in the tables
    built from `plans` (the served warm subsets), -1 past an expert's
    replicas. A slot is keyed by its (expert, device) instance: two
    replicas an expert places on one device share one slot."""
    r = max(1, max(len(pl) for p in plans for pl in p.placement))
    out = -np.ones((len(plans), plans[0].num_experts, r), np.int64)
    for li, p in enumerate(plans):
        for e, pl in enumerate(p.placement):
            out[li, e, :len(pl)] = [e * num_devices + g for g in pl]
    return out


@dataclass
class System:
    cfg: object
    engine: object
    control: object
    probe: Probe
    telemetry: object
    runtime: bool


def build(cfg, params, cell: dict, config: dict, traced: bool) -> System:
    """The port serving `cfg` with `params` as the configuration file's
    ``port`` settings say: the MoEless controller with the gate-replica
    predictor at distance 1, either on the engine (the expert runtime
    off) or as the session's control plane whose plans the expert
    runtime executes (on)."""
    from repro_torch.core.control import ControlPlane, MoElessController
    from repro_torch.core.predictor import from_gates
    from repro_torch.obs.telemetry import Telemetry
    from repro_torch.serving.engine import ServingEngine
    port = config["port"]
    tel = Telemetry() if traced else None
    pred = from_gates(cfg, params, port.get("prediction_distance", 1))
    runtime = port.get("expert_runtime", "off") == "on"
    if runtime:
        ctrl = ControlPlane(cfg, "moeless", predictor=pred,
                            prediction_distance=port.get(
                                "prediction_distance", 1),
                            num_devices=port["num_devices"],
                            max_replicas_per_device=port[
                                "max_replicas_per_device"],
                            telemetry=tel)
    else:
        ctrl = MoElessController(cfg, num_devices=port["num_devices"],
                                 predictor=pred, telemetry=tel)
    engine = ServingEngine(cfg, params, max_len=cell["max_len"],
                           controller=None if runtime else ctrl,
                           expert_runtime="on" if runtime else "off",
                           runtime_double_buffer=port.get(
                               "runtime_double_buffer", True),
                           telemetry=tel)
    engine.start(num_slots=cell["slots"], control=ctrl if runtime else None,
                 time_scale=port.get("time_scale", 1.0))
    prev = ctrl.bal.prev        # the deployment the runtime bootstrapped
    slots0 = replica_slots([prev[li] for li in range(len(prev))],
                           ctrl.num_devices) if runtime else None
    probe = Probe(ctrl, traced, params["layers"][0]["moe"]["router"]["w_gate"],
                  cfg.moe.top_k, runtime, slots0)
    return System(cfg, engine, ctrl, probe, tel, runtime)


@dataclass
class Record:
    """One request as the harness saw it."""
    rid: int
    req: TR.Request
    due: float                     # host time it was due
    handle: object = None
    times: list = field(default_factory=list)   # host time of each token
    prefill: Call | None = None    # its prefill's controller call
    in_window: bool = False        # due inside the measured window
    decode: list = field(default_factory=list)  # call of each later token


@dataclass
class Step:
    t0: float
    t1: float
    first: int                     # first tokens (admissions' prefills)
    decode: int                    # tokens from the batched step
    calls: list


class Session:
    """Drives one engine: submits requests when due and steps it,
    recording every token event on the host clock."""

    def __init__(self, system: System, gen: TR.Generator, traced: bool):
        self.sys, self.gen, self.traced = system, gen, traced
        self.recs: dict[int, Record] = {}
        self.steps: list[Step] = []
        self.queue: list[Record] = []     # generated, not yet due
        self.finished: list[int] = []     # rids, in finishing order
        self.rejected = 0
        self.hooks = None                 # (before, after) each step
        self._rid = 0

    # ------------------------------------------------------ requests

    def _record(self, r: TR.Request, due: float) -> Record:
        from repro_torch.serving.scheduler import GenRequest
        rec = Record(self._rid, r, due)
        rec.handle = GenRequest(rid=self._rid, arrival=math.nan,
                                prompt=r.prompt, max_new_tokens=r.max_new)
        self._rid += 1
        self.recs[rec.rid] = rec
        return rec

    def submit(self, rec: Record) -> None:
        with span("submit", self.traced):
            h = self.sys.engine.submit(rec.handle)
        if h.status == "rejected":
            self.rejected += 1

    def pending(self) -> int:
        sess = self.sys.engine._session
        return len(sess.sched.pending)

    # ---------------------------------------------------------- steps

    def step(self) -> Step:
        if self.hooks:
            self.hooks[0]()
        t0 = time.perf_counter()
        with span("engine.step", self.traced):
            events = self.sys.engine.step()
        t1 = time.perf_counter()
        with span("bookkeeping", self.traced):
            calls = self.sys.probe.take()
            # the step's admissions were prefilled in the order of their
            # first tokens, each followed by one controller call; the
            # batched step's call comes last
            first = 0
            for ev in events:
                rec = self.recs[ev.rid]
                if not rec.times:
                    if first < len(calls):
                        rec.prefill = calls[first]
                    first += 1
                else:
                    rec.decode.append(calls[first] if len(calls) > first
                                      else None)
                rec.times.append(t1)
                if ev.done:
                    self.finished.append(ev.rid)
            st = Step(t0, t1, first, len(events) - first, calls)
            self.steps.append(st)
        if self.hooks:
            self.hooks[1]()
        return st

    # ---------------------------------------------------------- loops

    def warm_buckets(self, lo: int, hi: int, max_len: int) -> None:
        """One solo prefill at every power-of-two bucket from `lo` to
        `hi`, on the engine's own prefill path."""
        b = TR.bucket(lo, max_len)
        while True:
            self.sys.engine.prefill_request(
                np.ones(b, np.int32), collect=None)
            if b >= TR.bucket(hi, max_len):
                break
            b *= 2

    def backlog_until(self, finished: int, min_queued: int) -> None:
        """Keep `min_queued` requests waiting and step until `finished`
        more requests have finished."""
        target = len(self.finished) + finished
        while len(self.finished) < target:
            self.top_up(min_queued)
            self.step()

    def top_up(self, min_queued: int) -> None:
        n = min_queued - self.pending()
        now = time.perf_counter()
        for _ in range(max(0, n)):
            self.submit(self._record(self.gen.next(), now))

    def open_loop(self, t_open: float, t0_gen: float, until: float,
                  stop, last: float = math.inf) -> None:
        """Submit the generator's requests at t_open + (due - t0_gen) and
        step while there is work, until `stop()` or host time `until`.
        A request due at or after `last` is never submitted."""
        while True:
            now = time.perf_counter()
            if now >= until or stop():
                return
            while True:
                if not self.queue:
                    r = self.gen.next()
                    self.queue.append(self._record(
                        r, t_open + (r.due - t0_gen)))
                if self.queue[0].due > now or self.queue[0].due >= last:
                    break
                self.submit(self.queue.pop(0))
            if self.sys.engine.has_work:
                self.step()
            elif self.queue[0].due < last:
                wait = min(self.queue[0].due, until) - time.perf_counter()
                if wait > 0:
                    with span("idle", self.traced):
                        time.sleep(wait)


def params_free(system: System) -> None:
    """Close the engine's session and drop the program's state."""
    system.engine.close()
    for f in dataclasses.fields(system):
        setattr(system, f.name, None)
