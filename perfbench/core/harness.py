"""One run of one cell: set-up, the measured window, the check, and the
metrics of the run's kind (end-to-end with tracing off, per-layer with
it on). Each metric is read by its own reader,
``perfbench/metrics/<metric>.py``, from the ``Context`` of the run."""
from __future__ import annotations

import gc
import importlib.util
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from perfbench.core import check as CK
from perfbench.core import serve as SV
from perfbench.core import spec as SP
from perfbench.core import trace as TRC
from perfbench.core import traffic as TR
from perfbench.core import weights as W

METRICS = Path(__file__).resolve().parent.parent / "metrics"


@dataclass
class Context:
    """What a metric reader reads."""
    cfg: object
    setup_s: float
    t_open: float
    t_close: float
    steps: list
    recs: list                      # every request of the run
    window: list                    # the requests the window measures
    runtime: bool
    trace: TRC.Trace | None = None
    stretch: list = field(default_factory=list)   # the traced steps
    tel: dict = field(default_factory=dict)       # counter deltas


def _counters(tel) -> dict:
    """The telemetry counters the per-layer readers take deltas of."""
    out = {}
    for ph in ("prefill", "decode"):
        h = tel.engine_step_seconds.labels(phase=ph)
        out[f"step_s.{ph}"], out[f"steps.{ph}"] = h.sum, h.count
    out["runtime_bytes"] = tel.runtime_bytes._default().value
    return out


class _Stretch:
    """Profiles the steps from the first that starts after `t_a` until
    one ends `seconds` after the stretch opened, snapshotting the
    telemetry counters at both ends. The first profiled step, which
    pays for the profiler's start, is left out: the stretch opens when
    it ends. The profiler stops in the window; its trace is read once
    the window has closed (``read``), since reading it takes seconds
    that would stall the engine."""

    def __init__(self, sess: SV.Session, t_a: float, seconds: float):
        self.sess, self.t_a, self.seconds = sess, t_a, seconds
        self.prof, self.first, self.last, self.stopped = None, 0, 0, None
        self.opened, self.t_b, self.stop_s = False, 0.0, 0.0
        self.c0 = self.c1 = None

    def before(self):
        if self.prof is None and self.stopped is None \
                and time.perf_counter() >= self.t_a:
            self.prof = TRC.Profiler()
            self.prof.start()

    def after(self, end: bool = False):
        if self.prof is None:
            return
        if not self.opened:
            self.opened = True
            self.prof.open()
            self.c0 = _counters(self.sess.sys.telemetry)
            self.first = len(self.sess.steps)
            self.t_b = time.perf_counter() + self.seconds
            if not end:
                return
        if end or self.sess.steps[-1].t1 >= self.t_b:
            t = time.perf_counter()
            self.prof.stop()
            self.stop_s = time.perf_counter() - t
            self.c1 = _counters(self.sess.sys.telemetry)
            self.last = len(self.sess.steps)
            self.stopped, self.prof = self.prof, None

    def read(self) -> TRC.Trace | None:
        if self.stopped is None:
            return None
        t = time.perf_counter()
        tr = self.stopped.read()
        tr.stop_s, tr.read_s = self.stop_s, time.perf_counter() - t
        return tr


def setup(sess: SV.Session, cell: dict, spec: TR.Spec) -> None:
    """Warm every prefill bucket the traffic can reach, then serve the
    cell's own traffic: a backlog until `finished` requests have
    finished, or the arrivals of the schedule's first `burst_s` seconds,
    drained. The burst ends on the schedule's clock, not the host's, so
    that the window opens on the same request of the schedule in every
    run, however long the burst's first steps take."""
    su = cell["setup"]
    sess.warm_buckets(spec.prompt["min"], spec.prompt["max"],
                      cell["max_len"])
    if spec.arrivals == "backlog":
        sess.backlog_until(su["finished"], spec.min_queued)
        return
    now = time.perf_counter()
    end = now + su["burst_s"]
    sess.open_loop(now, 0.0, float("inf"),
                   lambda: bool(sess.queue) and sess.queue[0].due >= end,
                   last=end)
    for rec in sess.queue:              # generated, never sent
        del sess.recs[rec.rid]
    sess.queue.clear()
    while sess.sys.engine.has_work:
        sess.step()


def window(sess: SV.Session, cell: dict, spec: TR.Spec, seconds: float,
           stretch: _Stretch | None):
    """The measured window. Returns (t_open, t_close, the requests it
    measures)."""
    hooks = (stretch.before, stretch.after) if stretch else None
    sess.hooks = hooks
    t_open = time.perf_counter()
    t_end = t_open + seconds
    if spec.arrivals == "backlog":
        while True:
            sess.top_up(spec.min_queued)
            st = sess.step()
            if st.t1 >= t_end:
                break
        t_close = st.t1
        measured = [r for r in sess.recs.values()
                    if any(t_open < t <= t_close for t in r.times)]
        return t_open, t_close, measured
    first_rid = sess._rid
    t0_gen = sess.gen.t
    drain = cell.get("drain_s", 60.0)

    def done() -> bool:
        if time.perf_counter() < t_end:
            return False
        return all(r.handle.finish_reason for r in sess.recs.values()
                   if r.rid >= first_rid and r.due < t_end
                   and r.handle is not None)
    sess.open_loop(t_open, t0_gen, t_end + drain, done)
    measured = [r for r in sess.recs.values()
                if r.rid >= first_rid and t_open <= r.due < t_end]
    for r in measured:
        r.in_window = True
    return t_open, t_end, measured


def _reader(name: str):
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(ctx: Context, entries: list) -> dict:
    out = {}
    for m in entries:
        v = _reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run(cell: SP.Cell, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda", smoke: bool = False,
        fault=None, limits: dict | None = None, control: bool = False):
    """One run. Returns the result's fields (without the check's
    printout) and the readings of the check."""
    cfg = SP.model_config(cell.config, smoke)
    if smoke:
        cfg = cfg.with_(dtype="float32", impl="ref")
    params = W.make(cfg, seed, device)
    system = SV.build(cfg, params, cell.cell, cell.config, traced)
    if fault is not None:
        fault(system)
    spec = TR.load(cell.entry["traffic"])
    if "traffic_override" in cell.cell:   # a test's smaller mix
        spec = TR.Spec(**{**spec.__dict__, **cell.cell["traffic_override"]})
    gen = TR.Generator(spec, seed, cfg.vocab_size,
                       rate=cell.cell.get("rate", 0.0))
    sess = SV.Session(system, gen, traced)
    setup(sess, cell.cell, spec)
    if device == "cuda":
        torch.cuda.synchronize()
    t_open = time.perf_counter()
    stretch = None
    if traced:
        tr = cell.cell["trace"]
        stretch = _Stretch(sess, t_open + tr["start"] * seconds,
                           tr["seconds"])
    t_open, t_close, measured = window(sess, cell.cell, spec, seconds,
                                       stretch)
    if stretch is not None:
        stretch.after(end=True)
        sess.hooks = None
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    ctx = Context(cfg, t_open - t_start, t_open, t_close, sess.steps,
                  list(sess.recs.values()), measured, system.runtime)
    if stretch is not None and stretch.stopped is not None:
        ctx.trace = stretch.read()
        ctx.stretch = sess.steps[stretch.first:stretch.last]
        ctx.tel = {k: stretch.c1[k] - stretch.c0[k] for k in stretch.c0}
    metrics = read_metrics(ctx, cell.per_layer if traced
                           else cell.end_to_end)
    finished = [r for r in measured if r.handle.finish_reason]
    unfinished = len(measured) - len(finished) \
        if gen.spec.arrivals == "open_loop" else 0
    short = sum(1 for r in finished
                if len(r.handle.tokens) != r.req.max_new)
    # the check, once the program's state is freed
    arch = SP.arch_of(cfg, cell.config)
    ck = cell.cell["check"]
    rejected = sess.rejected
    picked = CK.sample(finished, seed, ck["tokens"], ck["requests"])
    rules = CK.Rules(arch, system.runtime)
    reqs = CK.requests(arch, picked, cell.cell["max_len"], rules)
    SV.params_free(system)
    del sess, stretch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    got = CK.compare(arch, params, reqs)
    readings = {"program": got, "calls": rules.calls}
    if control:
        from perfbench.reference import moe_decoder as REF
        readings["control"] = CK.compare(arch, params, reqs,
                                         REF.control_precision(arch))
    limits = limits if limits is not None else ck["limits"]
    checks = {
        "widest_gap": {"value": got["widest_gap"],
                       "limit": limits["widest_gap"]},
        "route_gap": {"value": got["route_gap"],
                      "limit": limits["route_gap"]},
        "load_mismatch": {"value": rules.load_mismatch, "limit": 0},
        "drop_mismatch": {"value": rules.drop_mismatch, "limit": 0},
        "unplaced": {"value": unplaced(ctx), "limit": 0},
        "unfinished": {"value": unfinished, "limit": 0},
        "short": {"value": short, "limit": 0},
        "rejected": {"value": rejected, "limit": 0},
    }
    shares = dropped(ctx)
    for ph in ("prefill", "decode"):
        key = f"dropped_share.{ph}"
        if key in limits:
            # a phase whose calls report no drops reads as all dropped
            d, n = shares.get(ph, (1.0, 1.0))
            checks[key] = {"value": d / n if n else 0.0,
                           "limit": limits[key]}
    correct = bool(picked) and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else device, "count": 1, "memory_peak_bytes": int(peak)}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.window_s
    result = {"correct": correct, "attempted": len(measured),
              "failed": unfinished + rejected, "metrics": metrics,
              "device": dev}
    if ctx.trace is not None:
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = checks
    return result, readings, ctx


def _window_calls(ctx: Context):
    """(phase, call) of every controller call from the window's opening
    on, its drain included."""
    for st in ctx.steps:
        if st.t0 < ctx.t_open:
            continue
        for i, c in enumerate(st.calls):
            yield c.phase or ("prefill" if i < st.first else "decode"), c


def dropped(ctx: Context) -> dict:
    """{phase: (dropped, routed)}: the assignments the engine reported
    dropped and those it routed (the loads it handed the controller),
    over the window's calls; phases whose calls report no drops are
    left out."""
    out: dict[str, tuple] = {}
    for ph, c in _window_calls(ctx):
        if c.dropped is None:
            continue
        d, n = out.get(ph, (0.0, 0.0))
        out[ph] = (d + float(np.sum(c.dropped)),
                   n + float(np.sum(c.loads)))
    return out


def unplaced(ctx: Context) -> int:
    """Assignments the window's calls routed to an expert of which the
    slot tables in force held no replica (the EP slot plane then sends
    them to another expert's slot)."""
    n = 0.0
    for _, c in _window_calls(ctx):
        if c.slots is not None:
            n += float(c.loads[c.slots.max(axis=2) < 0].sum())
    return int(n)
