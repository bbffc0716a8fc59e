"""Serverless expert runtime — the device-resident slot state machine
that EXECUTES the control plane's replica plans in the serving hot path
(paper §2.4/§5).

The control plane (``core.control.ControlPlane.step``) decides, per
iteration and per MoE layer, how many replicas each expert function
gets and where they live. ``ExpertRuntime`` owns the slot-resident
expert weight banks that the EP slot data plane
(``distributed.ep.moe_ep_layer``) reads, and applies each
``IterationOutcome`` as a **diff**:

  * function locality — a warm (expert, device) replica keeps its slot;
    it is never re-copied. An unchanged plan moves zero bytes.
  * minimal transfers — only replicas with no live instance cost a slot
    weight copy; the copy count equals the plan's diff against current
    residency (``LayerPlan.diff_size``).
  * cold-start hiding — a new replica whose modeled cold start fits
    inside the predictor's lead time is *prewarmed* (serves this
    iteration); otherwise it is *cold* and serves from the NEXT
    iteration via the control plane's warm-subset ``served`` plan.
    Weights materialise either way — the copy IS the cold start.
  * keep-alive eviction — instances idle past ``keep_alive`` free their
    slot and are billed for their actual residency, exactly like the
    analytic ``ServerlessExpertPool``.

Metering: cold/warm/prewarmed counts and GB-seconds follow the same
classification as the analytic pool, while ``bytes_moved`` counts the
weight bytes written into slot banks. Both honour
``cfg.moe.slot_dtype``: with ``'int8'`` the banks hold per-row-scale
quantized experts (``kernels.quant``), quantized once at construction,
and ``_slot_row_bytes`` equals ``costmodel.param_bytes(cfg)``. Every
meter is host arithmetic, the same as the reference runtime's.

Slot geometry: the plan's `num_devices` logical devices each own
`slots_per_device` logical slots, flattened to ``total_slots`` physical
slots, padded up to a multiple of the EP degree (``phys_slots``; pad
slots stay empty). Physical slot s lives on EP rank
``s // slots_per_rank``. A replica planned onto a full device spills to
the ring-nearest logical device with a free slot, mirroring
``plan_to_tables``.

Multi-rank (a ``launch.mesh.ServingMesh``): every rank runs the same
host-side state machine on the same plans, so the slot residency, the
tables and every meter of ``RuntimeStats`` (``rank_bytes`` included) are
identical on all ranks and equal the reference's. Each rank's banks hold
only its own ``(periods, slots_per_rank, ...)`` block, and its padded
source bank every expert but only its tp slice of F
(``distributed.ep.tp_slice``); a flush writes only the slots this rank
owns. ``local_bytes`` counts the bytes a rank actually wrote into its
banks (each replica copy once): times tp it equals the rank's
``rank_bytes`` share for float banks (int8 banks keep their D-length
scales whole on every tp rank).

Double buffering (default): each flush writes the new diff PLUS the
diff the front bank received last flush (catch-up) into the BACK bank
with one ``index_copy_`` per leaf, then the buffers swap. The copies
run on the current stream, so they are ordered after the step that
read the front bank and before the step that reads the new one.
"""
from __future__ import annotations

import math
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import serverless as SL
from repro_torch.core.control import (MOELESS_EXEC_TIME, PlanEvent,
                                      default_slots_per_device)
from repro_torch.core.costmodel import V5E, Hardware, derive_coeffs
from repro_torch.distributed.ep import EPContext, check_mesh, tp_slice
from repro_torch.kernels import quant as QT
from repro_torch.models import transformer as T


@dataclass
class RuntimeStats:
    """Cumulative meters of the executing runtime (all layers)."""
    cold_starts: int = 0
    warm_starts: int = 0
    prewarmed: int = 0
    transfers: int = 0             # slot weight copies actually performed
    bytes_moved: float = 0.0       # actual bytes written into slot banks
    evictions: int = 0             # keep-alive expiries
    instance_seconds_gb: float = 0.0   # GB-seconds of actual residency
    # a copy whose replica serves only from the NEXT iteration (absent
    # from the warm-subset served plan) can overlap this iteration's
    # compute; copies the next dispatch needs immediately are exposed
    overlap_eligible_copies: int = 0
    exposed_copies: int = 0
    overlap_hidden_s: float = 0.0  # sum min(cold_start, compute window)
    # bytes written on each EP rank's slot shard ("rank0", ...)
    rank_bytes: dict = field(default_factory=dict)
    # per-phase breakdown ('bootstrap', 'prefill', 'decode', 'mixed')
    by_phase: dict = field(default_factory=dict)

    def counts(self) -> tuple[int, int, int]:
        return self.cold_starts, self.warm_starts, self.prewarmed

    def phase(self, name: str) -> dict:
        return self.by_phase.setdefault(name, {
            "iterations": 0, "cold_starts": 0, "warm_starts": 0,
            "prewarmed": 0, "transfers": 0, "bytes_moved": 0.0})


@dataclass
class ApplyReport:
    """What ONE ``apply`` call did to the slot state."""
    transfers: int = 0
    bytes_moved: float = 0.0
    cold_starts: int = 0
    warm_starts: int = 0
    prewarmed: int = 0
    evictions: int = 0
    overlap_eligible: int = 0
    exposed: int = 0
    per_layer_transfers: list = field(default_factory=list)
    rank_bytes: dict = field(default_factory=dict)


@dataclass
class _SlotInstance:
    """One live expert function instance, resident in one slot."""
    slot: int
    born: float
    last_used: float


def _padded_bank(bank: dict, slot_dtype: str) -> dict:
    """Leaves (P, E, R, C) -> (P, E+1, R, C) with a zero expert row for
    empty slots; under 'int8' quantized (``kernels.quant`` layout) one
    (period, expert) matrix at a time, so no float copy of the whole bank
    is ever made."""
    out = {}
    for k, w in bank.items():
        shape = (w.shape[0], w.shape[1] + 1) + tuple(w.shape[2:])
        if slot_dtype == "int8":
            q = torch.zeros(shape, dtype=torch.int8, device=w.device)
            s = torch.ones(shape[:3], dtype=torch.float32, device=w.device)
            for p in range(w.shape[0]):
                for e in range(w.shape[1]):
                    q[p, e], s[p, e] = QT.quantize_rows(w[p, e])
            out[k], out[k + QT.SCALE_SUFFIX] = q, s
        else:
            padded = torch.zeros(shape, dtype=w.dtype, device=w.device)
            padded[:, :-1] = w
            out[k] = padded
    return out


class ExpertRuntime:
    """Owns the slot-resident expert weights for every MoE layer of one
    model and executes the control plane's plans as slot diffs.

    Lifecycle: ``bootstrap(control)`` installs the balancer's prewarm
    plans (or a static plan), ``apply(t, events)`` executes one
    iteration's ``PlanEvent`` list, ``ep_state()`` exports the live
    tables/weights for the decode step, ``finalize(now)`` settles
    residency billing.
    """

    def __init__(self, cfg, params, *, num_devices: int,
                 slots_per_device: int = 0, mesh=None,
                 keep_alive: float = 60.0, hw: Hardware = V5E,
                 coeffs=None, double_buffer: bool = True,
                 telemetry=None, track: str = "runtime"):
        assert cfg.is_moe, "expert runtime serves MoE models"
        from repro_torch.obs.telemetry import NOOP
        self.telemetry = NOOP if telemetry is None else telemetry
        self.track = track
        if cfg.act != "swiglu":
            raise NotImplementedError(
                "EP slot banks hold swiglu experts (w_gate/w_up/w_down); "
                f"act={cfg.act!r} is not wired into the slot data plane — "
                "the reference has the same limit "
                "(src/repro/serving/expert_runtime.py:169)")
        self.cfg = cfg
        self.keep_alive = keep_alive
        self.hw = hw
        self.coeffs = coeffs if coeffs is not None else derive_coeffs(cfg)
        self._cold_start_s = SL.cold_start_latency(self.coeffs.expert_bytes,
                                                   hw)

        pattern = T.layer_pattern(cfg)
        self.moe_positions = [j for j, sub in enumerate(pattern)
                              if sub.ffn == "moe"]
        self.pattern_len = len(pattern)
        self.mpp = len(self.moe_positions)       # MoE sublayers per period
        self.periods = cfg.num_layers // len(pattern)
        self.n_layers = self.periods * self.mpp  # == ControlPlane.n_layers

        e = cfg.moe.num_experts
        self.num_experts = e
        self.num_devices = num_devices
        self.slots_per_device = slots_per_device \
            or default_slots_per_device(e, num_devices)
        self.total_slots = num_devices * self.slots_per_device

        _, self.ep, self.tp = check_mesh(mesh)
        # this rank's EP index: it owns physical slots [ep_rank *
        # slots_per_rank, (ep_rank + 1) * slots_per_rank)
        self.ep_rank = 0 if mesh is None else mesh.coords[1]
        self.phys_slots = -(-self.total_slots // self.ep) * self.ep
        self.pad_slots = self.phys_slots - self.total_slots
        if self.pad_slots:
            warnings.warn(
                f"expert runtime: {self.total_slots} slots "
                f"({num_devices} devices x {self.slots_per_device}) do "
                f"not split over {self.ep} EP ranks; padding the bank "
                f"with {self.pad_slots} masked slot(s)",
                RuntimeWarning, stacklevel=2)
        self.slots_per_rank = self.phys_slots // self.ep
        self.ctx = EPContext(slots_per_device=self.slots_per_rank,
                             capacity_factor=cfg.moe.capacity_factor,
                             mesh=mesh)

        slot_dtype = getattr(cfg.moe, "slot_dtype", "fp32")
        if slot_dtype not in ("fp32", "int8"):
            raise ValueError(f"unknown slot_dtype {slot_dtype!r}")
        self.padded = {}
        self.banks = {}
        self._back = {}
        self._pending = {}
        self._slot_row_bytes = {}
        self.double_buffer = double_buffer
        for j in self.moe_positions:
            padded = {k: tp_slice(k, w, mesh, lead=2) for k, w in
                      _padded_bank(params["layers"][j]["moe"]["experts"],
                                   slot_dtype).items()}
            self.padded[j] = padded

            def _zero_bank():
                return {k: torch.zeros(
                    (self.periods, self.slots_per_rank)
                    + tuple(w.shape[2:]),
                    dtype=w.dtype, device=w.device)
                    for k, w in padded.items()}

            self.banks[j] = _zero_bank()
            # back buffer: flushes write here, then the buffers swap
            self._back[j] = _zero_bank() if double_buffer else None
            self._pending[j] = ([], [], [])
            # bytes of ONE slot row as stored (all tp slices) — equal
            # to costmodel.param_bytes(cfg) by construction
            self._slot_row_bytes[j] = float(sum(
                int(np.prod(w.shape[2:])) * w.element_size()
                * (1 if k.endswith(("gate_scale", "up_scale")) else self.tp)
                for k, w in padded.items()))

        # host-side slot state machine, per MoE layer l = p*mpp + m
        lm, s = self.n_layers, self.total_slots
        self.slot_expert = np.full((lm, s), e, np.int32)   # E => empty
        self.instances: list[dict] = [dict() for _ in range(lm)]
        # routing tables exported to the step (0-padded: padding is
        # never selected because r_idx < nrep)
        self.table_slots = np.zeros((lm, e, s), np.int32)
        self.table_nrep = np.ones((lm, e), np.int32)
        self._have_tables = False
        self.stats = RuntimeStats()
        self.stats.rank_bytes = {f"rank{r}": 0.0 for r in range(self.ep)}
        self.local_bytes = 0.0    # written into THIS rank's banks
        self.iterations = 0

    # ------------------------------------------------------ construction

    @classmethod
    def for_control(cls, cfg, params, control, *, mesh=None,
                    keep_alive: float | None = None, telemetry=None,
                    track: str = "runtime", double_buffer: bool = True):
        """Runtime sized to a ``ControlPlane``: same modeled device
        count, slot caps, cost coefficients and keep-alive — the
        preconditions for count/billing parity with the analytic pool."""
        if keep_alive is None:
            keep_alive = getattr(control.bal, "keep_alive", 60.0)
        sd = getattr(control, "slots_per_device", 0) \
            or getattr(control.bal, "max_replicas_per_device", 0)
        return cls(cfg, params, num_devices=control.num_devices,
                   slots_per_device=sd, mesh=mesh,
                   keep_alive=keep_alive, coeffs=control.coeffs,
                   double_buffer=double_buffer, telemetry=telemetry,
                   track=track)

    def bootstrap(self, control=None, t: float = 0.0) -> ApplyReport:
        """Install an initial deployment so the EP data plane has live
        tables BEFORE the first control-plane step (the first admission's
        prefill runs before any plan has been metered). With a prewarmed
        balancer its deployment-time plans are applied; otherwise a
        static uniform plan (one replica per expert) is materialised."""
        bal = getattr(control, "bal", None)
        prev = getattr(bal, "prev", None)
        serverless = bool(getattr(bal, "serverless", False))
        if prev:
            events = [PlanEvent(plan=prev[l], served=prev[l],
                                lead_time=math.inf,
                                exec_time=MOELESS_EXEC_TIME,
                                serverless=True)
                      for l in range(self.n_layers)]
        else:
            from repro_torch.core.plan import static_plan
            plan = static_plan(self.num_experts, self.num_devices)
            events = [PlanEvent(plan=plan, served=plan,
                                lead_time=math.inf,
                                exec_time=MOELESS_EXEC_TIME,
                                serverless=serverless)
                      for _ in range(self.n_layers)]
        return self.apply(t, events, phase="bootstrap")

    # -------------------------------------------------------- lifecycle

    def cold_start_latency(self) -> float:
        return self._cold_start_s

    def _bill(self, inst: _SlotInstance, until: float) -> None:
        alive = until - inst.born
        self.stats.instance_seconds_gb += \
            alive * self.coeffs.expert_bytes / 1e9

    def _reap(self, layer: int, now: float) -> None:
        inst = self.instances[layer]
        for key in [k for k, i in inst.items()
                    if now - i.last_used > self.keep_alive]:
            i = inst.pop(key)
            self._bill(i, i.last_used + self.keep_alive)
            self.slot_expert[layer, i.slot] = self.num_experts
            self.stats.evictions += 1

    def _alloc(self, layer: int, g: int) -> int:
        """Lowest free slot on logical device g, spilling to the
        ring-nearest device with capacity (mirrors ``plan_to_tables``)."""
        sd, gdev = self.slots_per_device, self.num_devices
        row = self.slot_expert[layer]

        def free_on(gg: int) -> int:
            base = gg * sd
            for s in range(base, base + sd):
                if row[s] == self.num_experts:
                    return s
            return -1

        g = g % gdev
        slot = free_on(g)
        if slot >= 0:
            return slot
        candidates = [gg for gg in range(gdev) if free_on(gg) >= 0]
        if not candidates:
            raise RuntimeError(
                f"layer {layer}: no free slot for a replica on device {g} "
                f"({self.total_slots} slots all resident)")
        near = min(candidates,
                   key=lambda gg: min((gg - g) % gdev, (g - gg) % gdev))
        warnings.warn(
            f"expert runtime: layer {layer} replica overflowed device {g} "
            f"(cap {sd}/device) and spilled to device {near}",
            RuntimeWarning, stacklevel=3)
        return free_on(near)

    # ------------------------------------------------------------ apply

    def rank_of_slot(self, slot: int) -> int:
        """EP rank owning physical slot `slot` (slot axis split evenly
        over the ranks)."""
        return slot // self.slots_per_rank

    def apply(self, t: float, events: list, phase: str = "decode",
              *, compute_s: float | None = None) -> ApplyReport:
        """Execute one iteration's planning decisions: reap expired
        instances, diff every layer's FULL plan against residency,
        materialise ONLY the changed slots, and rebuild the routing
        tables from the warm-subset ``served`` plans. `phase` tags the
        iteration in the per-phase meters. `compute_s` is the modeled
        iteration latency the copies can hide under: each
        overlap-eligible copy accrues ``min(cold_start_latency,
        compute_s)`` of hidden transfer time."""
        if len(events) != self.n_layers:
            raise ValueError(f"{len(events)} plan events for "
                             f"{self.n_layers} MoE layers")
        rep = ApplyReport()
        rep.rank_bytes = {f"rank{r}": 0.0 for r in range(self.ep)}
        evict0 = self.stats.evictions
        hidden0 = self.stats.overlap_hidden_s
        updates = {j: ([], [], []) for j in self.moe_positions}
        for layer, ev in enumerate(events):
            self._reap(layer, t)
            inst = self.instances[layer]
            served_set = set(ev.served.iter_replicas())
            if not ev.serverless:
                # serverful semantics: the plan IS the deployment —
                # replicas absent from it release their slot now
                desired = set(ev.plan.iter_replicas())
                for key in [k for k in inst if k not in desired]:
                    i = inst.pop(key)
                    self._bill(i, t)
                    self.slot_expert[layer, i.slot] = self.num_experts
                    self.stats.evictions += 1
            n_transfer = 0
            for key in ev.plan.iter_replicas():
                if key in inst:
                    inst[key].last_used = t + ev.lead_time + ev.exec_time
                    self.stats.warm_starts += 1
                    rep.warm_starts += 1
                    continue
                e, g = key
                slot = self._alloc(layer, g)
                self.slot_expert[layer, slot] = e
                inst[key] = _SlotInstance(
                    slot=slot, born=t,
                    last_used=t + ev.lead_time + ev.exec_time)
                if self._cold_start_s <= ev.lead_time:
                    self.stats.prewarmed += 1
                    rep.prewarmed += 1
                else:
                    self.stats.cold_starts += 1
                    rep.cold_starts += 1
                n_transfer += 1
                p, j = layer // self.mpp, \
                    self.moe_positions[layer % self.mpp]
                ps, ss, es = updates[j]
                ps.append(p)
                ss.append(slot)
                es.append(e)
                row_bytes = self._slot_row_bytes[j]
                self.stats.bytes_moved += row_bytes
                rep.bytes_moved += row_bytes
                rk = f"rank{self.rank_of_slot(slot)}"
                self.stats.rank_bytes[rk] += row_bytes
                rep.rank_bytes[rk] += row_bytes
                if key not in served_set:
                    self.stats.overlap_eligible_copies += 1
                    rep.overlap_eligible += 1
                    window = compute_s if compute_s is not None \
                        else ev.exec_time
                    self.stats.overlap_hidden_s += \
                        min(self._cold_start_s, window)
                else:
                    self.stats.exposed_copies += 1
                    rep.exposed += 1
            self.stats.transfers += n_transfer
            rep.transfers += n_transfer
            rep.per_layer_transfers.append(n_transfer)
            self._build_tables(layer, ev.served)
        rep.evictions = self.stats.evictions - evict0
        t_w0 = time.perf_counter()
        self._flush(updates)
        flush_wall = time.perf_counter() - t_w0
        self._have_tables = True
        self.iterations += 1
        ph = self.stats.phase(phase)
        ph["iterations"] += 1
        ph["cold_starts"] += rep.cold_starts
        ph["warm_starts"] += rep.warm_starts
        ph["prewarmed"] += rep.prewarmed
        ph["transfers"] += rep.transfers
        ph["bytes_moved"] += rep.bytes_moved
        tel = self.telemetry
        if tel.enabled:
            for kind, n in (("cold", rep.cold_starts),
                            ("warm", rep.warm_starts),
                            ("prewarmed", rep.prewarmed)):
                if n:
                    tel.runtime_starts.labels(kind=kind).inc(n)
            if rep.transfers:
                tel.runtime_transfers.inc(rep.transfers)
                tel.runtime_bytes.inc(rep.bytes_moved)
                for rk, b in rep.rank_bytes.items():
                    if b:
                        tel.runtime_rank_bytes.labels(rank=rk).inc(b)
            if rep.evictions:
                tel.runtime_evictions.inc(rep.evictions)
            if rep.overlap_eligible:
                tel.runtime_overlap_copies.labels(kind="eligible").inc(
                    rep.overlap_eligible)
            if rep.exposed:
                tel.runtime_overlap_copies.labels(kind="exposed").inc(
                    rep.exposed)
            hid = self.stats.overlap_hidden_s - hidden0
            if hid:
                tel.runtime_overlap_hidden.inc(hid)
            tel.runtime_resident.set(self.resident_replicas())
            tel.runtime_flush_seconds.observe(flush_wall)
            if tel.tracing and rep.transfers:
                tel.span(self.track, "bank_flush", t, t + flush_wall,
                         args={"phase": phase,
                               "transfers": rep.transfers,
                               "bytes": rep.bytes_moved})
        return rep

    def _build_tables(self, layer: int, served) -> None:
        inst = self.instances[layer]
        slots = self.table_slots[layer]
        nrep = self.table_nrep[layer]
        slots[:] = 0
        for e in range(self.num_experts):
            placement = served.placement[e]
            nrep[e] = max(1, len(placement))
            for r, g in enumerate(placement):
                slots[e, r] = inst[(e, int(g))].slot

    def _local(self, ps, ss, es):
        """The (period, local slot, expert) writes of a diff that land in
        this rank's banks."""
        lo, n = self.ep_rank * self.slots_per_rank, self.slots_per_rank
        return [(p, s - lo, e) for p, s, e in zip(ps, ss, es)
                if lo <= s < lo + n]

    def _scatter(self, bank, j, ps, ss, es):
        """Write this rank's changed slots' expert rows into `bank` in
        place: one ``index_copy_`` per leaf over the flattened (period,
        local slot) axis. Where a (period, slot) appears twice (the
        catch-up diff and a re-allocation since), the later write is the
        one kept."""
        last = {}
        for p, s, e in self._local(ps, ss, es):
            last[(p, s)] = e
        if not last:
            return bank
        dev = next(iter(bank.values())).device
        dst = torch.tensor([p * self.slots_per_rank + s for p, s in last],
                           dtype=torch.long, device=dev)
        src = torch.tensor([p * (self.num_experts + 1) + e
                            for (p, _), e in last.items()],
                           dtype=torch.long, device=dev)
        for k, b in bank.items():
            w = self.padded[j][k]
            b.view((-1,) + tuple(b.shape[2:])).index_copy_(
                0, dst, w.view((-1,) + tuple(w.shape[2:]))
                .index_select(0, src))
        return bank

    def _flush(self, updates: dict) -> None:
        """Write the changed slots' weights into this rank's banks.

        Double-buffered (default): the new diff PLUS the diff the front
        bank received last flush (catch-up, kept in ``_pending``) is
        written into the BACK bank, then the buffers swap, so the bank a
        step is reading is never written. ``bytes_moved`` and
        ``local_bytes`` meter each replica copy once; the catch-up write
        is pipeline bookkeeping, not a second cold start."""
        for j, (ps, ss, es) in updates.items():
            row = sum(b[0, 0].numel() * b.element_size()
                      for b in self.banks[j].values())
            self.local_bytes += row * len(self._local(ps, ss, es))
            if not self.double_buffer:
                if len(ps):
                    self.banks[j] = self._scatter(
                        self.banks[j], j, ps, ss, es)
                continue
            pp, sp, ep_ = self._pending[j]
            cps, css, ces = pp + list(ps), sp + list(ss), ep_ + list(es)
            if not cps:
                continue
            back = self._scatter(self._back[j], j, cps, css, ces)
            self._back[j] = self.banks[j]
            self.banks[j] = back
            self._pending[j] = (list(ps), list(ss), list(es))

    # ------------------------------------------------------------ export

    def ep_state(self) -> list:
        """The per-layer slot tables + weight banks as the decode step's
        ``ep_state``: one entry per sublayer pattern position (None for
        non-MoE positions), leaves stacked over periods."""
        if not self._have_tables:
            raise RuntimeError("expert runtime has no tables yet — "
                               "bootstrap() or apply() a plan first")
        state = [None] * self.pattern_len
        for m, j in enumerate(self.moe_positions):
            dev = next(iter(self.banks[j].values())).device
            # copies: the next apply rewrites the host tables in place
            state[j] = {
                "expert_slots": torch.from_numpy(
                    self.table_slots[m::self.mpp].copy()).to(dev),
                "nrep": torch.from_numpy(
                    self.table_nrep[m::self.mpp].copy()).to(dev),
                **self.banks[j],
            }
        return state

    # ---------------------------------------------------------- metering

    def resident_replicas(self) -> int:
        return sum(len(d) for d in self.instances)

    def residency_set(self, layer: int) -> set:
        """Live (expert, device) instances of one layer."""
        return set(self.instances[layer])

    def finalize(self, now: float) -> RuntimeStats:
        """Settle residency billing (idempotent — instances are released
        as they are billed), mirroring ``ServerlessExpertPool.finalize``."""
        for layer in range(self.n_layers):
            inst = self.instances[layer]
            for key, i in list(inst.items()):
                self._bill(i, min(now, i.last_used + self.keep_alive))
                self.slot_expert[layer, i.slot] = self.num_experts
                del inst[key]
        return self.stats
