"""Serving engine: a request-level API over continuous-batch
prefill/decode on the PyTorch model, with the MoEless control plane
attached.

    engine.start(num_slots=8, control=..., time_scale=...)
    h = engine.submit(GenRequest(..., sampling=SamplingParams(...)))
    engine.step()            # one admission+decode iteration
    engine.run()             # drive until idle -> ServeResult
    for tok in engine.stream(h): ...   # incremental tokens
    engine.cancel(h)         # mid-decode: the KV slot is recycled
    engine.serve(requests)   # trace replay = thin driver over the above
    engine.prefill(batch); engine.decode(...)   # fixed-batch greedy API

Requests are prefilled alone, spliced into a free slot of the KV pool
(``serving.kv``: contiguous ``SlotKVCache`` or paged ``PagedKVCache``),
decoded together in ONE batched step with per-slot cache lengths, and
leave on EOS / stop sequence / token budget / cancellation, freeing the
slot for the next arrival. With ``serving.prefill_chunk > 0`` (paged
only) admission is table work alone and prompts are fed chunk by chunk
into the same batched step the decoding slots run (``_step_chunked``),
optionally sharing prompt prefixes through the radix prefix cache.
Sampling is ONE call over all slots with per-request keys folded per
generated token (``models.transformer.sample_tokens``); greedy is the
``temperature=0`` case, bit-identical to argmax decoding, and a step
whose running requests are all greedy takes the argmax alone.

Every iteration drives the single control-plane implementation
(``core.control.ControlPlane.step``): the Scaler sizes replicas, the
Placer assigns them, and — with a session ``control`` — the reference
cost model's modeled iteration latency advances the serving clock that
TTFT / TPOT / E2E are recorded against (without one, measured wall time
does).

``expert_runtime="on"`` attaches a ``serving.expert_runtime.
ExpertRuntime`` to every session: the session control plane's replica
plans are EXECUTED as slot diffs on device-resident expert weight banks
(int8 under ``cfg.moe.slot_dtype="int8"``), and both phases' MoE layers
(each prefill and the batched step) run through the EP slot data plane
(``distributed.ep.moe_ep_layer``) with the runtime's live tables and
banks, at (data, ep, tp) = (1, 1, 1).

Not yet in this package: a device mesh (``NotImplementedError``; the
multi-rank slice).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.core.control import (ControlPlane,  # noqa: F401 (re-export)
                                      IterationOutcome, MoElessController)
from repro_torch.kernels.ops import resolve_impl
from repro_torch.models import prng
from repro_torch.models import transformer as T
from repro_torch.obs.telemetry import NOOP
from repro_torch.serving.kv import PagedKVCache, SlotKVCache
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           GenRequest, RequestMetrics,
                                           SamplingParams,
                                           percentile_summary)


class TokenEvent(NamedTuple):
    """One generated token, as surfaced by ``ServingEngine.step``."""
    rid: int
    token: int
    done: bool


@dataclass
class RequestHandle:
    """Client-side view of one submitted request."""
    req: GenRequest
    _engine: "ServingEngine"
    _rejected: bool = False

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def tokens(self) -> list[int]:
        return self.req.tokens

    @property
    def status(self) -> str:
        """queued | running | finished | cancelled | rejected"""
        if self._rejected:
            return "rejected"
        if self.req.finish_reason in ("cancelled", "replica_failed"):
            return "cancelled"
        if self.req.finish_reason:
            return "finished"
        sess = self._engine._session
        if sess is not None and self.req.slot >= 0 \
                and sess.sched.running.get(self.req.slot) is self.req:
            return "running"
        return "queued"

    @property
    def finish_reason(self) -> str:
        return self.req.finish_reason

    def metrics(self) -> RequestMetrics:
        return RequestMetrics.of(self.req)


@dataclass
class ServeResult:
    """Outcome of one continuous-batching serving session."""
    records: list[RequestMetrics]
    iterations: int
    prefills: int
    rejected: int
    cancelled: int
    mean_batch_occupancy: float
    wall_s: float
    control: ControlPlane | None = None
    runtime: object | None = None     # ExpertRuntime when enabled
    clock_s: float = 0.0              # final serving-clock time
    dropped_tokens: float = 0.0       # MoE capacity drops (all phases)

    def summary(self) -> dict:
        return percentile_summary(self.records)

    @property
    def generated_tokens(self) -> int:
        return sum(r.out_tokens for r in self.records)


class _Session:
    """Mutable state of one serving session: the slot pool, the
    scheduler, the serving clock, the last token of every slot and the
    per-slot sampling arrays that feed the one ``sample_tokens`` call."""

    def __init__(self, cfg, params, num_slots: int, max_len: int,
                 eos_id, control, time_scale: float, serving,
                 runtime=None):
        if serving.kv == "paged":
            self.kv = PagedKVCache(cfg, params, num_slots, max_len,
                                   block=serving.kv_block,
                                   num_blocks=serving.kv_blocks,
                                   prefix_cache=serving.prefix_cache,
                                   chunked=serving.prefill_chunk > 0)
        else:
            self.kv = SlotKVCache(cfg, params, num_slots, max_len)
        self.sched = ContinuousBatchingScheduler(self.kv, eos_id=eos_id)
        self.control = control
        self.runtime = runtime
        self.time_scale = time_scale
        self.now = 0.0
        rows = self.kv.rows
        self.cur = np.zeros(rows, np.int64)            # last token per slot
        # the per-slot sampling arrays are views of one host buffer
        # (seed first, at 8-byte alignment), so a sampled step moves them
        # to the device in one copy
        self._samp = np.zeros(24 * rows, np.uint8)
        seed, temp, topk, topp, count = np.split(
            self._samp, np.cumsum([8, 4, 4, 4]) * rows)
        # a key keeps the low 32 bits of its seed (PRNGKey's rule), so any
        # integer seed a client sends is stored as those bits
        self.seed = seed.view(np.int64)
        self.temp = temp.view(np.float32)
        self.topk = topk.view(np.int32)
        self.topp = topp.view(np.float32)
        self.topp[:] = 1.0
        self.count = count.view(np.int32)              # tokens sampled
        # chunked prefill: per-slot prompt (fed chunk by chunk into the
        # batched step) and its length; a slot is mid-prefill while
        # kv.lengths[slot] < plen[slot]
        self.plen = np.zeros(self.kv.rows, np.int32)
        self.prompts: dict[int, np.ndarray] = {}
        self.cow_seen = 0              # kv.cow_blocks already counted
        self.occupancy: list[int] = []
        self.iters = 0
        self.prefills = 0
        self.wall0 = time.perf_counter()

    def bind_slot(self, slot: int, req: GenRequest) -> None:
        s = req.sampling
        self.temp[slot] = s.temperature
        self.topk[slot] = s.top_k
        self.topp[slot] = s.top_p
        self.seed[slot] = s.effective_seed(req.rid) & prng.MASK
        self.count[slot] = 0

    def sampling(self) -> bool:
        """True when a running request samples (temperature > 0): the
        step then calls the sampler, else takes the argmax alone."""
        return any(self.temp[s] > 0 for s in self.sched.running)

    def sampling_args(self, device) -> tuple:
        """The per-slot (temperature, top_k, top_p, seed, count) of
        ``sample_tokens``, on `device`: one copy of the shared buffer,
        on a card from pinned memory without blocking the host."""
        buf = torch.from_numpy(self._samp)
        if torch.device(device).type == "cuda":
            buf = buf.pin_memory().to(device, non_blocking=True)
        rows = self.kv.rows
        seed, temp, topk, topp, count = torch.split(
            buf, [8 * rows] + [4 * rows] * 4)
        return (temp.view(torch.float32), topk.view(torch.int32),
                topp.view(torch.float32), seed.view(torch.int64),
                count.view(torch.int32))


class ServingEngine:
    """Prefill + decode with KV caches behind a request-level API;
    optionally drives a MoEless controller each iteration, and with
    ``expert_runtime="on"`` executes the session control plane's plans
    through the expert runtime and the EP slot data plane (a session
    ``control`` is then required)."""

    def __init__(self, cfg, params, *, max_len: int = 512,
                 controller: ControlPlane | None = None,
                 window: int = 0, impl: str | None = None,
                 expert_runtime: str = "off", mesh=None,
                 telemetry=None, name: str = "engine", serving=None,
                 runtime_double_buffer: bool = True):
        if impl is not None:   # override the config's kernel backend
            cfg = cfg.with_(impl=impl)
        resolve_impl(cfg.impl)   # validate eagerly, not at first step
        if expert_runtime not in ("off", "on"):
            raise ValueError(f"expert_runtime={expert_runtime!r} "
                             "(expected 'off' or 'on')")
        if expert_runtime == "on" and not cfg.is_moe:
            raise ValueError("expert_runtime='on' needs an MoE model")
        if mesh is not None:
            raise NotImplementedError(
                "a serving mesh arrives with the multi-rank EP slice of the "
                "PyTorch port")
        spec = serving if serving is not None else cfg.serving
        if spec.kv not in ("contiguous", "paged"):
            raise ValueError(f"serving.kv={spec.kv!r} "
                             "(expected 'contiguous' or 'paged')")
        if spec.kv != "paged" and (spec.prefill_chunk > 0
                                   or spec.prefix_cache):
            raise ValueError("prefill_chunk / prefix_cache require "
                             "serving.kv='paged'")
        if spec.prefix_cache and spec.prefill_chunk <= 0:
            raise ValueError(
                "prefix_cache requires prefill_chunk > 0 — the solo "
                "splice path always recomputes the whole prompt, so a "
                "prefix hit could never skip work")
        pattern = T.layer_pattern(cfg)  # rejects stacks not ported yet
        if spec.kv == "paged" and any(sub.mixer != "attn"
                                      for sub in pattern):
            raise ValueError("serving.kv='paged' needs an attention-only "
                             "decoder (no SSM state, no enc-dec)")
        self.serving = spec
        self.cfg, self.params = cfg, params
        self.device = params["embed"].device
        self.max_len = max_len
        self.controller = controller
        # telemetry is observation-only: it never touches the serving
        # clock or routing
        self.telemetry = NOOP if telemetry is None else telemetry
        self.name = name
        self._marks: dict[int, float] = {}   # rid -> prefill-end clock t
        self.window = window
        self.expert_runtime = expert_runtime
        # False: the runtime writes replica copies into the one bank the
        # step reads (half the bank memory; a step never overlaps a flush
        # here, as the copies are enqueued on the step's own stream)
        self.runtime_double_buffer = runtime_double_buffer
        self._collect = controller is not None and cfg.is_moe
        self.iteration = 0
        self._session: _Session | None = None
        # the session-mutating surface (submit / cancel / step / start /
        # close) may be shared by an event-loop thread and a step-loop
        # thread
        self._lock = threading.RLock()
        self._step_hooks: list[Callable] = []

    def _step(self, batch, cache, cache_len, collect: bool, ep=None):
        """One model call; `ep` = (EPContext, ep_state) routes the MoE
        sublayers through the EP slot data plane."""
        ep_ctx, ep_state = ep if ep is not None else (None, None)
        with torch.no_grad():
            return T.decode_step(self.cfg, self.params, batch, cache,
                                 cache_len, window=self.window,
                                 collect=collect, ep_ctx=ep_ctx,
                                 ep_state=ep_state)

    @staticmethod
    def _ep(sess, pad_rows: int = 0):
        """(context, live tables/banks) of the session's expert runtime,
        or None when it is off."""
        rt = sess.runtime if sess is not None else None
        if rt is None:
            return None
        return dataclasses.replace(rt.ctx, pad_rows=pad_rows), rt.ep_state()

    def new_cache(self, batch_size: int):
        return T.init_cache(self.cfg, self.params, batch_size, self.max_len)

    # ------------------------------------------------ fixed-batch API

    def prefill(self, batch):
        """batch['tokens']: (B, S_prompt), every row a whole prompt (no
        padding). Returns (greedy next tokens (B,), cache, S_prompt)."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        cache = self.new_cache(batch["tokens"].shape[0])
        logits, cache, metrics = self._step(batch, cache, 0, self._collect)
        self._drive_controller(metrics)
        return torch.argmax(logits[:, -1], dim=-1), cache, \
            batch["tokens"].shape[1]

    def decode(self, tokens, cache, cache_len: int, steps: int,
               extra=None):
        """Greedy decode `steps` tokens after `tokens` (B,). Returns
        (tokens (B, steps), cache, cache_len)."""
        out = []
        cur = torch.as_tensor(tokens, device=self.device)
        for _ in range(steps):
            batch = {"tokens": cur[:, None]}
            if extra:
                batch.update(extra)
            logits, cache, metrics = self._step(batch, cache, cache_len,
                                                self._collect)
            self._drive_controller(metrics)
            cur = torch.argmax(logits[:, -1], dim=-1)
            out.append(cur)
            cache_len += 1
            self.iteration += 1
        return torch.stack(out, dim=1), cache, cache_len

    def _drive_controller(self, metrics, token_mask=None):
        if self.controller is None or "expert_load" not in metrics:
            return
        self.controller.step(
            float(self.iteration), self._gate_inputs(metrics),
            metrics["expert_load"], token_mask=token_mask)

    # ------------------------------------------------------------ prefill

    def prefill_request(self, prompt, collect: bool | None = None,
                        sampling: SamplingParams | None = None,
                        rid: int = 0):
        """Prefill ONE request (B=1) into a fresh cache, right-padded to
        a power-of-two bucket (pad tokens sit after the prompt so causal
        attention never sees them and the masked metrics ignore them;
        pad rows DO occupy MoE capacity, as in the reference). With a
        session expert runtime the MoE sublayers run through the EP slot
        data plane, as the batched step does. The first output token is
        sampled under `sampling` (the argmax when None or temperature
        <= 0) from the last prompt position.
        Returns (first_token, cache, prompt_len, metrics, token_mask)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = int(prompt.shape[0])
        if not 0 < plen <= self.max_len:
            raise ValueError(f"prompt length {plen} outside "
                             f"(0, {self.max_len}]")
        toks = prompt
        bucket = min(self.max_len, max(8, 1 << (plen - 1).bit_length()))
        if bucket > plen:
            toks = np.pad(prompt, (0, bucket - plen))
        mask = np.arange(toks.shape[0]) < plen
        collect = self._collect if collect is None else collect
        cache = self.new_cache(1)
        batch = {"tokens": torch.from_numpy(toks[None].astype(np.int64))
                 .to(self.device),
                 "token_mask": torch.from_numpy(mask[None]).to(self.device)}
        s = sampling or SamplingParams()
        dev = self.device
        samp = None if s.temperature <= 0 else (
            torch.tensor([s.temperature], dtype=torch.float32, device=dev),
            torch.tensor([s.top_k], dtype=torch.int32, device=dev),
            torch.tensor([s.top_p], dtype=torch.float32, device=dev),
            torch.tensor([s.effective_seed(rid) & prng.MASK], device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
        logits, cache, metrics = self._step(batch, cache, 0, collect,
                                            ep=self._ep(self._session))
        if samp is None:        # greedy: the argmax path
            first_tok = int(torch.argmax(logits[0, plen - 1]))
        else:
            first_tok = int(T.sample_tokens(logits[:1, plen - 1], *samp)[0])
        return first_tok, cache, plen, metrics, \
            batch["token_mask"].reshape(-1)

    # ------------------------------------------------- request-level API

    def start(self, *, num_slots: int = 8, eos_id=None,
              control: ControlPlane | None = None,
              time_scale: float = 1.0) -> None:
        """Open a serving session (slot pool + scheduler + clock). The
        serving clock starts at t=0 and advances by the modeled iteration
        latency when a `control` plane is attached, else by measured wall
        time; `time_scale` multiplies the advance. With
        ``expert_runtime="on"`` the session's runtime is built for
        `control` and bootstrapped here."""
        runtime = None
        if self.expert_runtime == "on":
            if control is None:
                raise ValueError(
                    "expert_runtime='on' needs a session control plane — "
                    "the runtime executes ITS replica plans")
            from repro_torch.serving.expert_runtime import ExpertRuntime
            runtime = ExpertRuntime.for_control(
                self.cfg, self.params, control, telemetry=self.telemetry,
                track=f"{self.name}/runtime",
                double_buffer=self.runtime_double_buffer)
            runtime.bootstrap(control)
        with self._lock:
            self._session = _Session(self.cfg, self.params, num_slots,
                                     self.max_len, eos_id, control,
                                     time_scale, self.serving,
                                     runtime=runtime)

    def close(self) -> None:
        with self._lock:
            self._session = None

    @property
    def _sess(self) -> _Session:
        if self._session is None:
            self.start()
        return self._session

    @property
    def has_work(self) -> bool:
        """True while the open session has pending or running requests."""
        sess = self._session
        return sess is not None and not sess.sched.done

    # ------------------------------------------------- step-loop hooks

    def add_step_hook(self, fn: Callable) -> None:
        """Register ``fn(events: list[TokenEvent])`` to run after every
        ``step`` (still under the engine lock)."""
        self._step_hooks.append(fn)

    def remove_step_hook(self, fn: Callable) -> None:
        self._step_hooks.remove(fn)

    def submit(self, req: GenRequest) -> RequestHandle:
        """Enqueue one request into the running session (opened with
        defaults if needed). A NaN arrival means "now". Returns a handle
        whose status is `rejected` if the request cannot ever fit a KV
        slot (admission control). Thread-safe."""
        with self._lock:
            sess = self._sess
            if math.isnan(req.arrival):
                req.arrival = sess.now
            ok = sess.sched.submit(req)
            tel = self.telemetry
            if tel.enabled:
                if ok:
                    tel.sched_pending.set(len(sess.sched.pending))
                else:
                    tel.sched_rejected.labels(reason="capacity").inc()
            return RequestHandle(req, self, _rejected=not ok)

    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel a queued or mid-decode request; a running request's KV
        slot is recycled immediately. Returns False if the request had
        already finished (or the session is gone). Thread-safe."""
        with self._lock:
            sess = self._session
            if sess is None:
                return False
            ok = sess.sched.cancel(handle.req, sess.now)
            tel = self.telemetry
            if ok and tel.enabled:
                tel.sched_cancelled.inc()
                self._marks.pop(handle.req.rid, None)
                tel.instant(f"{self.name}/req{handle.req.rid}", "cancel",
                            sess.now)
            return ok

    def step(self) -> list[TokenEvent]:
        """ONE serving iteration: admit every arrived request that fits a
        free slot (each prefilled alone, spliced into the pool), then run
        one batched decode step over the whole pool. Returns the tokens
        generated this iteration. A no-op on a closed session.
        Thread-safe; registered step hooks fire before the lock drops."""
        with self._lock:
            if self._session is None:
                return []
            events = self._step_impl()
            for fn in list(self._step_hooks):
                fn(events)
            return events

    def _step_impl(self) -> list[TokenEvent]:
        sess = self._sess
        sched, kv = sess.sched, sess.kv
        events: list[TokenEvent] = []
        if sched.done:
            return events
        if not sched.running:
            nxt = sched.next_arrival()
            if nxt is not None:
                sess.now = max(sess.now, nxt)
        collect = self._collect
        tel = self.telemetry
        if self.serving.prefill_chunk > 0:
            return self._step_chunked(sess, collect, events)
        # admission: prefill every arrived request that fits a slot
        while (req := sched.pop_admissible(sess.now)) is not None:
            t0 = time.perf_counter()
            t_admit = sess.now
            tok, cache1, plen, metrics, mask = self.prefill_request(
                req.prompt, collect=collect, sampling=req.sampling,
                rid=req.rid)
            dt = None
            if sess.control is not None and "expert_load" in metrics:
                out = sess.control.step(
                    sess.now, self._gate_inputs(metrics),
                    metrics["expert_load"], token_mask=mask,
                    dropped=metrics.get("dropped"), phase="prefill")
                dt = out.latency_s
                if sess.runtime is not None:
                    sess.runtime.apply(sess.now, out.events,
                                       phase="prefill",
                                       compute_s=out.latency_s)
            self._drive_controller(metrics, token_mask=mask)
            if dt is None:
                dt = time.perf_counter() - t0
            slot = kv.alloc()
            kv.insert(slot, cache1, plen, owner=req.rid)
            sess.bind_slot(slot, req)
            sched.start(req, slot, sess.now)
            sess.now += dt * sess.time_scale
            sess.prefills += 1
            sess.cur[slot] = tok
            sess.count[slot] = 1
            done = sched.on_token(slot, tok, sess.now)  # TTFT: prefill end
            events.append(TokenEvent(req.rid, tok, done))
            if tel.enabled:
                tel.sched_admitted.inc()
                tel.sched_queue_delay.observe(
                    max(t_admit - req.arrival, 0.0))
                tel.engine_steps.labels(phase="prefill").inc()
                tel.engine_step_seconds.labels(phase="prefill").observe(
                    time.perf_counter() - t0)
                tel.engine_tokens.inc()
                if tel.tracing:
                    track = f"{self.name}/req{req.rid}"
                    tel.span(track, "queue", req.arrival, t_admit)
                    tel.span(track, "prefill", t_admit, sess.now,
                             args={"prompt_len": plen,
                                   "prefix_hit_len": req.prefix_hit_len})
                    self._marks[req.rid] = sess.now
                if done:
                    self._finish_req(req, sess.now)
        if tel.enabled:
            tel.sched_pending.set(len(sched.pending))
        if not sched.running:
            return events
        # one batched decode step over the whole pool, then one sampling
        # call (or, all greedy, one argmax) over every slot; the sampling
        # arrays go to the device before the model call is enqueued
        t0 = time.perf_counter()
        t_clock0 = sess.now
        tokens = torch.from_numpy(sess.cur[:, None].copy()).to(self.device)
        if isinstance(kv, PagedKVCache):
            lengths, active, tables = kv.step_state()
            batch = {"tokens": tokens, "active": active,
                     "block_tables": tables,
                     "new_counts": active.to(torch.int32)}
        else:
            lengths, active = kv.step_lengths()
            batch = {"tokens": tokens, "active": active}
        samp = sess.sampling_args(self.device) if sess.sampling() else None
        # with the runtime on, the KV pool's pad rows (none at one rank)
        # are capacity-neutral
        logits, kv.cache, metrics = self._step(
            batch, kv.cache, lengths, collect,
            ep=self._ep(sess, kv.rows - kv.num_slots))
        t_sync = time.perf_counter()
        toks = (T.sample_tokens(logits[:, -1], *samp) if samp is not None
                else torch.argmax(logits[:, -1], dim=-1)).cpu().numpy()
        sync_s = time.perf_counter() - t_sync   # device->host token fetch
        dt = None
        if sess.control is not None and "expert_load" in metrics:
            out = sess.control.step(
                sess.now, self._gate_inputs(metrics),
                metrics["expert_load"], token_mask=active,
                dropped=metrics.get("dropped"), phase="decode")
            dt = out.latency_s
            if sess.runtime is not None:
                sess.runtime.apply(sess.now, out.events, phase="decode",
                                   compute_s=out.latency_s)
        self._drive_controller(metrics, token_mask=active)
        if dt is None:
            dt = time.perf_counter() - t0
        sess.now += dt * sess.time_scale
        sess.iters += 1
        self.iteration += 1
        n_active = len(sched.running)
        sess.occupancy.append(n_active)
        if tel.enabled:
            tel.engine_steps.labels(phase="decode").inc()
            tel.engine_step_seconds.labels(phase="decode").observe(
                time.perf_counter() - t0)
            tel.engine_host_sync.observe(sync_s)
            tel.engine_occupancy.set(n_active)
            tel.engine_tokens.inc(n_active)
            if tel.tracing:
                tel.span(self.name, "decode_step", t_clock0, sess.now,
                         args={"occupancy": n_active})
        capped = set(kv.advance())
        for slot in list(sched.running):
            tok = int(toks[slot])
            sess.cur[slot] = tok
            sess.count[slot] += 1
            req = sched.running[slot]
            done = sched.on_token(slot, tok, sess.now)
            if not done and slot in capped:
                # KV ring at capacity: one more decode would overwrite
                # live cache — finish with reason "length"
                sched.force_finish(slot, sess.now)
                done = True
            events.append(TokenEvent(req.rid, tok, done))
            if done and tel.enabled:
                self._finish_req(req, sess.now)
        if tel.enabled and isinstance(kv, PagedKVCache):
            tel.kv_blocks_used.set(kv.used_blocks)
            tel.kv_blocks_free.set(kv.free_blocks)
        return events

    def _step_chunked(self, sess, collect, events) -> list[TokenEvent]:
        """Chunked-prefill iteration (paged KV only): admission is table
        work alone — ``kv.begin`` matches the prefix cache, refcount-
        shares the matched blocks, and reserves the rest; NO solo model
        call. Each mid-prefill slot then contributes up to
        ``prefill_chunk`` prompt tokens per iteration to the SAME
        batched step the decoding slots run, as extra masked lanes — the
        decode batch never stalls behind a long prompt. A slot's first
        output token is taken from the logits of its final prompt
        position in the step its last chunk lands."""
        sched, kv = sess.sched, sess.kv
        tel = self.telemetry
        chunk = self.serving.prefill_chunk
        while (req := sched.pop_admissible(sess.now)) is not None:
            slot = kv.alloc()
            hit = kv.begin(slot, req.prompt, req.max_new_tokens,
                           owner=req.rid)
            req.prefix_hit_len = hit
            sess.bind_slot(slot, req)
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            sess.prompts[slot] = prompt
            sess.plen[slot] = prompt.shape[0]
            sched.start(req, slot, sess.now)
            sess.prefills += 1
            if tel.enabled:
                tel.sched_admitted.inc()
                tel.sched_queue_delay.observe(
                    max(sess.now - req.arrival, 0.0))
                if hit:
                    tel.kv_prefix_hits.inc()
                    tel.kv_prefix_tokens_saved.inc(hit)
                cow = kv.cow_blocks - sess.cow_seen
                if cow:
                    tel.kv_cow_copies.inc(cow)
                if tel.tracing:
                    tel.span(f"{self.name}/req{req.rid}", "queue",
                             req.arrival, sess.now,
                             args={"prefix_hit_len": hit})
            sess.cow_seen = kv.cow_blocks
        if tel.enabled:
            tel.sched_pending.set(len(sched.pending))
        if not sched.running:
            return events
        t0 = time.perf_counter()
        t_clock0 = sess.now
        rows = kv.rows
        counts = np.zeros(rows, np.int32)
        first_rows: set[int] = set()   # prompt completes this step
        any_prefill = False
        for slot in sched.running:
            left = int(sess.plen[slot]) - int(kv.lengths[slot])
            if left > 0:
                any_prefill = True
                counts[slot] = min(chunk, left)
                if counts[slot] == left:
                    first_rows.add(slot)
            else:
                counts[slot] = 1
        s_new = chunk if any_prefill else 1
        tokens = np.zeros((rows, s_new), np.int64)
        for slot in sched.running:
            c = int(counts[slot])
            pos = int(kv.lengths[slot])
            if pos < sess.plen[slot]:
                tokens[slot, :c] = sess.prompts[slot][pos:pos + c]
            else:
                tokens[slot, 0] = sess.cur[slot]
        lengths, active, tables = kv.step_state()
        counts_t = torch.from_numpy(counts).to(self.device)
        mask = torch.arange(s_new, dtype=torch.int32,
                            device=self.device)[None] < counts_t[:, None]
        batch = {"tokens": torch.from_numpy(tokens).to(self.device),
                 "active": active, "token_mask": mask,
                 "block_tables": tables, "new_counts": counts_t}
        samp = sess.sampling_args(self.device) if sess.sampling() else None
        phase = "mixed" if any_prefill else "decode"
        logits, kv.cache, metrics = self._step(
            batch, kv.cache, lengths, collect,
            ep=self._ep(sess, kv.rows - kv.num_slots))
        t_sync = time.perf_counter()
        # each row's next-token logits sit at its LAST written position
        idx = (counts_t - 1).clamp(min=0).long()
        last = logits[torch.arange(rows, device=self.device), idx]
        toks = (T.sample_tokens(last, *samp) if samp is not None
                else torch.argmax(last, dim=-1)).cpu().numpy()
        sync_s = time.perf_counter() - t_sync
        dt = None
        if sess.control is not None and "expert_load" in metrics:
            out = sess.control.step(
                sess.now, self._gate_inputs(metrics),
                metrics["expert_load"], token_mask=mask.reshape(-1),
                dropped=metrics.get("dropped"), phase=phase)
            dt = out.latency_s
            if sess.runtime is not None:
                sess.runtime.apply(sess.now, out.events, phase=phase,
                                   compute_s=out.latency_s)
        self._drive_controller(metrics, token_mask=mask.reshape(-1))
        if dt is None:
            dt = time.perf_counter() - t0
        sess.now += dt * sess.time_scale
        sess.iters += 1
        self.iteration += 1
        n_active = len(sched.running)
        sess.occupancy.append(n_active)
        if tel.enabled:
            tel.engine_steps.labels(phase=phase).inc()
            tel.engine_step_seconds.labels(phase=phase).observe(
                time.perf_counter() - t0)
            tel.engine_host_sync.observe(sync_s)
            tel.engine_occupancy.set(n_active)
            if tel.tracing:
                tel.span(self.name, "decode_step", t_clock0, sess.now,
                         args={"occupancy": n_active, "phase": phase})
        capped = set(kv.advance(counts))
        emitted = 0
        for slot in list(sched.running):
            req = sched.running[slot]
            if kv.lengths[slot] < sess.plen[slot]:
                continue                 # still mid-prefill: no token yet
            if slot in first_rows:
                sess.count[slot] = 1     # the request's first token
            else:
                sess.count[slot] += 1
            tok = int(toks[slot])
            sess.cur[slot] = tok
            emitted += 1
            done = sched.on_token(slot, tok, sess.now)  # TTFT on first
            if not done and slot in capped:
                sched.force_finish(slot, sess.now)
                done = True
            events.append(TokenEvent(req.rid, tok, done))
            if tel.enabled and tel.tracing and slot in first_rows:
                tel.span(f"{self.name}/req{req.rid}", "prefill",
                         req.t_admitted, sess.now,
                         args={"prompt_len": int(sess.plen[slot]),
                               "prefix_hit_len": req.prefix_hit_len})
                self._marks[req.rid] = sess.now
            if done and tel.enabled:
                self._finish_req(req, sess.now)
        if tel.enabled:
            tel.engine_tokens.inc(emitted)
            tel.kv_blocks_used.set(kv.used_blocks)
            tel.kv_blocks_free.set(kv.free_blocks)
        return events

    def _finish_req(self, req: GenRequest, t: float) -> None:
        """Record one request's terminal telemetry."""
        tel = self.telemetry
        tel.sched_finished.labels(reason=req.finish_reason or "done").inc()
        if tel.tracing:
            track = f"{self.name}/req{req.rid}"
            tel.span(track, "decode", self._marks.pop(req.rid, t), t)
            tel.instant(track, "finish", t,
                        args={"reason": req.finish_reason,
                              "out_tokens": len(req.tokens)})

    def stream(self, handle: RequestHandle) -> Iterator[int]:
        """Incrementally yield `handle`'s tokens, driving ``step`` while
        the request still has work in flight."""
        sent = 0
        while True:
            toks = handle.req.tokens
            while sent < len(toks):
                yield toks[sent]
                sent += 1
            if handle.status in ("finished", "cancelled", "rejected"):
                return
            if self._session is None or self._session.sched.done:
                return
            self.step()

    def run(self, *, verbose: bool = False) -> ServeResult:
        """Drive ``step`` until the session has no pending or running
        requests, then snapshot the session's metrics."""
        sess = self._sess
        while not sess.sched.done:
            self.step()
            if verbose and sess.iters % 50 == 0:
                print(f"  t={sess.now:8.2f}s iter={sess.iters} "
                      f"active={len(sess.sched.running)} "
                      f"pending={len(sess.sched.pending)} "
                      f"done={len(sess.sched.finished)}")
        return self.result()

    def result(self) -> ServeResult:
        if self._session is None:
            raise RuntimeError("no serving session — call start() / "
                               "serve() first")
        sess = self._session
        return ServeResult(
            records=sess.sched.metrics(), iterations=sess.iters,
            prefills=sess.prefills, rejected=len(sess.sched.rejected),
            cancelled=len(sess.sched.cancelled),
            mean_batch_occupancy=float(np.mean(sess.occupancy))
            if sess.occupancy else 0.0,
            wall_s=time.perf_counter() - sess.wall0, control=sess.control,
            runtime=sess.runtime, clock_s=sess.now,
            dropped_tokens=float(getattr(sess.control, "dropped_tokens",
                                         0.0) or 0.0))

    def serve(self, requests, *, num_slots: int = 8, eos_id=None,
              control: ControlPlane | None = None,
              time_scale: float = 1.0,
              verbose: bool = False) -> ServeResult:
        """Continuous-batching replay of `requests` (list[GenRequest]) —
        open a session, submit everything, run to completion."""
        self.start(num_slots=num_slots, eos_id=eos_id, control=control,
                   time_scale=time_scale)
        for r in sorted(requests, key=lambda r: r.arrival):
            self.submit(r)
        res = self.run(verbose=verbose)
        self.close()
        return res

    @staticmethod
    def _gate_inputs(metrics):
        gi = metrics.get("gate_input")
        if gi is None:
            return None
        return gi.reshape(gi.shape[0], -1, gi.shape[-1])
