"""Continuous-batching request scheduler (paper §2.3 / §6.1).

Requests arrive on a trace timeline (or are submitted live through
``ServingEngine.submit``), wait in an arrival-ordered queue, and are
admitted into the running batch as KV slots free up: a request is
prefilled alone, spliced into the slot pool, and from the next iteration
decodes together with everything already in flight; it leaves the batch
on EOS, a stop-token sequence, its token budget, or client cancellation
— and its slot is recycled immediately. Per-request TTFT / TPOT / E2E
latencies are recorded against the serving clock the engine advances.

Each request carries frozen ``SamplingParams`` (temperature / top-k /
top-p / seed / stop sequences / priority); admission among arrived
requests is by priority (FCFS within a priority level).

The scheduler is pure bookkeeping — model execution lives in
``repro_torch.serving.engine``; slot memory in ``repro_torch.serving.kv``.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class SamplingValidationError(ValueError):
    """An invalid ``SamplingParams`` field, carrying the field name and
    offending value so API layers (the serving gateway) can map the
    rejection to a structured HTTP 400 body
    (``{"error": {"param": ..., "message": ...}}``) instead of parsing
    free-form text."""

    def __init__(self, param: str, value, message: str):
        self.param = param
        self.value = value
        self.message = message
        super().__init__(f"{param}={value!r}: {message}")


@dataclass(frozen=True)
class SamplingParams:
    """Frozen per-request decoding parameters.

    temperature <= 0 selects greedy argmax (bit-identical to the
    pre-sampling engine); top_k <= 0 and top_p >= 1 disable the
    respective filters. `seed` keys the request's sample stream (None =>
    derived from the request id, still deterministic across runs).
    `stop` is a tuple of stop-token sequences — generation ends when the
    output's tail matches any of them (the stop tokens are kept in the
    output). Higher `priority` wins admission among arrived requests."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    stop: tuple = ()               # tuple[tuple[int, ...], ...]
    priority: int = 0

    def __post_init__(self):
        if not math.isfinite(self.temperature):
            raise SamplingValidationError(
                "temperature", self.temperature,
                "temperature must be finite (<= 0 selects greedy argmax)")
        if not math.isfinite(self.top_p) or self.top_p <= 0:
            raise SamplingValidationError(
                "top_p", self.top_p,
                "top_p masks every token (the nucleus is empty); use "
                "top_p=1.0 to disable the filter")
        # normalise stop sequences to hashable int tuples; reject empties
        try:
            stop = tuple(tuple(int(t) for t in s) for s in self.stop)
        except (TypeError, ValueError):
            raise SamplingValidationError(
                "stop", self.stop,
                "stop must be a sequence of token-id sequences") from None
        if any(len(s) == 0 for s in stop):
            raise SamplingValidationError(
                "stop", self.stop, "empty stop sequence")
        object.__setattr__(self, "stop", stop)

    def effective_seed(self, rid: int) -> int:
        return int(self.seed) if self.seed is not None else int(rid)


GREEDY = SamplingParams()


@dataclass
class GenRequest:
    """One generation request on the trace timeline."""
    rid: int
    arrival: float
    prompt: np.ndarray                 # (prompt_len,) int token ids
    max_new_tokens: int
    sampling: SamplingParams = field(default_factory=SamplingParams)
    # runtime state, filled by the scheduler
    slot: int = -1
    tokens: list = field(default_factory=list)      # generated ids
    t_admitted: float = math.nan
    t_first_token: float = math.nan
    t_finish: float = math.nan
    finish_reason: str = ""    # length | eos | stop | cancelled | replica_failed
    reject_reason: str = ""    # structured admission-reject detail
    prefix_hit_len: int = 0    # prompt tokens served by the prefix cache

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[0])


@dataclass(frozen=True)
class RequestMetrics:
    """Per-request serving latencies (all in scheduler-clock seconds)."""
    rid: int
    arrival: float
    in_tokens: int
    out_tokens: int
    ttft: float                        # first token - arrival (incl. queue)
    tpot: float                        # mean time per subsequent token
    e2e: float                         # finish - arrival

    @classmethod
    def of(cls, r: GenRequest) -> "RequestMetrics":
        n = len(r.tokens)
        tpot = ((r.t_finish - r.t_first_token) / (n - 1)) if n > 1 else 0.0
        return cls(rid=r.rid, arrival=r.arrival, in_tokens=r.prompt_len,
                   out_tokens=n, ttft=r.t_first_token - r.arrival,
                   tpot=tpot, e2e=r.t_finish - r.arrival)


def percentile_summary(records: list[RequestMetrics]) -> dict:
    """{metric: {count, mean, p50, p95, p99}} over finished requests.

    TPOT is a per-*subsequent*-token latency, undefined for single-token
    requests — those are excluded from the TPOT statistics (they would
    enter as 0.0 and drag the mean/p50 down) but still count toward
    TTFT and E2E. Empty record sets yield all-zero entries (with
    ``count`` 0) so callers can always read every key."""
    out = {}
    for m in ("ttft", "tpot", "e2e"):
        rs = records if m != "tpot" else \
            [r for r in records if r.out_tokens > 1]
        xs = np.asarray([getattr(r, m) for r in rs], np.float64)
        if xs.size == 0:
            out[m] = {"count": 0, "mean": 0.0,
                      "p50": 0.0, "p95": 0.0, "p99": 0.0}
        else:
            out[m] = {"count": int(xs.size),
                      "mean": float(xs.mean()),
                      "p50": float(np.percentile(xs, 50)),
                      "p95": float(np.percentile(xs, 95)),
                      "p99": float(np.percentile(xs, 99))}
    return out


class ContinuousBatchingScheduler:
    """Arrival queue + admission control over a ``SlotKVCache``.

    Admission is heap-based: a deep gateway backlog admits in
    O(log n) per pop instead of the old O(n) scan per free slot per
    step (O(n²) under backlog). Pending requests live in two
    lazily-cleaned heaps — ``_waiting`` ordered by (arrival, seq) for
    requests that have not arrived yet, and ``_ready`` ordered by
    (-priority, arrival, seq) for arrived requests — so the admission
    order is EXACTLY the old semantics: highest priority first, FCFS
    (arrival, then submission order) within a priority level.
    Cancellation just drops the request from the live set; stale heap
    entries are skipped on the next peek."""

    def __init__(self, kv, *, eos_id: int | None = None):
        self.kv = kv
        self.eos_id = eos_id
        self._seq = 0                                # submission tiebreak
        self._keys: dict[int, tuple] = {}            # id(req) -> sort key
        self._live: dict[int, GenRequest] = {}       # id(req) -> pending
        self._waiting: list[tuple] = []              # (arrival, seq, req)
        self._ready: list[tuple] = []                # (-prio, arr, seq, req)
        self._ready_arrivals: list[tuple] = []       # (arrival, seq, req)
        self.running: dict[int, GenRequest] = {}     # slot -> request
        self.finished: list[GenRequest] = []
        self.cancelled: list[GenRequest] = []
        self.rejected: list[GenRequest] = []

    @property
    def pending(self) -> list[GenRequest]:
        """Pending requests in (arrival, submission) order — a sorted
        VIEW for introspection and tests; admission pops the heaps."""
        return sorted(self._live.values(),
                      key=lambda r: self._keys[id(r)])

    @property
    def num_pending(self) -> int:
        """O(1) pending depth — the gateway's backpressure signal."""
        return len(self._live)

    # --------------------------------------------------------- admission

    def submit(self, req: GenRequest) -> bool:
        """Admission control: a request must fit its prompt plus token
        budget inside one slot's ring buffer — and, on a paged pool,
        inside the whole block pool (``kv.admission_error``). Returns
        False on reject, with ``req.reject_reason`` naming exactly what
        didn't fit (tokens-needed vs blocks-available) so the gateway can
        emit a structured 4xx body instead of a mid-step crash."""
        reason = ""
        if req.prompt_len == 0:
            reason = "empty prompt"
        elif req.max_new_tokens < 1:
            reason = f"max_new_tokens={req.max_new_tokens} must be >= 1"
        elif req.prompt_len + req.max_new_tokens > self.kv.max_len:
            reason = (f"needs {req.prompt_len + req.max_new_tokens} KV "
                      f"tokens, a slot holds max_len={self.kv.max_len}")
        else:
            check = getattr(self.kv, "admission_error", None)
            if check is not None:
                reason = check(req.prompt_len, req.max_new_tokens)
        if reason:
            req.reject_reason = reason
            self.rejected.append(req)
            return False
        key = (req.arrival, self._seq)
        self._seq += 1
        self._keys[id(req)] = key
        self._live[id(req)] = req
        heapq.heappush(self._waiting, (req.arrival, self._seq - 1, req))
        return True

    def _peek(self, heap: list) -> tuple | None:
        """Head of `heap`, lazily discarding entries whose request has
        left the pending set (popped for admission, or cancelled)."""
        while heap and self._live.get(id(heap[0][-1])) is not heap[0][-1]:
            heapq.heappop(heap)
        return heap[0] if heap else None

    def next_arrival(self) -> float | None:
        """Earliest arrival among pending requests (None if empty)."""
        heads = (self._peek(self._waiting),
                 self._peek(self._ready_arrivals))
        arrivals = [e[0] for e in heads if e is not None]
        return min(arrivals) if arrivals else None

    def pop_admissible(self, now: float) -> GenRequest | None:
        """Highest-priority request that has arrived by `now`, if a slot
        is free; FCFS within a priority level. O(log n) amortised."""
        if not self._live or self.kv.num_free == 0:
            return None
        # release everything that has arrived into the priority heap
        while (head := self._peek(self._waiting)) is not None \
                and head[0] <= now:
            arrival, seq, req = heapq.heappop(self._waiting)
            heapq.heappush(self._ready,
                           (-req.sampling.priority, arrival, seq, req))
            heapq.heappush(self._ready_arrivals, (arrival, seq, req))
        head = self._peek(self._ready)
        if head is None:
            return None
        req = head[-1]
        # paged pool: the head must also fit its block footprint RIGHT
        # NOW (free + prefix-evictable blocks). Head-of-line blocking is
        # deliberate — skipping ahead would break the FCFS/priority
        # admission order the latency metrics are defined over.
        can_admit = getattr(self.kv, "can_admit", None)
        if can_admit is not None and not can_admit(
                req.prompt_len, req.max_new_tokens, req.prompt):
            return None
        heapq.heappop(self._ready)
        del self._keys[id(req)]
        del self._live[id(req)]
        return req

    def queue_delay(self, now: float) -> float:
        """Age of the oldest pending request at `now` (0.0 when nothing
        is waiting) — the gateway autoscaler's scale-up signal."""
        nxt = self.next_arrival()
        return max(0.0, now - nxt) if nxt is not None else 0.0

    def outstanding_tokens(self) -> int:
        """Token budget still owed to pending + running requests — the
        router's least-outstanding-tokens load signal."""
        owed = sum(r.max_new_tokens for r in self._live.values())
        owed += sum(max(r.max_new_tokens - len(r.tokens), 0)
                    for r in self.running.values())
        return owed

    def start(self, req: GenRequest, slot: int, now: float) -> None:
        """Bind a freshly-prefilled request to its slot: it joins the
        running batch at the next decode iteration."""
        req.slot = slot
        req.t_admitted = now
        self.running[slot] = req

    # --------------------------------------------------------- progress

    def _stop_hit(self, req: GenRequest) -> bool:
        for s in req.sampling.stop:
            if len(req.tokens) >= len(s) \
                    and tuple(req.tokens[-len(s):]) == s:
                return True
        return False

    def on_token(self, slot: int, token: int, now: float) -> bool:
        """Record one generated token for the request in `slot`; returns
        True (and recycles the slot) when the request finishes."""
        req = self.running[slot]
        if not req.tokens:
            req.t_first_token = now
        req.tokens.append(int(token))
        if self.eos_id is not None and int(token) == self.eos_id:
            req.finish_reason = "eos"
        elif self._stop_hit(req):
            req.finish_reason = "stop"
        elif len(req.tokens) >= req.max_new_tokens:
            req.finish_reason = "length"
        else:
            return False
        req.t_finish = now
        del self.running[slot]
        self.kv.release(slot)
        self.finished.append(req)
        return True

    def force_finish(self, slot: int, now: float, *,
                     reason: str = "length") -> GenRequest | None:
        """Finish the request in `slot` immediately (KV ring/blocks at
        capacity — continuing would overwrite live cache). The tokens
        already recorded stand; the slot is recycled like a normal
        finish. Returns the request, or None if the slot is idle."""
        req = self.running.pop(slot, None)
        if req is None:
            return None
        req.finish_reason = reason
        req.t_finish = now
        if math.isnan(req.t_first_token):
            req.t_first_token = now
        self.kv.release(slot)
        self.finished.append(req)
        return req

    def cancel(self, req: GenRequest, now: float, *,
               reason: str = "cancelled") -> bool:
        """Client-side cancellation: a pending request leaves the queue;
        a running request releases its KV slot immediately (mid-decode —
        the freed slot admits the next pending arrival on the very next
        iteration). Returns False if the request already left. `reason`
        distinguishes a deliberate cancel from a replica failure
        ("replica_failed") — either way the request lands in
        ``cancelled``."""
        if self._live.get(id(req)) is req:
            # remove by IDENTITY (dataclass __eq__ compares numpy prompt
            # arrays — ambiguous-truth crash); the heaps drop their now-
            # stale entries lazily on the next peek
            del self._live[id(req)]
            del self._keys[id(req)]
        elif req.slot in self.running \
                and self.running[req.slot] is req:
            del self.running[req.slot]
            self.kv.release(req.slot)
        else:
            return False
        req.finish_reason = reason
        req.t_finish = now
        self.cancelled.append(req)
        return True

    @property
    def done(self) -> bool:
        return not self._live and not self.running

    def metrics(self) -> list[RequestMetrics]:
        return [RequestMetrics.of(r) for r in self.finished]


@dataclass(frozen=True)
class ClipReport:
    """What ``requests_from_trace`` had to clip to fit the slot ring
    buffers: trace token counts are drawn for full-scale models, so smoke
    replays routinely truncate them. Surfaced by the drivers so silent
    clipping can't skew a benchmark unnoticed."""
    total: int = 0
    prompts_clipped: int = 0           # in_tokens > max_len // 2
    budgets_clipped: int = 0           # out_tokens cut (slot fit / cap)

    @property
    def any(self) -> bool:
        return bool(self.prompts_clipped or self.budgets_clipped)

    def __str__(self):
        return (f"{self.prompts_clipped}/{self.total} prompts and "
                f"{self.budgets_clipped}/{self.total} budgets clipped")


def requests_from_trace(trace_requests, vocab_size: int, *, max_len: int,
                        seed: int = 0, max_new_cap: int = 0,
                        sampling: SamplingParams = GREEDY,
                        ) -> tuple[list[GenRequest], ClipReport]:
    """Materialise ``core.trace.Request`` arrivals (which only carry token
    COUNTS) into concrete prompts for the real model, clipping each
    request to fit a slot; every request carries `sampling`.
    `max_new_cap` > 0 additionally caps per-request generation (keeps CPU
    replays bounded). Returns (requests, ClipReport) so callers see how
    much the trace was cut down."""
    rng = np.random.default_rng(seed)
    out = []
    p_clip = b_clip = 0
    for i, r in enumerate(trace_requests):
        in_t = int(min(r.in_tokens, max(1, max_len // 2)))
        out_t = int(min(r.out_tokens, max_len - in_t))
        if max_new_cap:
            out_t = min(out_t, max_new_cap)
        p_clip += in_t < r.in_tokens
        b_clip += max(1, out_t) < r.out_tokens
        prompt = rng.integers(0, vocab_size, size=in_t, dtype=np.int32)
        out.append(GenRequest(rid=i, arrival=float(r.arrival), prompt=prompt,
                              max_new_tokens=max(1, out_t),
                              sampling=sampling))
    return out, ClipReport(total=len(out), prompts_clipped=p_clip,
                           budgets_clipped=b_clip)
