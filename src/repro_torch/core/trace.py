"""Workload generation: Azure-LLM-trace-like request arrivals (paper §2.3,
Fig. 3) and intrinsically-skewed per-layer expert routing distributions
(Fig. 1).

The paper replays Azure traces over LMSYS-Chat-1M / ShareGPT prompts and
batches requests per second. We generate statistically matched synthetic
traces offline (no dataset downloads in this container): non-homogeneous
Poisson arrivals with a noon peak + bursts, lognormal prompt/output
lengths, and per-layer Zipf-skewed expert popularity with temporal drift
(the drift is what defeats EPLB's periodic historical rebalance).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class Request:
    arrival: float
    in_tokens: int
    out_tokens: int


@dataclass(frozen=True)
class TraceConfig:
    duration_s: float = 120.0
    base_rate: float = 6.0            # requests / s at peak
    seed: int = 0
    mean_in_tokens: float = 220.0     # ShareGPT-like prompt lengths
    mean_out_tokens: float = 130.0
    burstiness: float = 0.35


def generate_requests(tc: TraceConfig) -> list[Request]:
    rng = np.random.default_rng(tc.seed)
    reqs = []
    t = 0.0
    while t < tc.duration_s:
        # diurnal-peak modulation (we replay the noon peak, paper Fig. 3a)
        mod = 0.75 + 0.25 * np.sin(2 * np.pi * t / tc.duration_s)
        burst = 1.0 + tc.burstiness * rng.standard_normal()
        rate = max(0.2, tc.base_rate * mod * burst)
        t += rng.exponential(1.0 / rate)
        if t >= tc.duration_s:
            break
        in_t = int(np.clip(rng.lognormal(np.log(tc.mean_in_tokens), 0.9),
                           4, 8192))
        out_t = int(np.clip(rng.lognormal(np.log(tc.mean_out_tokens), 0.8),
                            1, 2048))
        reqs.append(Request(t, in_t, out_t))
    return reqs


@dataclass
class BatchIteration:
    """One serving iteration (1-second continuous-batch emulation, §6.1):
    aggregate token load W plus which stage dominates."""
    t: float
    tokens: int
    prefill_tokens: int
    decode_tokens: int


def batch_iterations(reqs: list[Request], duration_s: float,
                     decode_tps: float = 30.0) -> list[BatchIteration]:
    """Aggregate requests into per-second batches; a request contributes
    its prompt tokens in its arrival second (prefill) and ~decode_tps
    tokens/s for out_tokens/decode_tps subsequent seconds (decode)."""
    n = int(np.ceil(duration_s))
    pre = np.zeros(n)
    dec = np.zeros(n)
    for r in reqs:
        s = int(r.arrival)
        if s < n:
            pre[s] += r.in_tokens
        dur = max(1, int(np.ceil(r.out_tokens / decode_tps)))
        for k in range(dur):
            if s + 1 + k < n:
                dec[s + 1 + k] += min(decode_tps, r.out_tokens
                                      - k * decode_tps)
    out = []
    for s in range(n):
        tok = int(pre[s] + dec[s])
        if tok > 0:
            out.append(BatchIteration(float(s), tok, int(pre[s]),
                                      int(dec[s])))
    return out


@dataclass
class ExpertLoadProcess:
    """Per-layer skewed expert popularity with temporal drift (Fig. 1/3c).

    popularity_l ~ normalised Zipf(z) under a per-layer random permutation;
    at time t it is perturbed by a slow Ornstein-Uhlenbeck log-drift, so
    hot experts change identity over minutes — the regime where a
    fixed-window balancer (EPLB) goes stale but per-iteration prediction
    (MoEless) tracks.
    """
    num_layers: int
    num_experts: int
    top_k: int
    zipf: float = 1.1
    drift_sigma: float = 0.35
    drift_tau_s: float = 30.0
    seed: int = 0
    _state: np.ndarray = field(init=False, default=None)
    _base: np.ndarray = field(init=False, default=None)
    _last_t: float = field(init=False, default=0.0)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = 1.0 / np.arange(1, self.num_experts + 1) ** self.zipf
        self._base = np.stack([rng.permutation(ranks)
                               for _ in range(self.num_layers)])
        self._base /= self._base.sum(-1, keepdims=True)
        self._state = np.zeros((self.num_layers, self.num_experts))
        self.rng = rng

    def popularity(self, t: float) -> np.ndarray:
        dt = max(0.0, t - self._last_t)
        self._last_t = t
        if dt > 0:
            a = np.exp(-dt / self.drift_tau_s)
            noise = self.rng.standard_normal(self._state.shape)
            self._state = a * self._state + \
                np.sqrt(1 - a * a) * self.drift_sigma * noise
        p = self._base * np.exp(self._state)
        return p / p.sum(-1, keepdims=True)

    def loads(self, t: float, tokens: int) -> np.ndarray:
        """Actual expert loads W_{l,e} for a batch: (L, E) token counts
        (each token picks top_k experts)."""
        p = self.popularity(t)
        draws = tokens * self.top_k
        return np.stack([self.rng.multinomial(draws, p[l])
                         for l in range(self.num_layers)])
