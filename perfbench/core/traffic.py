"""The one traffic generator. A traffic mix is a JSON file of parameters
under ``perfbench/traffic/``; this module turns it and a seed into
requests: prompt and output lengths, token ids, and arrival offsets.

Every seed gets the same schedule: the same sizes and gaps in the same
order, so that two seeds differ in what the requests say, not in how
much work they are or when it comes. Requests come in blocks of
``block``: a block's prompt lengths are the ``block`` quantiles
(j + 1/2) / block of the prompt law, its output lengths those of the
output law, paired by a permutation, and, for open-loop arrivals, its
gaps the quantiles of the exponential law in another permutation; the
permutations are drawn from the mix's own ``schedule_seed``.

So open-loop arrivals are a stratified Poisson schedule, not Poisson
draws: within a block the gaps spread as a Poisson process's do, but
every block of ``block`` requests spans the same time, block / rate,
which leaves out the bursts that last longer than a block.

Token ids follow a Zipf law over a seed permutation of the vocabulary.
With ``topics`` > 1 each topic has its own permutation, a request draws
its topic from a Zipf law over the topics' popularity ranks, and the
ranking rotates by one every ``rotate_s`` seconds of arrival time.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist

import numpy as np

HERE = Path(__file__).resolve().parent.parent


@dataclass(frozen=True)
class Spec:
    """A traffic mix's parameters (``perfbench/traffic/<name>.json``)."""
    name: str
    arrivals: str            # "backlog" or "open_loop"
    prompt: dict             # {"median", "sigma", "min", "max"}
    output: dict
    tokens: dict             # {"exponent", "topics", "topic_exponent",
    #                           "rotate_s"}
    block: int = 64
    min_queued: int = 0      # backlog: requests kept waiting
    schedule_seed: int = 0   # the permutations of every block


def load(name: str) -> Spec:
    raw = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    return Spec(name=name, arrivals=raw["arrivals"]["kind"],
                prompt=raw["prompt"], output=raw["output"],
                tokens=raw["tokens"], block=raw.get("block", 64),
                min_queued=raw["arrivals"].get("min_queued", 0),
                schedule_seed=raw.get("schedule_seed", 0))


def lognormal_quantiles(law: dict, n: int) -> np.ndarray:
    """The n quantiles (j + 1/2) / n of a lognormal law given by its
    median and sigma, rounded and clipped to [min, max]."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((j + 0.5) / n) for j in range(n)])
    v = np.rint(law["median"] * np.exp(law["sigma"] * z))
    return np.clip(v, law["min"], law["max"]).astype(np.int64)


def exponential_quantiles(n: int) -> np.ndarray:
    """The n quantiles (j + 1/2) / n of the unit exponential law."""
    return -np.log1p(-(np.arange(n) + 0.5) / n)


class _Zipf:
    """Draws ids 0..n-1 by rank r (1-based) with probability ~ r^-s."""

    def __init__(self, n: int, s: float):
        w = np.arange(1, n + 1, dtype=np.float64) ** -s
        self.cdf = np.cumsum(w / w.sum())

    def draw(self, rng, size: int) -> np.ndarray:
        i = np.searchsorted(self.cdf, rng.random(size), side="right")
        return np.minimum(i, self.cdf.shape[0] - 1)


@dataclass
class Request:
    """One generated request; `due` is seconds after the schedule opens
    (0 for a backlog: due when submitted)."""
    index: int
    due: float
    prompt: np.ndarray
    max_new: int
    topic: int = 0


class Generator:
    """An endless, seeded stream of requests of one mix. `rate` (per
    second) paces open-loop arrivals; `vocab` is the model's
    vocabulary."""

    def __init__(self, spec: Spec, seed: int, vocab: int,
                 rate: float = 0.0):
        if spec.arrivals == "open_loop" and rate <= 0:
            raise ValueError(f"{spec.name}: open-loop arrivals need a rate")
        self.spec, self.rate = spec, rate
        self.rng = np.random.default_rng([seed, 7])
        self.order = np.random.default_rng([spec.schedule_seed, 13])
        tk = spec.tokens
        self.topics = int(tk.get("topics", 1))
        self.perms = [self.rng.permutation(vocab)
                      for _ in range(self.topics)]
        self.tok_law = _Zipf(vocab, tk["exponent"])
        self.topic_law = _Zipf(self.topics, tk.get("topic_exponent", 1.0))
        self.rotate_s = float(tk.get("rotate_s", 0) or 0)
        b = spec.block
        self.p_q = lognormal_quantiles(spec.prompt, b)
        self.o_q = lognormal_quantiles(spec.output, b)
        self.g_q = exponential_quantiles(b)
        self.index, self.t = 0, 0.0
        self._block: list = []

    def _refill(self):
        b = self.spec.block
        pp = self.order.permutation(b)
        po = self.order.permutation(b)
        pg = self.order.permutation(b)
        self._block = [(int(self.p_q[pp[j]]), int(self.o_q[po[j]]),
                        float(self.g_q[pg[j]])) for j in range(b)]
        self._block.reverse()

    def topic_at(self, t: float) -> int:
        """The topic of a request arriving at t: a popularity rank drawn
        from the topic law, mapped through the ranking in force at t."""
        rank = int(self.topic_law.draw(self.rng, 1)[0])
        shift = int(t // self.rotate_s) if self.rotate_s else 0
        return (rank + shift) % self.topics

    def next(self) -> Request:
        if not self._block:
            self._refill()
        plen, out, gap = self._block.pop()
        if self.spec.arrivals == "open_loop":
            self.t += gap / self.rate
        topic = self.topic_at(self.t)
        ids = self.perms[topic][self.tok_law.draw(self.rng, plen)]
        r = Request(self.index, self.t if self.spec.arrivals == "open_loop"
                    else 0.0, ids.astype(np.int32), out, topic)
        self.index += 1
        return r


def bucket(plen: int, max_len: int) -> int:
    """The power-of-two prefill bucket the engine pads a prompt to."""
    return min(max_len, max(8, 1 << (plen - 1).bit_length()))
