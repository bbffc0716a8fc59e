"""The traffic generator, the open-loop schedule and the backlog top-up."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench.core import serve as SV
from perfbench.core import traffic as TR


@pytest.mark.parametrize("name", ["batch", "rag"])
def test_same_seed_same_requests(name):
    a = TR.Generator(TR.load(name), 2**31 + 11, 32000, rate=5.0)
    b = TR.Generator(TR.load(name), 2**31 + 11, 32000, rate=5.0)
    c = TR.Generator(TR.load(name), 2**31 + 12, 32000, rate=5.0)
    ra = [a.next() for _ in range(130)]
    rb = [b.next() for _ in range(130)]
    rc = [c.next() for _ in range(130)]
    for x, y in zip(ra, rb):
        assert x.due == y.due and x.max_new == y.max_new
        assert np.array_equal(x.prompt, y.prompt)
    assert any(not np.array_equal(x.prompt, z.prompt) for x, z in zip(ra, rc))


@pytest.mark.parametrize("name", ["batch", "rag"])
def test_every_seed_the_same_schedule(name):
    """Whatever the seed, the same sizes and arrivals in the same order,
    each block holding the laws' quantiles clipped to the mix's range;
    another schedule seed orders them otherwise."""
    spec = TR.load(name)
    runs = []
    for sp, seed in ((spec, 1), (spec, 2**33 + 5),
                     (TR.Spec(**{**spec.__dict__, "schedule_seed": 1}), 1)):
        g = TR.Generator(sp, seed, 32000, rate=5.0)
        rs = [g.next() for _ in range(2 * spec.block)]
        runs.append(([len(r.prompt) for r in rs], [r.max_new for r in rs],
                     [r.due for r in rs]))
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[2][0]
    assert sorted(runs[0][0][:spec.block]) == sorted(runs[2][0][:spec.block])
    p, o = runs[0][0][:spec.block], runs[0][1][:spec.block]
    assert spec.prompt["min"] <= min(p) and max(p) <= spec.prompt["max"]
    assert spec.output["min"] <= min(o) and max(o) <= spec.output["max"]
    # the median of the lognormal law is the block's median
    assert abs(np.median(p) - spec.prompt["median"]) \
        < 0.1 * spec.prompt["median"]


def test_open_loop_schedule_keeps_its_rate():
    """Each block of 64 arrivals spans the same time, 64 / rate within
    the quantiles' rounding, and gaps are exponential quantiles."""
    rate = 7.5
    g = TR.Generator(TR.load("rag"), 99, 32064, rate=rate)
    dues = [g.next().due for _ in range(64 * 4)]
    span = [dues[64 * (k + 1) - 1] - (dues[64 * k - 1] if k else 0.0)
            for k in range(4)]
    want = TR.exponential_quantiles(64).sum() / rate
    for s in span:
        assert abs(s - want) < 1e-9 * want + 1e-9
    assert abs(want - 64 / rate) < 0.02 * 64 / rate
    gaps = np.diff([0.0] + dues[:64])
    assert np.allclose(np.sort(gaps), np.sort(TR.exponential_quantiles(64)
                                              / rate))


def test_topics_rotate():
    """With 8 topics rotating every 10 s, the most popular topic among
    arrivals moves from one 10 s span to the next."""
    g = TR.Generator(TR.load("rag"), 5, 32064, rate=200.0)
    rs = [g.next() for _ in range(8000)]
    tops = []
    for k in range(4):
        t = [r.topic for r in rs if 10 * k <= r.due < 10 * (k + 1)]
        tops.append(np.bincount(t, minlength=8).argmax())
    assert tops == [(tops[0] + k) % 8 for k in range(4)]


class _Sched:
    def __init__(self):
        self.pending = []


class _Engine:
    """Takes every request into its pending queue."""

    def __init__(self):
        self._session = type("S", (), {"sched": _Sched()})()

    def submit(self, req):
        self._session.sched.pending.append(req)
        return type("H", (), {"status": "queued"})()


def test_backlog_top_up_keeps_the_queue_full():
    eng = _Engine()
    system = SV.System(None, eng, None, None, None, False)
    sess = SV.Session(system, TR.Generator(TR.load("batch"), 1, 32000),
                      traced=False)
    sess.top_up(256)
    assert len(eng._session.sched.pending) == 256
    del eng._session.sched.pending[:100]       # admitted
    sess.top_up(256)
    assert len(eng._session.sched.pending) == 256
    assert len(sess.recs) == 356
    assert [r.rid for r in sess.recs.values()] == list(range(356))
