"""Faults planted underneath the timed path: each must make the check
come out false. A smoke run on the CPU drives the rest of a run, from
the engine through the check, with the cell's own limit."""
from __future__ import annotations

import pytest
import torch

from perfbench.calibrate import one_replica
from perfbench.core import spec
from perfbench.tests import _smoke


def _wrap_model_call(system, fn):
    eng = system.engine
    call = eng._step

    def step(batch, cache, cache_len, collect, ep=None):
        return fn(call, batch, cache, cache_len, collect, ep)
    eng._step = step


def altered_token(system):
    """Every third model call's tokens are the runner-up, not the best."""
    n = [0]

    def fn(call, *a):
        logits, cache, m = call(*a)
        n[0] += 1
        if n[0] % 3 == 0:
            best = logits.argmax(-1, keepdim=True)
            alt = (best + 1) % logits.shape[-1]
            logits = logits.scatter(-1, alt, float(logits.max()) + 1.0)
        return logits, cache, m
    _wrap_model_call(system, fn)


def unchanged_state(system):
    """The batched decode step leaves the KV cache as it found it."""
    def fn(call, batch, cache, cache_len, collect, ep):
        if isinstance(cache_len, int):            # a solo prefill
            return call(batch, cache, cache_len, collect, ep)
        saved = [{k: v.clone() for k, v in c["attn"].items()}
                 for c in cache]
        logits, cache, m = call(batch, cache, cache_len, collect, ep)
        for c, s in zip(cache, saved):
            for k, v in s.items():
                c["attn"][k].copy_(v)
        return logits, cache, m
    _wrap_model_call(system, fn)


def half_batch(system):
    """The batched step computes half of its rows; the other half take
    the first half's results."""
    def fn(call, batch, cache, cache_len, collect, ep):
        logits, cache, m = call(batch, cache, cache_len, collect, ep)
        b = logits.shape[0]
        if b > 1:
            logits = logits.clone()
            logits[b // 2:] = logits[:b - b // 2]
        return logits, cache, m
    _wrap_model_call(system, fn)


@pytest.mark.parametrize("name", ["mixtral.batch", "phi.moeless.rag"])
@pytest.mark.parametrize("fault", [altered_token, unchanged_state,
                                   half_batch])
def test_a_fault_fails_the_check(name, fault):
    res, readings, _ = _smoke.run(name, fault=fault)
    assert not res["correct"], readings
    assert res["checks"]["widest_gap"]["value"] \
        > res["checks"]["widest_gap"]["limit"]


def test_a_sound_run_passes_with_the_same_limit():
    res, readings, _ = _smoke.run("mixtral.batch")
    assert res["correct"], readings
    assert torch.isfinite(torch.tensor(readings["program"]["widest_gap"]))


def test_a_planner_with_fewer_replicas_fails_the_drop_limit():
    """MoEless's scaler held to one replica an expert drops more of the
    prefill's assignments; a limit between the sound run's share and
    twice it lets the one pass and fails the other."""
    lim = {**spec.load_cell("phi.moeless.rag").cell["check"]["limits"],
           "dropped_share.prefill": 1.0, "dropped_share.decode": 1.0}
    sound, readings, _ = _smoke.run("phi.moeless.rag", limits=lim)
    share = sound["checks"]["dropped_share.prefill"]["value"]
    assert sound["correct"] and share > 0, readings
    lim["dropped_share.prefill"] = 2 * share
    res, readings, _ = _smoke.run("phi.moeless.rag", fault=one_replica,
                                  limits=lim)
    assert res["checks"]["dropped_share.prefill"]["value"] > 2 * share
    assert not res["correct"], readings
