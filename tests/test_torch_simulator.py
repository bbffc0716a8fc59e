"""PyTorch port, trace and simulator: ``repro_torch.core.trace`` and
``repro_torch.core.simulator`` (numpy copies of the reference's) against
the reference's modules for the same ``TraceConfig`` and seeds. Exact:
arrivals, token counts, batch iterations, expert loads, and every
strategy's per-(iteration, layer) latencies, cost, replica mean and
start counters."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import simulator as JSIM
from repro.core import trace as JTR
from repro.serving import scheduler as JSCHED
from repro_torch.configs import get_config
from repro_torch.core import simulator as SIM
from repro_torch.core import trace as TR
from repro_torch.serving import scheduler as SCHED

TRACES = [dict(duration_s=20, base_rate=4, seed=0),
          dict(duration_s=15, base_rate=6, seed=3, burstiness=0.6)]


@pytest.mark.parametrize("tc", TRACES)
def test_trace_matches_reference(tc):
    reqs = TR.generate_requests(TR.TraceConfig(**tc))
    jreqs = JTR.generate_requests(JTR.TraceConfig(**tc))
    assert list(map(dataclasses.astuple, reqs)) == \
        list(map(dataclasses.astuple, jreqs))
    its = TR.batch_iterations(reqs, tc["duration_s"])
    jits = JTR.batch_iterations(jreqs, tc["duration_s"])
    assert list(map(dataclasses.astuple, its)) == \
        list(map(dataclasses.astuple, jits))
    proc = TR.ExpertLoadProcess(4, 8, 2, seed=tc["seed"])
    jproc = JTR.ExpertLoadProcess(4, 8, 2, seed=tc["seed"])
    for it in its[:50]:
        np.testing.assert_array_equal(proc.loads(it.t, it.tokens),
                                      jproc.loads(it.t, it.tokens))
    # the port's scheduler materialises the port's trace requests
    got, clip = SCHED.requests_from_trace(reqs, 512, max_len=96, seed=1)
    want, jclip = JSCHED.requests_from_trace(jreqs, 512, max_len=96, seed=1)
    assert dataclasses.astuple(clip) == dataclasses.astuple(jclip)
    for a, b in zip(got, want, strict=True):
        assert (a.rid, a.arrival, a.max_new_tokens) == \
            (b.rid, b.arrival, b.max_new_tokens)
        np.testing.assert_array_equal(a.prompt, b.prompt)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi-3.5-moe"])
def test_simulator_matches_reference(arch):
    tc = dict(duration_s=12, base_rate=4, seed=2)
    sim = SIM.ServingSimulator(get_config(arch), num_devices=8,
                               trace=TR.TraceConfig(**tc), seed=2)
    jsim = JSIM.ServingSimulator(jget_config(arch), num_devices=8,
                                 trace=JTR.TraceConfig(**tc), seed=2)
    got, want = sim.run_all(), jsim.run_all()
    assert list(got) == list(want)
    for name in want:
        g, w = got[name], want[name]
        np.testing.assert_array_equal(g.layer_forward_ms, w.layer_forward_ms)
        assert (g.strategy, g.total_cost, g.mean_replicas_per_layer,
                g.cold_starts, g.prewarmed) == \
            (w.strategy, w.total_cost, w.mean_replicas_per_layer,
             w.cold_starts, w.prewarmed), name
    # the port's numbers show the paper's ordering, as the reference's
    assert got["moeless"].mean_ms() < got["megatron-lm"].mean_ms()
    em, jem = SIM.PredictorErrorModel(), JSIM.PredictorErrorModel()
    assert [em.accuracy(layer, d) for layer in (0, 5, 12)
            for d in (1, 3, 5)] == [jem.accuracy(layer, d)
                                    for layer in (0, 5, 12)
                                    for d in (1, 3, 5)]
