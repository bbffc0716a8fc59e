"""PyTorch port, the paper's trace replay (``repro_torch.launch.
serve_trace``) against the JAX reference's script
(``examples/serve_trace.py``) on the reference's float32 weights.

Each strategy's replay of one ``generate_requests`` trace through the
port's ``replay`` equals the reference's loop (``examples/
serve_trace.py:105-127``, rebuilt here from ``repro`` modules) exactly:
per-request tokens and finish reasons, the ``ServeResult`` counters and
records, the control plane's meters and the runtime's settled meters.
The runtime-on cases run the reference's EP plane on a (1, 1, 1) mesh
with Auto axes (jax 0.9's ``jax.make_mesh`` defaults to Explicit axes,
which the reference's sharding constraints refuse). Also: a sampled
replay, ``--trace-out``'s tracks, and the simulator path's table text
for text.
"""
import argparse
import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import predictor as JP
from repro.core.control import ControlPlane as JControlPlane
from repro.core.trace import TraceConfig as JTraceConfig
from repro.core.trace import generate_requests as jgenerate_requests
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.scheduler import SamplingParams as JSamplingParams
from repro.serving.scheduler import requests_from_trace as jrequests
from repro_torch.configs import get_config
from repro_torch.core.trace import TraceConfig, generate_requests
from repro_torch.launch import serve_trace as ST
from repro_torch.params import from_jax
from repro_torch.serving.scheduler import SamplingParams

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# about 10 requests; budgets capped at MAX_NEW tokens
DURATION, RATE, SEED = 6.0, 4.0, 0
SLOTS, MAX_LEN, MAX_NEW, DEVICES = 4, 64, 8, 8
TIME_SCALE = 5000.0
RUNTIME_DTYPE = {"mixtral-8x7b": "fp32", "phi-3.5-moe": "int8"}


def _mesh():
    return jax.make_mesh((1, 1, 1), ("data", "ep", "tp"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


@functools.lru_cache(maxsize=None)
def _setup(arch, slot_dtype):
    """Float32 smoke configs of both packages with `slot_dtype` banks,
    and the reference script's weights for `arch` (the arch index folded
    into the key) in both forms (read-only)."""
    ai = ST.ARCHS.index(arch)
    jcfg = jget_config(arch, smoke=True).with_(dtype="float32", impl="ref")
    jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe,
                                              slot_dtype=slot_dtype))
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, slot_dtype=slot_dtype))
    jp = jax.jit(JM.init_params, static_argnums=0)(
        jcfg, jax.random.fold_in(jax.random.PRNGKey(SEED), ai))
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


def _trace():
    return generate_requests(TraceConfig(duration_s=DURATION,
                                         base_rate=RATE, seed=SEED))


def _ref_replay(jcfg, jp, strategy, runtime, sampling=JSamplingParams()):
    """The reference script's loop body for one (arch, strategy)."""
    trace = jgenerate_requests(JTraceConfig(duration_s=DURATION,
                                            base_rate=RATE, seed=SEED))
    predictor = JP.from_gates(jcfg, jp, distance=1)
    engine = JServingEngine(jcfg, jp, max_len=MAX_LEN,
                            expert_runtime=runtime,
                            mesh=_mesh() if runtime == "on" else None,
                            name=f"{jcfg.name}/{strategy}")
    control = JControlPlane(
        jcfg, strategy, num_devices=DEVICES,
        predictor=predictor if strategy == "moeless" else None,
        prediction_distance=1, track=f"{jcfg.name}/{strategy}/control")
    reqs, clip = jrequests(trace, jcfg.vocab_size, max_len=MAX_LEN,
                           seed=SEED, max_new_cap=MAX_NEW,
                           sampling=sampling)
    res = engine.serve(reqs, num_slots=SLOTS, control=control,
                       time_scale=TIME_SCALE)
    st = None if res.runtime is None else res.runtime.finalize(res.clock_s)
    return reqs, res, control, st, clip


def _port_replay(cfg, tp, strategy, runtime, sampling=None):
    return ST.replay(cfg, tp, _trace(), strategy, slots=SLOTS,
                     max_len=MAX_LEN, max_new=MAX_NEW, distance=1,
                     sampling=sampling, expert_runtime=runtime,
                     time_scale=TIME_SCALE, seed=SEED, num_devices=DEVICES)


def _assert_same(rp, ref):
    """Exact: tokens and finish reasons, ServeResult, control plane and
    runtime meters."""
    jreqs, jres, jctrl, jst, jclip = ref
    res, ctrl, st = rp.result, rp.control, rp.stats
    assert [(r.rid, r.tokens, r.finish_reason) for r in rp.requests] == \
        [(r.rid, r.tokens, r.finish_reason) for r in jreqs]
    rows = lambda rs: sorted(map(dataclasses.astuple, rs))     # noqa: E731
    assert rows(res.records) == rows(jres.records)
    for k in ("iterations", "prefills", "rejected", "cancelled", "clock_s",
              "dropped_tokens", "mean_batch_occupancy"):
        assert getattr(res, k) == getattr(jres, k), k
    for k in ("layer_latency", "iter_latency", "replica_counts", "cost",
              "host_transfers", "iterations", "phase_iterations",
              "phase_dropped"):
        assert getattr(ctrl, k) == getattr(jctrl, k), k
    assert dataclasses.astuple(rp.clip) == dataclasses.astuple(jclip)
    if jst is None:
        assert st is None
    else:
        assert dataclasses.asdict(st) == dataclasses.asdict(jst)
    assert len(rp.iter_walls) == res.iterations


CASES = [(arch, s, "off") for arch in ST.ARCHS for s in ST.STRATEGIES] + \
    [(arch, s, "on") for arch in ST.ARCHS for s in ST.STRATEGIES]


@pytest.mark.parametrize("arch,strategy,runtime", CASES)
def test_replay_matches_reference(arch, strategy, runtime):
    """Runtime off at float32 for both archs, and on with fp32 banks for
    mixtral and int8 banks for phi."""
    cfg, jcfg, jp, tp = _setup(arch, RUNTIME_DTYPE[arch] if runtime == "on"
                               else "fp32")
    ref = _ref_replay(jcfg, jp, strategy, runtime)
    rp = _port_replay(cfg, tp, strategy, runtime)
    _assert_same(rp, ref)
    assert len(rp.requests) >= 8 and rp.result.generated_tokens > 0
    if runtime == "on":
        assert rp.stats.transfers > 0
    assert (rp.control.predictor is not None) == (strategy == "moeless")


def test_sampled_replay_matches_reference():
    """Temperature 0.8, top-k 50: per-request streams from the rids."""
    cfg, jcfg, jp, tp = _setup("mixtral-8x7b", "fp32")
    ref = _ref_replay(jcfg, jp, "moeless", "off",
                      JSamplingParams(temperature=0.8, top_k=50))
    rp = _port_replay(cfg, tp, "moeless", "off",
                      SamplingParams(temperature=0.8, top_k=50))
    _assert_same(rp, ref)
    greedy = _port_replay(cfg, tp, "moeless", "off")
    assert [r.tokens for r in rp.requests] != \
        [r.tokens for r in greedy.requests]


def test_trace_out_has_a_track_for_each_arch_and_strategy(tmp_path, capsys):
    out = tmp_path / "trace.json"
    ST.main(["--device", "cpu", "--real-model", "--duration", "3",
             "--slots", "2", "--max-new", "4", "--trace-out", str(out)])
    text = capsys.readouterr().out
    names = {e["args"]["name"] for e in json.loads(out.read_text())[
        "traceEvents"] if e.get("name") == "thread_name"}
    for arch in ST.ARCHS:
        assert text.count(f"=== {arch} [real model") == 1
        for s in ST.STRATEGIES:
            # the engine's own track, and one a request below it
            assert f"{arch}/{s}" in names
            assert f"{arch}/{s}/req0" in names
    assert str(out) in text
    rows = [ln for ln in text.splitlines()
            if ln.split(" ")[0] in ST.STRATEGIES]
    assert len(rows) == 2 * len(ST.STRATEGIES)
    assert "modeled (v5e cost model)" in text


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_trace", ROOT / "examples" / "serve_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_simulator_table_equals_reference(capsys):
    """The simulator path prints the reference's table, text for text."""
    ref = _reference_script()
    assert ref.STRATEGIES == ST.STRATEGIES
    ref.run_simulator(argparse.Namespace(devices=8, duration=5.0,
                                         rate=4.0))
    want = capsys.readouterr().out
    ST.main(["--duration", "5"])
    got = capsys.readouterr().out
    assert got == want
    assert got.count("paper check:") == 2


def test_trace_equals_reference():
    tc = dict(duration_s=DURATION, base_rate=RATE, seed=SEED)
    assert [dataclasses.astuple(r) for r in generate_requests(
        TraceConfig(**tc))] == [dataclasses.astuple(r) for r in
                                jgenerate_requests(JTraceConfig(**tc))]
    assert len(_trace()) == 10


def test_arch_seeds_differ_and_the_card_is_the_default(monkeypatch):
    assert len({ST.arch_seed(0, i) for i in range(len(ST.ARCHS))}) == 2
    assert ST.arch_seed(0, 1) == ST.arch_seed(0, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ST.main(["--real-model", "--duration", "1"])
