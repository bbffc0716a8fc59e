"""PyTorch port, serving: ``ServingEngine`` against the JAX reference's
engine on the reference's float32 weights, with a session control plane
whose modeled clock (the reference cost model) makes every counter
deterministic.

Exact: tokens per request, ServeResult counters (iterations, prefills,
rejected, cancelled, clock_s), per-request TTFT/TPOT/E2E records, the
control plane's meters and its per-layer replica plans. Also: a
mid-decode cancel, the engine's guards, and the package's import
isolation (nothing of JAX or of the reference package).
"""
import ast
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ServingSpec as JServingSpec
from repro.configs import get_config as jget_config
from repro.core.control import MoElessController as JMoElessController
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.scheduler import GenRequest as JGenRequest
from repro_torch.configs import ServingSpec, get_config
from repro_torch.core.control import ControlPlane, MoElessController
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import GenRequest, SamplingParams

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"


@functools.lru_cache(maxsize=None)
def _setup(cf):
    """Float32 mixtral smoke configs (capacity factor `cf`) of both
    packages with the reference's weights in both forms (read-only)."""
    cfg = get_config("mixtral-8x7b", smoke=True).with_(dtype="float32")
    jcfg = jget_config("mixtral-8x7b", smoke=True).with_(dtype="float32",
                                                         impl="ref")
    cfg = cfg.with_(moe=cfg.moe.__class__(
        num_experts=4, top_k=2, d_ff=cfg.moe.d_ff, capacity_factor=cf))
    jcfg = jcfg.with_(moe=jcfg.moe.__class__(
        num_experts=4, top_k=2, d_ff=jcfg.moe.d_ff, capacity_factor=cf))
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(5))
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


def _reqs(cls, cfg, spec, seed=9):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, arrival=float(a),
                prompt=rng.integers(0, cfg.vocab_size, size=pl,
                                    dtype=np.int32),
                max_new_tokens=n)
            for i, (pl, n, a) in enumerate(spec)]


# (prompt_len, max_new_tokens, arrival): more requests than slots, some
# arriving mid-run, one that can never fit (rejected)
TRACE = [(5, 6, 0.0), (9, 3, 0.0), (3, 8, 0.0), (12, 5, 0.0),
         (7, 4, 1e-3), (4, 7, 2e-3), (30, 8, 0.0)]


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_serve_matches_reference(cf):
    """cf 0.5 forces capacity overflow, where inactive slots and the
    prefill pad rows decide which active tokens drop."""
    cfg, jcfg, jp, tp = _setup(cf)
    jctrl = JMoElessController(jcfg, num_devices=4)
    jreqs = _reqs(JGenRequest, cfg, TRACE)
    jres = JServingEngine(jcfg, jp, max_len=24).serve(
        jreqs, num_slots=3, control=jctrl, time_scale=50.0)
    ctrl = MoElessController(cfg, num_devices=4)
    reqs = _reqs(GenRequest, cfg, TRACE)
    res = ServingEngine(cfg, tp, max_len=24).serve(
        reqs, num_slots=3, control=ctrl, time_scale=50.0)

    assert {r.rid: r.tokens for r in reqs} == \
        {r.rid: r.tokens for r in jreqs}
    assert [r.finish_reason for r in reqs] == \
        [r.finish_reason for r in jreqs]
    for k in ("iterations", "prefills", "rejected", "cancelled", "clock_s",
              "dropped_tokens", "mean_batch_occupancy"):
        assert getattr(res, k) == getattr(jres, k), k
    assert res.rejected == 1
    # the two packages' RequestMetrics are distinct classes: compare
    # their fields
    rows = lambda rs: sorted(map(dataclasses.astuple, rs))     # noqa: E731
    assert rows(res.records) == rows(jres.records)
    assert ctrl.iterations == jctrl.iterations
    assert ctrl.phase_iterations == jctrl.phase_iterations
    assert ctrl.phase_dropped == jctrl.phase_dropped
    assert ctrl.layer_latency == jctrl.layer_latency
    assert ctrl.cost == jctrl.cost
    for mine, ref in zip(ctrl.plans + ctrl.last_plans,
                         jctrl.plans + jctrl.last_plans):
        np.testing.assert_array_equal(mine.replicas, ref.replicas)
        assert mine.placement == ref.placement
    if cf < 1:
        assert res.dropped_tokens > 0


def test_engine_controller_and_cancel_match_reference():
    """A per-iteration engine controller (wall-clock serving clock) plans
    the same as the reference's, and a mid-decode cancel recycles the
    slot for the queued request in both packages."""
    cfg, jcfg, jp, tp = _setup(1.25)
    out = []
    for eng_cls, req_cls, ctrl_cls, c, p in (
            (JServingEngine, JGenRequest, JMoElessController, jcfg, jp),
            (ServingEngine, GenRequest, MoElessController, cfg, tp)):
        ctrl = ctrl_cls(c, num_devices=4)
        eng = eng_cls(c, p, max_len=32, controller=ctrl)
        eng.start(num_slots=1)
        a, b = _reqs(req_cls, cfg, [(5, 20, 0.0), (6, 4, 0.0)])
        ha, hb = eng.submit(a), eng.submit(b)
        eng.step()
        eng.step()
        assert ha.status == "running" and hb.status == "queued"
        assert eng.cancel(ha) and ha.status == "cancelled"
        assert eng._session.kv.num_free == 1
        res = eng.run()
        assert hb.status == "finished" and res.cancelled == 1
        assert not eng.cancel(ha)
        out.append((list(a.tokens), list(b.tokens), ctrl.iterations,
                    [p_.replicas.tolist() for p_ in ctrl.plans]))
    assert out[0] == out[1]


def test_engine_guards():
    cfg, jcfg, jp, tp = _setup(1.25)
    with pytest.raises(ValueError):
        ServingEngine(cfg, tp, impl="pallas")
    # the expert runtime executes a session control plane's plans
    with pytest.raises(ValueError, match="control"):
        ServingEngine(cfg, tp, expert_runtime="on").start(num_slots=1)
    # the reference's serving-knob guards (paged KV itself is served)
    for bad in (ServingSpec(prefill_chunk=4), ServingSpec(prefix_cache=True),
                ServingSpec(kv="paged", prefix_cache=True),
                ServingSpec(kv="ring")):
        with pytest.raises(ValueError):
            ServingEngine(cfg, tp, serving=bad)
        with pytest.raises(ValueError):
            JServingEngine(jcfg, jp, serving=JServingSpec(
                **dataclasses.asdict(bad)))
    assert ServingEngine(cfg, tp, serving=ServingSpec(kv="paged")) \
        .serving.kv == "paged"
    with pytest.raises(ValueError, match="ServingMesh"):
        ServingEngine(cfg, tp, mesh=object())
    # sampled requests are admitted (tests/test_torch_sampling.py holds
    # their tokens to the reference's)
    eng = ServingEngine(cfg, tp, max_len=16)
    h = eng.submit(GenRequest(rid=0, arrival=0.0,
                              prompt=np.arange(3, dtype=np.int32),
                              max_new_tokens=2,
                              sampling=SamplingParams(temperature=0.7)))
    assert h.status == "queued" and len(eng.run().records) == 1
    # impl="cuda" with the weights on the CPU raises at the first kernel
    eng = ServingEngine(cfg, tp, max_len=16, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        eng.serve(_reqs(GenRequest, cfg, [(4, 2, 0.0)]), num_slots=1)
    ctrl = MoElessController(cfg)
    ctrl.step(0.0, None, np.ones((cfg.num_layers, cfg.moe.num_experts),
                                 np.int32))
    assert ctrl.plan_tables(0)["slot_expert"].shape == \
        (ctrl.num_devices * ctrl.slots_per_device,)
    assert isinstance(ControlPlane(cfg, "eplb"), ControlPlane)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference_ast():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert files
    root = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    for f in files + [root]:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_port_imports_neither_jax_nor_reference_at_runtime():
    code = ("import repro_torch.serving.engine, repro_torch.launch.serve, "
            "repro_torch.serving.expert_runtime, repro_torch.distributed.ep, "
            "repro_torch.kernels.quant, repro_torch.serving.gateway, "
            "repro_torch.core.simulator, repro_torch.models.prng, "
            "repro_torch.core.predictor, repro_torch.training.optimizer, "
            "repro_torch.configs, repro_torch.models.model, "
            "repro_torch.models.ssm, repro_torch.training.train_loop, "
            "repro_torch.training.checkpoint, repro_torch.launch.train, "
            "repro_torch.launch.serve_trace, "
            "sys; "
            "repro_torch.configs.list_archs(); "
            "assert not any(m == 'jax' or m.startswith(('jax.', "
            "'repro.')) or m == 'repro' for m in sys.modules)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
