"""PyTorch port, the serverless expert runtime and the engine with
``expert_runtime="on"``, against the JAX reference on the reference's
float32 weights. The reference runs its EP plane on a (1, 1, 1) mesh
with Auto axes (jax 0.9's ``jax.make_mesh`` defaults to Explicit axes,
which the reference's sharding constraints refuse).

Exact: over a scripted plan sequence (cold, warm and prewarmed starts,
keep-alive and serverful evictions, served plans narrower than the full
plan), every ``ApplyReport``, the slot residency, the routing tables,
the cumulative meters (counts, transfers, bytes, per-rank bytes,
evictions, overlap meters, GB-seconds, the per-phase breakdown) and the
slot bank contents, float32 and int8. In the engine: greedy tokens,
ServeResult counters, the runtime's meters and the modeled clock, with
float32 and int8 banks, on the contiguous cache and on the paged pool
with chunked prefill.
"""
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import ServingSpec as JServingSpec
from repro.configs import get_config as jget_config
from repro.core.control import MoElessController as JMoElessController
from repro.core.control import PlanEvent as JPlanEvent
from repro.core.plan import LayerPlan as JLayerPlan
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.expert_runtime import ExpertRuntime as JExpertRuntime
from repro.serving.scheduler import GenRequest as JGenRequest
from repro_torch.configs import ServingSpec, get_config
from repro_torch.core.control import MOELESS_EXEC_TIME, PlanEvent
from repro_torch.core.control import MoElessController
from repro_torch.core.costmodel import derive_coeffs, param_bytes
from repro_torch.core.placer import place_layer
from repro_torch.core.plan import LayerPlan
from repro_torch.core.scaler import scale_layer
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.expert_runtime import ExpertRuntime
from repro_torch.serving.scheduler import GenRequest

torch.set_num_threads(1)


def _mesh():
    return jax.make_mesh((1, 1, 1), ("data", "ep", "tp"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


@functools.lru_cache(maxsize=None)
def _setup(slot_dtype):
    """Float32 mixtral smoke configs of both packages at the drop-free
    capacity factor with `slot_dtype` banks, and the reference's weights
    in both forms (read-only)."""
    cfg = get_config("mixtral-8x7b", smoke=True).with_(dtype="float32")
    jcfg = jget_config("mixtral-8x7b", smoke=True).with_(dtype="float32",
                                                         impl="ref")
    cf = float(cfg.moe.num_experts)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=cf,
                                            slot_dtype=slot_dtype))
    jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf,
                                              slot_dtype=slot_dtype))
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


# ------------------------------------------------------------ runtime


def _script(rt, seed=3):
    """(t, phase, port events, reference events) per iteration: plans from
    the scaler and placer, leads straddling the cold-start latency (cold,
    warm and prewarmed starts), an idle gap past the keep-alive, served
    plans that leave out each expert's newly placed replicas after its
    first (overlap-eligible copies), one serverful iteration, and one
    repeated plan (zero transfers)."""
    cs = rt.cold_start_latency()
    rng = np.random.default_rng(seed)
    prev = [None] * rt.n_layers
    alive = [set() for _ in range(rt.n_layers)]
    steps = [(0.0, 0.0, "prefill", True), (0.5, 2 * cs, "decode", True),
             (1.0, 0.0, "decode", True), (1.2, 0.0, "decode", True),
             (8.0, cs / 2, "prefill", True), (8.5, 2 * cs, "decode", False),
             (9.0, 0.0, "mixed", True)]
    out = []
    for i, (t, lead, phase, serverless) in enumerate(steps):
        ev, jev = [], []
        for l in range(rt.n_layers):
            if i == 3:                           # the previous plan again
                plan = prev[l]
            else:
                loads = rng.uniform(1.0, 100.0, size=rt.num_experts)
                plan = place_layer(
                    loads, scale_layer(loads, max_total_replicas=10), 4,
                    prev=prev[l], alive=alive[l],
                    max_replicas_per_device=3)
            placement = [list(map(int, p)) for p in plan.placement]
            served = [[g for r, g in enumerate(p)
                       if r == 0 or (e, g) in alive[l]]
                      for e, p in enumerate(placement)]
            alive[l] = set(plan.iter_replicas())
            prev[l] = plan
            reps = np.asarray(plan.replicas, np.int64)
            srep = np.array([len(p) for p in served], np.int64)
            e_, g_ = rt.num_experts, 4
            ev.append(PlanEvent(
                plan=LayerPlan(e_, g_, reps, placement),
                served=LayerPlan(e_, g_, srep, served), lead_time=lead,
                exec_time=MOELESS_EXEC_TIME, serverless=serverless))
            jev.append(JPlanEvent(
                plan=JLayerPlan(e_, g_, reps, placement),
                served=JLayerPlan(e_, g_, srep, served), lead_time=lead,
                exec_time=MOELESS_EXEC_TIME, serverless=serverless))
        out.append((t, phase, ev, jev))
    return out


def _runtimes(slot_dtype, **kw):
    cfg, jcfg, jp, tp = _setup(slot_dtype)
    args = dict(num_devices=4, slots_per_device=3, keep_alive=2.0)
    args.update(kw)
    return (ExpertRuntime(cfg, tp, **args),
            JExpertRuntime(jcfg, jp, mesh=_mesh(), **args))


def _assert_banks_equal(rt, jrt):
    for j in rt.moe_positions:
        assert sorted(rt.banks[j]) == sorted(jrt.banks[j])
        for k, b in rt.banks[j].items():
            want = np.asarray(jrt.banks[j][k])
            assert b.numpy().dtype == want.dtype, k
            np.testing.assert_array_equal(b.numpy(), want)


@pytest.mark.parametrize("slot_dtype", ["fp32", "int8"])
def test_runtime_matches_reference_runtime(slot_dtype):
    rt, jrt = _runtimes(slot_dtype)
    cfg = rt.cfg
    assert rt._slot_row_bytes == jrt._slot_row_bytes
    for j in rt.moe_positions:
        assert rt._slot_row_bytes[j] == param_bytes(cfg) \
            == derive_coeffs(cfg).expert_bytes
    assert rt.cold_start_latency() == jrt.cold_start_latency()
    rep, jrep = rt.bootstrap(), jrt.bootstrap()
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    seen = set()
    for t, phase, ev, jev in _script(rt):
        rep = rt.apply(t, ev, phase=phase, compute_s=0.01)
        jrep = jrt.apply(t, jev, phase=phase, compute_s=0.01)
        assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
        np.testing.assert_array_equal(rt.slot_expert, jrt.slot_expert)
        np.testing.assert_array_equal(rt.table_slots, jrt.table_slots)
        np.testing.assert_array_equal(rt.table_nrep, jrt.table_nrep)
        assert [rt.residency_set(l) for l in range(rt.n_layers)] == \
            [jrt.residency_set(l) for l in range(jrt.n_layers)]
        _assert_banks_equal(rt, jrt)
        seen.update(k for k in ("cold_starts", "warm_starts", "prewarmed",
                                "overlap_eligible", "exposed", "evictions")
                    if getattr(rep, k))
        if t == 1.2:                             # the repeated plan
            assert rep.transfers == 0 and rep.bytes_moved == 0.0
    assert seen == {"cold_starts", "warm_starts", "prewarmed",
                    "overlap_eligible", "exposed", "evictions"}
    st = dataclasses.asdict(rt.finalize(10.0))
    jst = dataclasses.asdict(jrt.finalize(10.0))
    assert st == jst
    assert st["bytes_moved"] == st["transfers"] * param_bytes(cfg)
    assert st["rank_bytes"] == {"rank0": st["bytes_moved"]}
    assert st["instance_seconds_gb"] > 0
    # the state the decode step reads: tables and banks per period
    state, jstate = rt.ep_state(), jrt.ep_state()
    for j in rt.moe_positions:
        for k, v in state[j].items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jstate[j][k]))


@pytest.mark.parametrize("slot_dtype", ["fp32", "int8"])
def test_double_buffered_banks_equal_single_buffered(slot_dtype):
    """The front bank after every flush equals the bank written in place
    (catch-up keeps the swapped buffers in step), and an unchanged plan
    moves zero bytes."""
    cfg, _, _, tp = _setup(slot_dtype)
    kw = dict(num_devices=4, slots_per_device=3, keep_alive=2.0)
    dbl = ExpertRuntime(cfg, tp, **kw)
    one = ExpertRuntime(cfg, tp, double_buffer=False, **kw)
    for rt in (dbl, one):
        rt.bootstrap()
    for t, phase, ev, _ in _script(dbl):
        r1 = dbl.apply(t, ev, phase=phase)
        r2 = one.apply(t, ev, phase=phase)
        assert dataclasses.asdict(r1) == dataclasses.asdict(r2)
        for j in dbl.moe_positions:
            for k in dbl.banks[j]:
                assert torch.equal(dbl.banks[j][k], one.banks[j][k])
    again = dbl.apply(9.5, ev, phase="decode")
    assert again.transfers == 0 and again.bytes_moved == 0.0
    assert again.warm_starts == sum(e.plan.total_replicas for e in ev)


def test_runtime_int8_banks_and_guards():
    cfg, _, _, tp = _setup("int8")
    rt = ExpertRuntime(cfg, tp, num_devices=4)
    for j in rt.moe_positions:
        for k in ("w_gate", "w_up", "w_down"):
            assert rt.banks[j][k].dtype == torch.int8
            assert rt.banks[j][k + "_scale"].dtype == torch.float32
            assert rt.banks[j][k + "_scale"].shape == \
                rt.banks[j][k].shape[:-1]
    r8 = rt.bootstrap()
    r32 = ExpertRuntime(_setup("fp32")[0], tp, num_devices=4).bootstrap()
    assert r8.transfers == r32.transfers
    assert 0 < r8.bytes_moved <= 0.30 * r32.bytes_moved
    with pytest.raises(RuntimeError, match="no tables"):
        ExpertRuntime(cfg, tp, num_devices=4).ep_state()
    with pytest.raises(ValueError, match="plan events"):
        rt.apply(1.0, [])
    # a mesh must be a ServingMesh, and its degrees must use the ranks
    # of the process group (one here)
    with pytest.raises(ValueError, match="ServingMesh"):
        ExpertRuntime(cfg, tp, num_devices=4, mesh=(1, 2, 1))
    with pytest.raises(ValueError, match="rank"):
        ExpertRuntime(cfg, tp, num_devices=4,
                      mesh=make_serving_mesh(ep=2, device="cpu"))
    with pytest.raises(ValueError, match="slot_dtype"):
        ExpertRuntime(cfg.with_(moe=dataclasses.replace(
            cfg.moe, slot_dtype="fp8")), tp, num_devices=4)
    assert math.isclose(r8.bytes_moved, r8.transfers * param_bytes(cfg))


# ------------------------------------------------------------ engine


def _reqs(cls, cfg, seed=7):
    rng = np.random.default_rng(seed)
    spec = [(8, 6, 0.0), (5, 4, 0.0), (11, 5, 0.0), (7, 6, 1e-4)]
    return [cls(rid=i, arrival=a,
                prompt=rng.integers(0, cfg.vocab_size, size=n,
                                    dtype=np.int32),
                max_new_tokens=m) for i, (n, m, a) in enumerate(spec)]


def _serve_port(cfg, tp, spec, num_devices=8, double_buffer=True):
    eng = ServingEngine(cfg, tp, max_len=24, expert_runtime="on",
                        serving=spec, runtime_double_buffer=double_buffer)
    reqs = _reqs(GenRequest, cfg)
    res = eng.serve(reqs, num_slots=2,
                    control=MoElessController(cfg, num_devices=num_devices))
    return reqs, res


@pytest.mark.parametrize("slot_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("kv", ["contiguous", "paged_chunked"])
def test_engine_runtime_on_matches_reference(slot_dtype, kv):
    cfg, jcfg, jp, tp = _setup(slot_dtype)
    spec = ServingSpec() if kv == "contiguous" else \
        ServingSpec(kv="paged", kv_block=4, prefill_chunk=5)
    jeng = JServingEngine(jcfg, jp, max_len=24, expert_runtime="on",
                          mesh=_mesh(), serving=JServingSpec(
                              **dataclasses.asdict(spec)))
    jreqs = _reqs(JGenRequest, cfg)
    jres = jeng.serve(jreqs, num_slots=2,
                      control=JMoElessController(jcfg, num_devices=8))
    reqs, res = _serve_port(cfg, tp, spec)
    assert [r.tokens for r in reqs] == [list(r.tokens) for r in jreqs]
    for k in ("iterations", "prefills", "rejected", "cancelled",
              "mean_batch_occupancy", "clock_s", "dropped_tokens"):
        assert getattr(res, k) == getattr(jres, k), k
    rows = lambda rs: sorted(map(dataclasses.astuple, rs))     # noqa: E731
    assert rows(res.records) == rows(jres.records)
    st = dataclasses.asdict(res.runtime.finalize(res.clock_s))
    jst = dataclasses.asdict(jres.runtime.finalize(jres.clock_s))
    assert st == jst
    assert st["transfers"] > 0
    assert st["bytes_moved"] == st["transfers"] * param_bytes(cfg)
    assert st["rank_bytes"] == {"rank0": st["bytes_moved"]}
    assert set(st["by_phase"]) >= {"bootstrap", "decode"}


def test_engine_single_buffered_runtime_equals_double_buffered():
    """``runtime_double_buffer=False`` (the full-width chip phase's
    setting: half the bank memory) serves the double-buffered engine's
    tokens, clock and runtime meters, and keeps no back bank."""
    cfg, _, _, tp = _setup("int8")
    spec = ServingSpec()
    reqs2, res2 = _serve_port(cfg, tp, spec)
    reqs1, res1 = _serve_port(cfg, tp, spec, double_buffer=False)
    assert [r.tokens for r in reqs1] == [r.tokens for r in reqs2]
    assert res1.clock_s == res2.clock_s
    assert dataclasses.asdict(res1.runtime.stats) == \
        dataclasses.asdict(res2.runtime.stats)
    assert res1.runtime.stats.transfers > 0
    rt1, rt2 = res1.runtime, res2.runtime
    assert not rt1.double_buffer and rt2.double_buffer
    for j in rt1.moe_positions:
        assert rt1._back[j] is None
        for k in rt1.banks[j]:
            assert torch.equal(rt1.banks[j][k], rt2.banks[j][k])


def test_engine_int8_tokens_equal_fp32_and_runtime_guards():
    """The reference's int8 == fp32 greedy-token identity
    (tests/test_impl_parity.py: the float32 smoke config at its own
    capacity factor, its weights ``fold_in(PRNGKey(3), 12)``, 6-token
    prompts, 4 new tokens, ``MoElessController(num_devices=4)``), within
    the port; and the engine's runtime guards."""
    base = get_config("mixtral-8x7b", smoke=True).with_(dtype="float32")
    jbase = jget_config("mixtral-8x7b", smoke=True).with_(dtype="float32",
                                                          impl="ref")
    jp = jax.jit(JM.init_params, static_argnums=0)(
        jbase, jax.random.fold_in(jax.random.PRNGKey(3), 12))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    toks = {}
    for sd in ("fp32", "int8"):
        cfg = base.with_(moe=dataclasses.replace(base.moe, slot_dtype=sd))
        rng = np.random.default_rng(0)
        reqs = [GenRequest(rid=i, arrival=0.0,
                           prompt=rng.integers(0, cfg.vocab_size, size=6,
                                               dtype=np.int32),
                           max_new_tokens=4) for i in range(2)]
        eng = ServingEngine(cfg, tp, max_len=24, expert_runtime="on")
        res = eng.serve(reqs, num_slots=2,
                        control=MoElessController(cfg, num_devices=4))
        assert len(res.records) == 2
        toks[sd] = [list(r.tokens) for r in reqs]
    assert toks["fp32"] == toks["int8"]
    cfg, _, _, tp = _setup("fp32")
    eng = ServingEngine(cfg, tp, max_len=16, expert_runtime="on")
    with pytest.raises(ValueError, match="control"):
        eng.start(num_slots=1)
    with pytest.raises(ValueError, match="ServingMesh"):
        ServingEngine(cfg, tp, expert_runtime="on", mesh=object())
    dense = get_config("mixtral-8x7b", smoke=True).with_(moe=None)
    with pytest.raises(ValueError, match="MoE"):
        ServingEngine(dense, tp, expert_runtime="on")
