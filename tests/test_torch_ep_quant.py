"""PyTorch port, int8 slot banks and the EP slot data plane at ep=1,
against the JAX reference on the same numpy inputs:

  * ``kernels.quant``: int8 values and scales bit-identical to the
    reference's, for float32 and bfloat16 input and all-zero rows;
  * the dequantizing plain versions (``gmm_ref_quant``,
    ``expert_ffn_ref_quant``, the wrappers' ``*_ref`` and the ``impl``
    dispatch) against the reference's Pallas kernels in interpret mode;
  * the slot tables (``plan_to_tables``, ``uniform_tables``,
    ``device_rank``, ``MoElessController.plan_tables``): exactly equal,
    with the spill warning and the overflow error;
  * ``moe_ep_layer`` with float32 and int8 banks against the reference's
    ``moe_ep_layer`` on a (1, 1, 1) mesh with Auto axes (jax 0.9's
    ``jax.make_mesh`` defaults to Explicit axes, which the reference's
    sharding constraints refuse), and against the port's own
    ``dispatch_moe`` under forced overflow.

Tolerances: float32 atol=rtol=1e-5 (float32 sums in another order);
expert loads, dropped counts, tables and quantized banks are exact.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.control import MoElessController as JMoElessController
from repro.core.plan import LayerPlan as JLayerPlan
from repro.core.plan import static_plan as jstatic_plan
from repro.distributed import ep as JEP
from repro.kernels import moe_gmm as JMG
from repro.kernels import quant as JQT
from repro.kernels import ref as JREF
from repro_torch.configs import get_config
from repro_torch.core.control import MoElessController
from repro_torch.core.plan import LayerPlan, static_plan
from repro_torch.distributed import ep as EP
from repro_torch.kernels import moe_gmm as MG
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import quant as QT
from repro_torch.kernels import ref as REF
from repro_torch.models import moe as MOE

torch.set_num_threads(1)

F32_TOL = 1e-5


def _mesh():
    """The reference's (1, 1, 1) serving mesh with Auto axes."""
    return jax.make_mesh((1, 1, 1), ("data", "ep", "tp"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ quant


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_identical(dtype):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5, 24)).astype(np.float32) * 3.0
    w[1, 2] = 0.0                            # an all-zero row
    w[2, 0, :] = 1e-30                       # a tiny row
    w[0, 1, 3] = 1e4                         # a dominant element
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jq, js = JQT.quantize_rows(jw)
    q, s = QT.quantize_rows(tw)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[1, 2]) == 1.0 and not q[1, 2].any()
    np.testing.assert_array_equal(QT.dequantize_rows(q, s).numpy(),
                                  np.asarray(JQT.dequantize_rows(jq, js)))


def test_quantize_expert_bank_bit_identical():
    rng = np.random.default_rng(1)
    bank = {"w_gate": rng.standard_normal((2, 3, 8, 12)).astype(np.float32),
            "w_up": rng.standard_normal((2, 3, 8, 12)).astype(np.float32),
            "w_down": rng.standard_normal((2, 3, 12, 8)).astype(np.float32)}
    bank["w_up"][:, -1] = 0.0
    jq = JQT.quantize_expert_bank({k: jnp.asarray(v) for k, v in
                                   bank.items()})
    q = QT.quantize_expert_bank({k: torch.from_numpy(v) for k, v in
                                 bank.items()})
    assert sorted(q) == sorted(jq)
    for k in jq:
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
    assert QT.is_quantized(q) and not QT.is_quantized(bank)
    assert QT.quantize_expert_bank(q) is q
    assert QT.weight_keys(q) == JQT.weight_keys(jq)
    deq = QT.dequantize_expert_bank(q)
    jdeq = JQT.dequantize_expert_bank(jq)
    for k in jdeq:
        np.testing.assert_array_equal(deq[k].numpy(), np.asarray(jdeq[k]))


# (E, C, D, F, group sizes): C = 7, D = 96, F = 40, an empty expert,
# all-empty, E = 1; then the tile edges of the card's wgmma path: C = 161
# (two row groups), D = 200 (a tail past the 64-deep stage), F = 144 (a
# multiple of 16, not of a CTA's columns), and 16 slots of which 4 have
# rows
QUANT_CASES = [
    (3, 7, 96, 40, [7, 3, 0]),
    (2, 7, 96, 40, [0, 0]),
    (1, 7, 96, 40, [5]),
    (2, 161, 200, 144, [161, 9]),
    (16, 3, 64, 48, [0, 3, 0, 0, 1, 0, 0, 0, 0, 0, 2, 0, 0, 0, 0, 3]),
]


def _quant_case(e, c, d, f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    ws = [(rng.standard_normal(sh) / np.sqrt(sh[1])).astype(np.float32)
          for sh in ((e, d, f), (e, d, f), (e, f, d))]
    qs = [JQT.quantize_rows(jnp.asarray(w)) for w in ws]
    return x, [(np.asarray(q), np.asarray(s)) for q, s in qs]


@pytest.mark.parametrize("case", QUANT_CASES)
def test_quant_plain_versions_match_reference_kernels(case):
    """The port's plain versions (and the wrappers on CPU tensors, and
    the ``impl`` dispatch) against the reference's Pallas kernels in
    interpret mode and its oracle."""
    e, c, d, f, gs = case
    x, ((gq, gsc), (uq, usc), (dq, dsc)) = _quant_case(e, c, d, f)
    g = np.asarray(gs, np.int32)
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    j = {n: (jnp.asarray(q), jnp.asarray(s)) for n, q, s in
         (("g", gq, gsc), ("u", uq, usc), ("d", dq, dsc))}
    tx, tg = _t(x), _t(g)
    t = {n: (_t(q), _t(s)) for n, q, s in
         (("g", gq, gsc), ("u", uq, usc), ("d", dq, dsc))}

    want_h = np.asarray(JMG.fused_gate_up_quant(jx, *j["g"], *j["u"], jg,
                                                interpret=True))
    for got in (MG.fused_gate_up_quant(tx, *t["g"], *t["u"], tg),
                MG.fused_gate_up_quant_ref(tx, *t["g"], *t["u"], tg)):
        np.testing.assert_allclose(got.numpy(), want_h, atol=F32_TOL,
                                   rtol=F32_TOL)
    want_y = np.asarray(JMG.gmm_quant(jx, *j["g"], jg, interpret=True))
    for got in (MG.gmm_quant(tx, *t["g"], tg),
                MG.gmm_quant_ref(tx, *t["g"], tg),
                REF.gmm_ref_quant(tx, *t["g"], tg),
                OPS.gmm_quant_impl(tx, *t["g"], tg, "auto")):
        np.testing.assert_allclose(got.numpy(), want_y, atol=F32_TOL,
                                   rtol=F32_TOL)
    np.testing.assert_allclose(
        REF.gmm_ref_quant(tx, *t["g"], tg).numpy(),
        np.asarray(JREF.gmm_ref_quant(jx, *j["g"], jg)), atol=F32_TOL,
        rtol=F32_TOL)
    want_ffn = np.asarray(JMG.gmm_quant(
        jnp.asarray(want_h), *j["d"], jg, interpret=True))
    for impl in ("auto", "ref"):
        got = OPS.expert_ffn_quant_impl(tx, *t["g"], *t["u"], *t["d"], tg,
                                        impl)
        np.testing.assert_allclose(got.numpy(), want_ffn, atol=F32_TOL,
                                   rtol=F32_TOL)
    np.testing.assert_allclose(
        REF.expert_ffn_ref_quant(tx, *t["g"], *t["u"], *t["d"], tg).numpy(),
        np.asarray(JREF.expert_ffn_ref_quant(jx, *j["g"], *j["u"], *j["d"],
                                             jg)),
        atol=F32_TOL, rtol=F32_TOL)


def test_experts_ffn_selects_int8_bank_by_scale_keys():
    """``models.moe.experts_ffn`` dispatches on ``w_up_scale`` as the
    reference does, for SwiGLU and for gelu experts (``gmm_quant`` up,
    gelu, ``gmm_quant`` down, as the reference's ``experts_ffn``)."""
    e, c, d, f, gs = QUANT_CASES[0]
    x, qs = _quant_case(e, c, d, f)
    bank = {}
    for n, (q, s) in zip(("w_gate", "w_up", "w_down"), qs):
        bank[n], bank[n + "_scale"] = _t(q), _t(s)
    g = _t(np.asarray(gs, np.int32))
    got = MOE.experts_ffn(bank, _t(x), "swiglu", group_sizes=g)
    want = REF.expert_ffn_ref_quant(_t(x), *(bank[k] for k in (
        "w_gate", "w_gate_scale", "w_up", "w_up_scale", "w_down",
        "w_down_scale")), g)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    gelu = {k: v for k, v in bank.items() if not k.startswith("w_gate")}
    got = MOE.experts_ffn(gelu, _t(x), "gelu", group_sizes=g)
    jb = {k: jnp.asarray(v.numpy()) for k, v in gelu.items()}
    jg = jnp.asarray(gs, jnp.int32)
    h = jax.nn.gelu(JREF.gmm_ref_quant(jnp.asarray(x), jb["w_up"],
                                       jb["w_up_scale"], jg))
    want = JREF.gmm_ref_quant(h, jb["w_down"], jb["w_down_scale"], jg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------ tables


def _jtables(t):
    return {k: np.asarray(v) for k, v in t.items()}


def _assert_tables_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def _plans():
    rng = np.random.default_rng(4)
    out = [(static_plan(4, 2), jstatic_plan(4, 2))]
    for _ in range(3):
        reps = rng.integers(1, 4, 4)
        place = [sorted(rng.choice(4, size=int(r), replace=True).tolist())
                 for r in reps]
        out.append((LayerPlan(4, 4, reps.astype(np.int64), place),
                    JLayerPlan(4, 4, reps.astype(np.int64), place)))
    return out


@pytest.mark.parametrize("ep,spd,nd", [(1, 12, None), (2, 6, 4),
                                       (4, 3, 4), (2, 6, None)])
def test_plan_to_tables_match_reference(ep, spd, nd):
    for plan, jplan in _plans():
        with warnings.catch_warnings(record=True) as w1:
            warnings.simplefilter("always")
            want = _jtables(JEP.plan_to_tables(jplan, ep=ep,
                                               slots_per_device=spd,
                                               num_devices=nd))
        with warnings.catch_warnings(record=True) as w2:
            warnings.simplefilter("always")
            got = EP.plan_to_tables(plan, ep=ep, slots_per_device=spd,
                                    num_devices=nd)
        _assert_tables_equal(got, want)
        assert [str(x.message) for x in w1] == [str(x.message) for x in w2]
    _assert_tables_equal(EP.uniform_tables(4, ep=2, slots_per_device=3),
                         _jtables(JEP.uniform_tables(4, ep=2,
                                                     slots_per_device=3)))
    for g in range(8):
        assert EP.device_rank(g, num_devices=8, ep=4) == \
            JEP.device_rank(g, num_devices=8, ep=4)
    assert EP.ep_factorisation(8, 12) == JEP.ep_factorisation(8, 12)


def test_plan_to_tables_spill_and_overflow():
    plan = LayerPlan(3, 2, np.ones(3, np.int64), [[0], [0], [0]])
    jplan = JLayerPlan(3, 2, np.ones(3, np.int64), [[0], [0], [0]])
    with pytest.warns(RuntimeWarning, match="spilled"):
        got = EP.plan_to_tables(plan, ep=2, slots_per_device=2)
    with pytest.warns(RuntimeWarning, match="spilled"):
        want = _jtables(JEP.plan_to_tables(jplan, ep=2, slots_per_device=2))
    _assert_tables_equal(got, want)
    big = LayerPlan(5, 2, np.ones(5, np.int64), [[0], [0], [1], [1], [0]])
    with pytest.raises(ValueError, match="slot"):
        EP.plan_to_tables(big, ep=2, slots_per_device=2)
    with pytest.raises(ValueError, match="multiple"):
        EP.device_rank(3, num_devices=6, ep=4)


def test_controller_plan_tables_match_reference():
    """``MoElessController.plan_tables(layer, ep)`` after the same driven
    steps equals the reference controller's, for the default and an
    explicit ep."""
    cfg = get_config("mixtral-8x7b", smoke=True)
    jcfg = jget_config("mixtral-8x7b", smoke=True)
    ctrl = MoElessController(cfg, num_devices=8)
    jctrl = JMoElessController(jcfg, num_devices=8)
    rng = np.random.default_rng(2)
    for it in range(3):
        loads = rng.integers(0, 40, (cfg.num_layers, 8)).astype(np.int32)
        ctrl.step(float(it), None, loads)
        jctrl.step(float(it), None, jnp.asarray(loads))
    for layer in range(cfg.num_layers):
        for ep in (None, 1, 2, 4, 8):
            _assert_tables_equal(ctrl.plan_tables(layer, ep),
                                 _jtables(jctrl.plan_tables(layer, ep)))


# ------------------------------------------------------------ the layer

D, F_ = 16, 32


@functools.lru_cache(maxsize=None)
def _layer_params(e, seed=0):
    rng = np.random.default_rng(seed)
    return {"router": (rng.standard_normal((D, e)) / np.sqrt(D))
            .astype(np.float32),
            "experts": {
                "w_gate": (rng.standard_normal((e, D, F_)) / np.sqrt(D))
                .astype(np.float32),
                "w_up": (rng.standard_normal((e, D, F_)) / np.sqrt(D))
                .astype(np.float32),
                "w_down": (rng.standard_normal((e, F_, D)) / np.sqrt(F_))
                .astype(np.float32)}}


def _both_ep(p, x, e, k, cf, tables, *, int8=False, token_mask=None,
             pad_rows=0, spd=None):
    """(port y, port metrics), (reference y, reference metrics) of one
    moe_ep_layer call on the same weights, tables and input."""
    spd = spd or 2 * e
    jbank = {kk: jnp.asarray(v) for kk, v in p["experts"].items()}
    tbank = {kk: _t(v) for kk, v in p["experts"].items()}
    if int8:
        jbank = JQT.quantize_expert_bank(jbank)
        tbank = QT.quantize_expert_bank(tbank)
    mesh = _mesh()
    jt = {kk: jnp.asarray(v) for kk, v in tables.items()}
    jm = None if token_mask is None else jnp.asarray(token_mask)
    layer = jax.jit(functools.partial(
        JEP.moe_ep_layer, mesh=mesh, num_experts=e, top_k=k,
        slots_per_device=spd, capacity_factor=cf, impl="ref",
        pad_rows=pad_rows))
    with mesh:
        slot_w = JEP.materialise_slots(jbank, jt["slot_expert"], mesh)
        jy, jmet = layer(jnp.asarray(x), jnp.asarray(p["router"]), slot_w,
                         jt, token_mask=jm)
    tslot = EP.materialise_slots(tbank, tables["slot_expert"])
    for kk in tslot:
        np.testing.assert_array_equal(tslot[kk].numpy(),
                                      np.asarray(slot_w[kk]))
    ty, tmet = EP.moe_ep_layer(
        _t(x), _t(p["router"]), tslot, tables, num_experts=e, top_k=k,
        slots_per_device=spd, capacity_factor=cf, impl="auto",
        token_mask=None if token_mask is None else _t(token_mask),
        pad_rows=pad_rows)
    return (ty, tmet), (np.asarray(jy), jmet)


def _assert_same(port, ref):
    (ty, tm), (jy, jm) = port, ref
    np.testing.assert_allclose(ty.numpy(), jy, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                  np.asarray(jm["expert_load"]))
    assert float(tm["dropped"]) == float(jm["dropped"])
    assert float(tm["aux_loss"]) == 0.0


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("cf", [0.25, 0.5, 1.0, 4.0])
def test_moe_ep_layer_matches_reference_and_dispatch(int8, cf):
    """Replicated plan (capacity from extra replicas) against the
    reference; single-replica tables against the reference AND the
    port's capacity dispatch: equal drops and loads, allclose y (a
    differently kept token would change y)."""
    e, k = 4, 2
    p = _layer_params(e)
    x = _x((2, 8, D), 1)
    loads = np.array([40.0, 5.0, 10.0, 5.0])
    plan = LayerPlan(e, 2, np.array([3, 1, 2, 1], np.int64),
                     [[0, 1, 0], [1], [0, 1], [0]])
    _assert_same(*_both_ep(p, x, e, k, cf,
                           EP.plan_to_tables(plan, ep=1,
                                             slots_per_device=2 * e),
                           int8=int8))
    single = EP.plan_to_tables(static_plan(e, 1), ep=1,
                               slots_per_device=2 * e)
    port, ref = _both_ep(p, x, e, k, cf, single, int8=int8)
    _assert_same(port, ref)
    experts = {kk: _t(v) for kk, v in p["experts"].items()}
    if int8:
        experts = QT.quantize_expert_bank(experts)
    yd, md = MOE.dispatch_moe({"router": {"w_gate": _t(p["router"])},
                               "experts": experts}, _t(x), top_k=k,
                              num_experts=e, capacity_factor=cf)
    if cf < 1.0:
        assert float(md["dropped"]) > 0        # overflow really forced
    assert float(md["dropped"]) == float(port[1]["dropped"])
    np.testing.assert_array_equal(md["expert_load"].numpy(),
                                  port[1]["expert_load"].numpy())
    np.testing.assert_allclose(yd.numpy(), port[0].numpy(), atol=F32_TOL,
                               rtol=F32_TOL)
    assert loads.sum() > 0


def test_moe_ep_layer_zero_replica_mask_and_pad_rows():
    """A zero-replica expert routes safely (its assignments are dropped,
    its load still reported); token_mask excludes tokens from loads and
    drops; pad_rows leave the capacity formula and the routing."""
    e, k = 4, 2
    p = dict(_layer_params(e, seed=3))
    p["router"] = p["router"].copy()
    p["router"][:, 0] += 10.0
    x = np.abs(_x((1, 8, D), 6)) + 0.1
    plan = LayerPlan(e, 1, np.array([0, 1, 1, 1], np.int64),
                     [[], [0], [0], [0]])
    tables = EP.plan_to_tables(plan, ep=1, slots_per_device=2 * e)
    assert int(tables["nrep"][0]) == 0
    port, ref = _both_ep(p, x, e, k, float(e), tables)
    _assert_same(port, ref)
    assert float(port[1]["dropped"]) == 8.0
    assert int(port[1]["expert_load"][0]) == 8
    p = _layer_params(e, seed=5)
    single = EP.plan_to_tables(static_plan(e, 1), ep=1,
                               slots_per_device=2 * e)
    mask = np.array([[1, 1, 1, 1, 0, 0, 0, 0],
                     [1, 0, 1, 0, 1, 0, 1, 0]], np.int32)
    for int8 in (False, True):
        port, ref = _both_ep(p, _x((2, 8, D), 7), e, k, 0.4, single,
                             int8=int8, token_mask=mask)
        _assert_same(port, ref)
        port, ref = _both_ep(p, _x((3, 8, D), 8), e, k, 0.5, single,
                             int8=int8, pad_rows=1)
        _assert_same(port, ref)
        assert not port[0][2].any()            # pad rows are not routed


def test_materialise_slots_incremental_equals_full_and_degrees_guard():
    e = 4
    w = {kk: _t(v) for kk, v in _layer_params(e)["experts"].items()}
    padded = EP.pad_expert_bank(w)
    t1 = EP.plan_to_tables(static_plan(e, 1), ep=1, slots_per_device=8)
    full1 = EP.materialise_slots(w, t1["slot_expert"], padded=padded)
    plan2 = LayerPlan(e, 1, np.array([3, 1, 1, 1], np.int64),
                      [[0, 0, 0], [0], [0], [0]])
    t2 = EP.plan_to_tables(plan2, ep=1, slots_per_device=8)
    full2 = EP.materialise_slots(w, t2["slot_expert"])
    inc = EP.materialise_slots(w, t2["slot_expert"], padded=padded,
                               prev={kk: v.clone() for kk, v in
                                     full1.items()},
                               prev_slot_expert=t1["slot_expert"])
    for kk in full2:
        assert torch.equal(full2[kk], inc[kk])
    again = EP.materialise_slots(w, t1["slot_expert"], prev=full1,
                                 prev_slot_expert=t1["slot_expert"])
    assert again is full1
    # degrees must factor the process group's ranks (one here), and a
    # mesh must be a ServingMesh
    with pytest.raises(ValueError, match="rank"):
        EP.check_degrees((1, 4, 1))
    assert EP.check_degrees([1, 1, 1]) == (1, 1, 1)
    with pytest.raises(ValueError, match="ServingMesh"):
        EP.EPContext(slots_per_device=8, capacity_factor=1.0,
                     mesh=(1, 4, 1))
    with pytest.raises(ValueError, match="ServingMesh"):
        EP.moe_ep_layer(_t(_x((1, 4, D), 0)), _t(_layer_params(e)["router"]),
                        full1, t1, num_experts=e, top_k=2,
                        slots_per_device=8, capacity_factor=1.0,
                        mesh=(1, 2, 2))
    with pytest.raises(TypeError):
        EP.moe_ep_layer(_t(_x((1, 4, D), 0)), _t(_layer_params(e)["router"]),
                        full1, t1, num_experts=e, top_k=2,
                        slots_per_device=8)
    assert dataclasses.replace(EP.EPContext(8, 1.0), pad_rows=2).pad_rows == 2
