"""The float32 reference against the port on the CPU: its routing rules
against the port's dispatch at capacities that drop, and whole runs of
the harness's comparison path at smoke sizes."""
from __future__ import annotations

import math

import pytest
import torch

from perfbench.reference import moe_decoder as REF
from perfbench.tests import _smoke


def _bank(gen, e, d, f):
    return {"w_gate": torch.randn(e, d, f, generator=gen) / math.sqrt(d),
            "w_up": torch.randn(e, d, f, generator=gen) / math.sqrt(d),
            "w_down": torch.randn(e, f, d, generator=gen) / math.sqrt(f)}


def _ref_moe(h, router, bank, keep, e, k, fmt="bf16"):
    arch = REF.Arch(d_model=h.shape[1], num_heads=1, num_kv_heads=1,
                    head_dim=h.shape[1], num_experts=e, top_k=k,
                    d_ff=bank["w_up"].shape[2], vocab_size=1,
                    rope_theta=1e4, norm_eps=1e-6, capacity_factor=1.0,
                    expert_format=fmt)
    return REF.moe(h, {"router": router}, arch, REF.FP32,
                   lambda i: tuple(REF.FP32.expert(bank[n][i], fmt)
                                   for n in ("w_gate", "w_up", "w_down")),
                   keep=keep)[0]


@pytest.mark.parametrize("cf,groups", [(0.5, 1), (1.0, 2), (4.0, 1)])
def test_gshard_rule_equals_the_port_dispatch(cf, groups):
    """At a capacity that drops (cf 0.5, 1.0) and one that cannot (4.0),
    the reference's rule gives the port's GShard dispatch output."""
    from repro_torch.models.moe import dispatch_moe
    gen = torch.Generator().manual_seed(3)
    t, d, f, e, k = 64, 16, 24, 4, 2
    h = torch.randn(t, d, generator=gen)
    router = torch.randn(d, e, generator=gen)
    bank = _bank(gen, e, d, f)
    y, m = dispatch_moe({"router": {"w_gate": router}, "experts": bank},
                        h[None], top_k=k, num_experts=e,
                        capacity_factor=cf, groups=groups, impl="ref")
    ref = _ref_moe(h, router, bank,
                   lambda idx: REF.keep_gshard(idx, e, cf, groups), e, k)
    assert float(m["dropped"]) > 0 or cf >= e / k
    torch.testing.assert_close(y[0], ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("nrep", [[1, 1, 1, 1], [3, 1, 2, 1], [10, 1, 2, 1]])
def test_slot_rule_equals_the_port_ep_plane(nrep):
    """The EP slot plane with replicas and per-slot capacity (int8 banks,
    a capacity that drops) against the reference's slot rule."""
    from repro_torch.distributed.ep import (materialise_slots,
                                            moe_ep_layer, plan_to_tables)
    from repro_torch.core.plan import LayerPlan
    from repro_torch.kernels import quant as QT
    gen = torch.Generator().manual_seed(4)
    t, d, f, e, k, cf = 48, 16, 24, 4, 2, 0.75
    h = torch.randn(t, d, generator=gen)
    router = torch.randn(d, e, generator=gen)
    bank = _bank(gen, e, d, f)
    # ten replicas on 8 devices: two of them share one (expert, device)
    # instance, so one slot, as the runtime's tables have it
    placement = [[(ee * 3 + r) % 8 for r in range(n)]
                 for ee, n in enumerate(nrep)]
    plan = LayerPlan(num_experts=e, num_devices=8,
                     replicas=torch.tensor(nrep).numpy(),
                     placement=placement)
    tables = plan_to_tables(plan, ep=1, slots_per_device=16)
    slots = materialise_slots(QT.quantize_expert_bank(bank),
                              tables["slot_expert"])
    y, m = moe_ep_layer(h[None], router, slots, tables, num_experts=e,
                        top_k=k, slots_per_device=16, capacity_factor=cf,
                        impl="ref")
    keys = -torch.ones((e, max(nrep)), dtype=torch.long)
    for ee, pl in enumerate(placement):
        keys[ee, :len(pl)] = torch.tensor([ee * 8 + g for g in pl])
    ref = _ref_moe(h, router, bank,
                   lambda idx: REF.keep_slots(idx, keys, cf, e), e, k,
                   fmt="int8")
    assert float(m["dropped"]) > 0
    torch.testing.assert_close(y[0].float(), ref, atol=1e-4, rtol=1e-4)


def test_int8_rule_equals_the_port_quantizer():
    from repro_torch.kernels import quant as QT
    w = torch.randn(3, 40, 24, generator=torch.Generator().manual_seed(5))
    q, s = QT.quantize_rows(w)
    torch.testing.assert_close(REF.dequantize_rows(w),
                               q.float() * s[..., None], atol=0, rtol=0)


@pytest.mark.parametrize("name", ["mixtral.batch", "phi.moeless.rag"])
def test_harness_run_is_correct_against_the_reference(name):
    """A float32 smoke run of the cell through the harness: following
    the program's routes and the capacity rule of each call (which the
    engine's reported loads and drops confirm), every served token is
    the reference's own first choice; the control (float8, int4 banks)
    reads wide gaps."""
    res, readings, ctx = _smoke.run(name, control=True)
    got, ctl = readings["program"], readings["control"]
    assert res["correct"] and got["tokens"] >= 100
    assert got["widest_gap"] == 0.0 and got["route_gap"] == 0.0
    assert ctl["widest_gap"] > 0.1 and ctl["route_gap"] > 0.01
    assert res["checks"]["load_mismatch"]["value"] == 0
    assert res["checks"]["drop_mismatch"]["value"] == 0
    assert readings["calls"] > 20
