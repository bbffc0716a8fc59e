"""PyTorch port, MoE dispatch: ``models.moe`` against the JAX reference on
the same weights and inputs.

Integer outputs (expert loads, dropped counts, router indices) must be
exactly equal; floats (y, aux loss, router weights) allclose at
atol=rtol=1e-5 (float32 on both sides, sums in different orders). Under
forced overflow, equal dropped counts plus allclose y show that the two
packages keep the same token set: a token kept by one and dropped by the
other changes its output row by O(1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMOE
from repro_torch.models import moe as MOE
from repro_torch.params import from_jax

torch.set_num_threads(1)

TOL = 1e-5
D, F = 16, 32

# one compiled reference per shape instead of eager op-by-op dispatch
_JDISPATCH = jax.jit(JMOE.dispatch_moe, static_argnames=(
    "top_k", "num_experts", "capacity_factor", "act", "groups", "impl"))


def _params(e, seed=11):
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    jp = {"router": JMOE.init_router(ks[0], D, e, jnp.float32),
          "experts": JMOE.init_experts(ks[1], D, F, e, "swiglu",
                                       jnp.float32)}
    return jp, from_jax(jax.tree.map(np.asarray, jp))


def _both(e, k, cf, x, token_mask=None):
    jp, tp = _params(e)
    jy, jm = _JDISPATCH(
        jp, jnp.asarray(x), top_k=k, num_experts=e, capacity_factor=cf,
        token_mask=None if token_mask is None else jnp.asarray(token_mask),
        impl="ref")
    ty, tm = MOE.dispatch_moe(
        tp, torch.from_numpy(x), top_k=k, num_experts=e, capacity_factor=cf,
        token_mask=None if token_mask is None
        else torch.from_numpy(token_mask), impl="auto")
    return (np.asarray(jy), jax.tree.map(np.asarray, jm)), \
        (ty.numpy(), {k_: v.numpy() for k_, v in tm.items()})


def _assert_same(j, t):
    (jy, jm), (ty, tm) = j, t
    np.testing.assert_array_equal(tm["expert_load"], jm["expert_load"])
    assert tm["expert_load"].dtype == np.int32
    assert float(tm["dropped"]) == float(jm["dropped"])
    np.testing.assert_allclose(ty, jy, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tm["aux_loss"], jm["aux_loss"], atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tm["router_logits"], jm["router_logits"],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cf", [0.25, 0.5, 1.0, 1.25, 4.0])
def test_dispatch_matches_reference_under_overflow(cf):
    """Forced overflow (cf < 1): equal drops and kept sets."""
    e, k = 4, 2
    x = np.random.default_rng(1).standard_normal((2, 8, D)) \
        .astype(np.float32)
    j, t = _both(e, k, cf, x)
    _assert_same(j, t)
    if cf < 1:
        assert float(j[1]["dropped"]) > 0      # the overflow is real


@pytest.mark.parametrize("e,k", [(1, 1), (4, 4), (8, 2)])
def test_dispatch_matches_reference_edge_routings(e, k):
    """E=1, top_k=E, and a wider expert set."""
    x = np.random.default_rng(2).standard_normal((3, 5, D)) \
        .astype(np.float32)
    _assert_same(*_both(e, k, 0.75, x))


def test_dispatch_token_mask_excludes_from_metrics_not_capacity():
    """Inactive tokens occupy capacity (they decide which active tokens
    drop) but are excluded from loads and drops — same on both sides."""
    e, k = 4, 2
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 3, D)).astype(np.float32)
    mask = rng.random((4, 3)) < 0.5
    j, t = _both(e, k, 0.5, x, token_mask=mask)
    _assert_same(j, t)
    unmasked = _both(e, k, 0.5, x)
    np.testing.assert_allclose(t[0], unmasked[1][0], atol=TOL, rtol=TOL)


def test_router_ties_lower_index_first():
    logits = np.asarray([[1.0, 1.0, 1.0, 1.0], [0.0, 2.0, 2.0, 1.0],
                         [3.0, -1.0, 3.0, 3.0]], np.float32)
    jw, ji = jax.lax.top_k(jnp.asarray(logits), 2)
    tw, ti, _ = MOE.router_topk(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), [[0, 1], [1, 2], [0, 2]])
    jw2, ji2, jp2 = JMOE.router_topk(jnp.asarray(logits), 2)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw2), atol=TOL)


def test_dispatch_all_tied_router():
    """Zero hidden states tie every router logit: the lower experts take
    every assignment in both packages, and capacity overflows alike."""
    x = np.zeros((2, 6, D), np.float32)
    x[0, :3] = np.random.default_rng(4).standard_normal((3, D))
    j, t = _both(4, 2, 0.5, x)
    _assert_same(j, t)
