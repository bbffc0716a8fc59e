"""PyTorch port, kernel modules: the plain versions of fused_gate_up, gmm,
expert_ffn and decode_attention against the JAX oracles and the JAX
Pallas kernels (interpret mode) on the same numpy inputs, and the
``impl`` knob. The CUDA kernels against their plain versions are in
``test_torch_kernels_cuda.py``, which runs on the card without JAX.

Tolerances: float32 atol=rtol=1e-5 (both sides are float32 sums over at
most a few hundred terms, in different orders); bfloat16 atol=rtol=2e-2
compared in float32 (each side rounds its matmul outputs to bf16 at
different points).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attn as JDA
from repro.kernels import moe_gmm as JMG
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro_torch.kernels import decode_attn as DA
from repro_torch.kernels import moe_gmm as MG
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import ref as REF

torch.set_num_threads(1)

F32_TOL = 1e-5


def _gmm_case(e, c, d, f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    wg = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    wd = (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)
    return x, wg, wu, wd


# (E, C, D, F, group sizes): non-MXU-aligned C7/D96/F40, all-zero group
# sizes, one partially filled expert, E=1
GMM_CASES = [
    (3, 7, 96, 40, [7, 3, 0]),
    (2, 16, 96, 40, [0, 0]),
    (4, 9, 64, 72, [0, 0, 5, 0]),
    (1, 12, 32, 48, [12]),
]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", GMM_CASES)
def test_fused_gate_up_plain_matches_jax(case):
    e, c, d, f, gs = case
    x, wg, wu, _ = _gmm_case(e, c, d, f)
    gs = np.asarray(gs, np.int32)
    got = MG.fused_gate_up(_t(x), _t(wg), _t(wu), _t(gs)).numpy()
    pallas = np.asarray(JMG.fused_gate_up(jnp.asarray(x), jnp.asarray(wg),
                                          jnp.asarray(wu), jnp.asarray(gs),
                                          interpret=True))
    np.testing.assert_allclose(got, pallas, atol=F32_TOL, rtol=F32_TOL)
    # the oracle's h: silu(x@Wg) * (x@Wu), rows past the group zeroed
    jx = jnp.asarray(x)
    h = jax.nn.silu(JREF.gmm_ref(jx, jnp.asarray(wg), jnp.asarray(gs))) \
        * JREF.gmm_ref(jx, jnp.asarray(wu), jnp.asarray(gs))
    np.testing.assert_allclose(got, np.asarray(h), atol=F32_TOL,
                               rtol=F32_TOL)
    assert np.all(got[np.arange(c)[None] >= gs[:, None]] == 0)


@pytest.mark.parametrize("case", GMM_CASES)
def test_gmm_plain_matches_jax(case):
    e, c, d, f, gs = case
    x, wg, _, _ = _gmm_case(e, c, d, f, seed=1)
    gs = np.asarray(gs, np.int32)
    got = MG.gmm(_t(x), _t(wg), _t(gs)).numpy()
    jx, jw, jg = jnp.asarray(x), jnp.asarray(wg), jnp.asarray(gs)
    np.testing.assert_allclose(got, np.asarray(JREF.gmm_ref(jx, jw, jg)),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(
        got, np.asarray(JMG.gmm(jx, jw, jg, interpret=True)),
        atol=F32_TOL, rtol=F32_TOL)
    assert np.all(got[np.arange(c)[None] >= gs[:, None]] == 0)


@pytest.mark.parametrize("case", GMM_CASES[:2])
@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_expert_ffn_matches_jax(case, impl):
    e, c, d, f, gs = case
    x, wg, wu, wd = _gmm_case(e, c, d, f, seed=2)
    gs = np.asarray(gs, np.int32)
    got = OPS.expert_ffn_impl(_t(x), _t(wg), _t(wu), _t(wd), _t(gs),
                              impl).numpy()
    jargs = list(map(jnp.asarray, (x, wg, wu, wd, gs)))
    np.testing.assert_allclose(got, np.asarray(JREF.expert_ffn_ref(*jargs)),
                               atol=F32_TOL, rtol=F32_TOL)
    # the Pallas composition (fused gate/up kernel, then the gmm kernel)
    np.testing.assert_allclose(
        got, np.asarray(JOPS.expert_ffn_impl(*jargs, "pallas_interpret")),
        atol=F32_TOL, rtol=F32_TOL)


def test_expert_ffn_bf16_matches_jax():
    e, c, d, f, gs = GMM_CASES[0]
    x, wg, wu, wd = _gmm_case(e, c, d, f, seed=3)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, wg, wu, wd)]
    targs = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
             for a in jargs]
    gs = np.asarray(gs, np.int32)
    got = REF.expert_ffn_ref(*targs, _t(gs)).float().numpy()
    want = np.asarray(JREF.expert_ffn_ref(*jargs, jnp.asarray(gs)),
                      np.float32)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def _attn_case(b, h, kvh, hd, s, kv_len, q_pos, wrap, seed=0, past=None):
    """Seeded inputs; with `past`, k and v hold that value in every lane
    at or past the row's kv_len."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    kv_len = np.asarray(kv_len, np.int32)
    q_pos = np.asarray(q_pos, np.int32)
    if past is not None:
        for r in range(b):
            k[r, kv_len[r]:] = past
            v[r, kv_len[r]:] = past
    slot = np.arange(s, dtype=np.int32)[None]
    if wrap:   # ring holding the last s positions up to q_pos
        pos = q_pos[:, None] - np.mod(q_pos[:, None] - slot, s)
    else:
        pos = np.broadcast_to(slot, (b, s))
    return q, k, v, np.ascontiguousarray(pos, np.int32), kv_len, q_pos


# (B, H, KV, hd, S, kv_len, q_pos, wrapped ring, window, past): GQA
# groups 1/2/4, kv_len < S, wrapped ring positions, window > 0; then rows
# with no visible lane (kv_len = 0, hidden by position, hidden by the
# window), which average v over all S lanes, beside rows whose lanes
# past kv_len hold 1e4 (`past`) that must weigh nothing
ATTN_CASES = [
    (2, 4, 4, 32, 24, [24, 10], [23, 9], False, 0, None),
    (3, 8, 4, 16, 20, [20, 1, 7], [19, 0, 6], False, 0, None),
    (2, 8, 2, 32, 40, [17, 40], [16, 39], False, 0, None),
    (2, 4, 1, 16, 16, [16, 16], [40, 16], True, 0, None),
    (2, 8, 2, 16, 32, [32, 21], [31, 20], False, 8, None),
    (2, 4, 2, 16, 12, [12, 12], [50, 23], True, 5, None),
    (3, 8, 2, 16, 24, [0, 10, 13], [5, -1, 12], False, 0, 1e4),
    (2, 4, 2, 16, 20, [20, 12], [19, 100], False, 8, 1e4),
    (2, 2, 2, 18, 12, [7, 0], [6, 3], False, 0, 1e4),
    (2, 8, 1, 64, 16, [9, 16], [8, 200], True, 6, 1e4),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_decode_attention_plain_matches_jax(case):
    b, h, kvh, hd, s, kl, qp, wrap, window, past = case
    q, k, v, pos, kv_len, q_pos = _attn_case(b, h, kvh, hd, s, kl, qp, wrap,
                                             past=past)
    got = DA.decode_attention(*map(_t, (q, k, v, pos, kv_len, q_pos)),
                              window=window).numpy()
    jargs = list(map(jnp.asarray, (q, k, v, pos, kv_len, q_pos)))
    np.testing.assert_allclose(
        got, np.asarray(JDA.decode_attention_ref(*jargs, window=window)),
        atol=F32_TOL, rtol=F32_TOL)
    # the Pallas kernel needs S to be a multiple of its slot block
    np.testing.assert_allclose(
        got, np.asarray(JDA.decode_attention(*jargs, window=window,
                                             bs=math.gcd(s, 8),
                                             interpret=True)),
        atol=F32_TOL, rtol=F32_TOL)


def test_impl_knob():
    x = torch.zeros((1, 2, 4))
    w = torch.zeros((1, 4, 4))
    gs = torch.ones(1, dtype=torch.int32)
    for bad in ("pallas", "pallas_interpret", "triton"):
        with pytest.raises(ValueError):
            OPS.resolve_impl(bad)
    with pytest.raises(ValueError, match="CUDA"):
        OPS.expert_ffn_impl(x, w, w, w, gs, "cuda")
    with pytest.raises(ValueError, match="CUDA"):
        OPS.gmm_impl(x, w, gs, "cuda")
    q = torch.zeros((1, 2, 4))
    kv = torch.zeros((1, 3, 1, 4))
    pos = torch.zeros((1, 3), dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        OPS.decode_attention_impl(q, kv, kv, pos, one, one, window=0,
                                  impl="cuda")
    assert not OPS.use_kernel("auto", x) and not OPS.use_kernel("ref", x)
