"""PyTorch port, decoder: configs, the weight bridge, ``attention_block``
(scalar and per-row cache lengths) and ``decode_step`` (prefill into the
cache, then batched decode with per-row lengths and an inactive row)
against the JAX reference on the reference's own float32 weights.

Floats are held at atol=rtol=1e-4 (float32 through two layers, with
sums taken in different orders); greedy tokens and expert loads must be
equal.
"""
import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config, list_archs
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.params import from_jax

torch.set_num_threads(1)

TOL = 1e-4
# the attention-only decoders; the recurrent stacks (whose prefill into
# a cache the reference gets wrong) are held in tests/test_torch_hybrid.py
ATTN_ARCHS = ["mixtral-8x7b", "phi-3.5-moe", "grok-1-314b",
              "llama4-maverick-400b-a17b", "qwen2-72b", "qwen3-32b",
              "stablelm-12b", "command-r-plus-104b", "qwen2-vl-2b"]
# the recurrent stacks and the encoder-decoder (its decode is held in
# tests/test_torch_encdec.py)
ARCHS = ATTN_ARCHS + ["jamba-v0.1-52b", "xlstm-125m", "whisper-base"]
_jinit = jax.jit(JM.init_params, static_argnums=0)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """Float32 smoke configs of both packages and the reference's weights
    in both forms (read-only: no test writes to them)."""
    cfg = get_config(arch, smoke=True).with_(dtype="float32", impl="ref")
    jcfg = jget_config(arch, smoke=True).with_(dtype="float32", impl="ref")
    jp = _jinit(jcfg, jax.random.PRNGKey(3))
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_configs_equal_reference_field_by_field(arch, smoke):
    mine = dataclasses.asdict(get_config(arch, smoke=smoke))
    ref = dataclasses.asdict(jget_config(arch, smoke=smoke))
    mine.pop("impl"), ref.pop("impl")
    assert mine == ref
    assert list_archs() == sorted(ARCHS) == jlist_archs()


def test_from_jax_keeps_structure_and_bf16_bits():
    jcfg = jget_config("mixtral-8x7b", smoke=True)        # bfloat16
    jp = jax.tree.map(np.asarray, _jinit(jcfg, jax.random.PRNGKey(0)))
    tp = from_jax(jp)
    assert isinstance(tp["layers"], list) and len(tp["layers"]) == 1
    wg = tp["layers"][0]["moe"]["experts"]["w_gate"]
    ref = jp["layers"][0]["moe"]["experts"]["w_gate"]
    assert wg.dtype == torch.bfloat16 and tuple(wg.shape) == ref.shape
    assert wg.shape[0] == jcfg.num_layers        # stacked periods axis
    np.testing.assert_array_equal(wg.float().numpy(), ref.astype(np.float32))
    assert sum(a.size for a in jax.tree.leaves(jp)) == \
        M.count_params_analytic(get_config("mixtral-8x7b", smoke=True))


def test_init_params_shapes_and_device_default():
    cfg = get_config("phi-3.5-moe", smoke=True)
    tp = M.init_params(cfg, seed=1, device="cpu")
    jp = JM.abstract_params(jget_config("phi-3.5-moe", smoke=True))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    mine = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert mine == shapes
    assert tp["embed"].dtype == torch.bfloat16
    again = M.init_params(cfg, seed=1, device="cpu")
    assert torch.equal(tp["head"], again["head"])         # seeded
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            M.init_params(cfg)


@pytest.mark.parametrize("s,window", [(1, 0), (3, 0), (1, 6)])
@pytest.mark.parametrize("per_row", [False, True])
def test_attention_block_matches_reference(s, window, per_row):
    cfg, jcfg, jp, tp = _setup("mixtral-8x7b")
    pa_j = jax.tree.map(lambda a: a[0], jp["layers"][0]["attn"])
    pa_t = {k: v[0] for k, v in tp["layers"][0]["attn"].items()}
    b, smax = 3, 12
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((b, smax, cfg.num_kv_heads,
                              cfg.resolved_head_dim)).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    if per_row:
        cl = np.asarray([4, 11, 0], np.int32)
    else:
        cl = np.int32(5)
    base = cl[:, None] if per_row else cl
    pos = (base + np.arange(s, dtype=np.int32)[None]) \
        * np.ones((b, 1), np.int32)
    kv_pos = np.broadcast_to(np.arange(smax, dtype=np.int32), (b, smax))
    kv_pos = np.where(kv_pos < (cl[:, None] if per_row else cl), kv_pos,
                      -(10 ** 9)).astype(np.int32)
    jcache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
              "pos": jnp.asarray(kv_pos)}
    jy, jc = JL.attention_block(pa_j, jcfg, jnp.asarray(x),
                                jnp.asarray(pos), cache=jcache,
                                cache_len=jnp.asarray(cl), window=window,
                                impl="ref")
    tcache = {"k": torch.from_numpy(ck.copy()),
              "v": torch.from_numpy(cv.copy()),
              "pos": torch.from_numpy(kv_pos.copy())}
    ty, tc = L.attention_block(
        pa_t, cfg, torch.from_numpy(x), torch.from_numpy(pos),
        cache=tcache, cache_len=torch.from_numpy(cl) if per_row else int(cl),
        window=window, impl="auto")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)
    for k in ("k", "v", "pos"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=TOL, rtol=TOL)
    assert tc["k"] is tcache["k"]                  # written in place


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_decode_step_prefill_then_batched_decode(arch):
    """Prefill two prompts into the cache (scalar length), then decode
    greedily with per-row lengths, one row inactive for a step: logits
    allclose, tokens and expert loads equal at every step."""
    cfg, jcfg, jp, tp = _setup(arch)
    jstep = jax.jit(partial(JT.decode_step, jcfg, collect=True))
    b, plen, smax = 2, 6, 16
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (b, plen)).astype(np.int32)
    jcache = JT.init_cache(jcfg, jp, b, smax)
    tcache = T.init_cache(cfg, tp, b, smax)
    jl, jcache, jm = jstep(jp, {"tokens": jnp.asarray(toks)}, jcache,
                           jnp.asarray(0, jnp.int32))
    tl, tcache, tm = T.decode_step(cfg, tp, {"tokens": torch.from_numpy(
        toks)}, tcache, 0, collect=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    assert ("expert_load" in tm) == cfg.is_moe == ("expert_load" in jm)
    if cfg.is_moe:
        np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                      np.asarray(jm["expert_load"]))
        np.testing.assert_allclose(tm["gate_input"].numpy(),
                                   np.asarray(jm["gate_input"]), atol=TOL,
                                   rtol=TOL)
    lengths = np.asarray([plen, plen - 2], np.int32)
    cur = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    for step in range(4):
        active = np.asarray([True, step != 1])
        batch = {"tokens": cur[:, None], "active": active}
        jl, jcache, jm = jstep(jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                               jcache, jnp.asarray(lengths))
        tl, tcache, tm = T.decode_step(
            cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()},
            tcache, torch.from_numpy(lengths), collect=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        if cfg.is_moe:
            np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                          np.asarray(jm["expert_load"]))
            np.testing.assert_array_equal(tm["dropped"].numpy(),
                                          np.asarray(jm["dropped"]))
        jt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
        np.testing.assert_array_equal(
            torch.argmax(tl[:, -1], -1).numpy(), jt)
        cur = np.where(active, jt, cur).astype(np.int32)
        lengths = lengths + active.astype(np.int32)


def test_lm_head_pads_vocab():
    cfg = get_config("phi-3.5-moe", smoke=True).with_(vocab_size=500,
                                                      dtype="float32")
    tp = M.init_params(cfg, seed=0, device="cpu")
    x = torch.randn(1, 2, cfg.d_model)
    lg = T._lm_head(cfg, tp, x)
    assert lg.shape[-1] == cfg.padded_vocab == 512
    assert torch.all(lg[..., 500:] < -1e8)
