"""PyTorch port, the decoder-only model families (grok-1, llama4-maverick,
qwen2, qwen3, stablelm, command-r+, qwen2-vl) against the JAX reference
on the reference's own float32 weights: ``forward``, ``ServingEngine`` on
contiguous and paged-chunked KV (with a ``MoElessController`` for the
MoE families), llama4's dense/MoE interleave with the expert runtime on
and off, qwen2-vl's vision embeddings and M-RoPE, a sliding-window ring
cache, layernorm, ``input_specs`` and the weight bridge. ``decode_step``
(prefill into the cache, then batched decode at per-row lengths with an
inactive row) is held for every arch in ``tests/test_torch_model.py``.

Tolerance: floats atol = rtol = 1e-4, as in ``tests/test_torch_model.py``
(float32 through two to four layers, sums taken in other orders). Exact:
greedy tokens, ``expert_load``, ``dropped``, the engines' counters and
records, the controller's plans and modeled clock, the runtime meters.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ServingSpec as JServingSpec
from repro.configs import get_config as jget_config
from repro.configs.base import InputShape as JInputShape
from repro.core.control import MoElessController as JMoElessController
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.scheduler import GenRequest as JGenRequest
from repro_torch.configs import ServingSpec, get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.control import MoElessController
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import GenRequest

torch.set_num_threads(1)

TOL = 1e-4
FAMILIES = ["grok-1-314b", "llama4-maverick-400b-a17b", "qwen2-72b",
            "qwen3-32b", "stablelm-12b", "command-r-plus-104b",
            "qwen2-vl-2b"]
_jinit = jax.jit(JM.init_params, static_argnums=0)


@functools.lru_cache(maxsize=None)
def _setup(arch, every_n=1, num_layers=2, drop_free=False):
    """Float32 smoke configs of both packages (optionally at llama4's
    interleave, another depth, or the drop-free capacity factor) and the
    reference's weights in both forms (read-only: no test writes to
    them)."""
    cfg = get_config(arch, smoke=True).with_(dtype="float32",
                                             num_layers=num_layers)
    jcfg = jget_config(arch, smoke=True).with_(dtype="float32", impl="ref",
                                               num_layers=num_layers)
    if cfg.is_moe:
        kw = {"every_n_layers": every_n}
        if drop_free:
            kw["capacity_factor"] = float(cfg.moe.num_experts)
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **kw))
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, **kw))
    jp = _jinit(jcfg, jax.random.PRNGKey(3))
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


def _close(got, want, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL, err_msg=what)


def _exact_moe_metrics(tm, jm):
    assert ("expert_load" in tm) == ("expert_load" in jm)
    if "expert_load" in jm:
        np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                      np.asarray(jm["expert_load"]))
        np.testing.assert_array_equal(tm["dropped"].numpy(),
                                      np.asarray(jm["dropped"]))


def _tokens(cfg, shape, seed=11):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------ model


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference(arch):
    cfg, jcfg, jp, tp = _setup(arch)
    toks = _tokens(cfg, (2, 9))
    jl, jm = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        collect=True)
    tl, tm = T.forward(cfg, tp, {"tokens": torch.from_numpy(toks)},
                       collect=True)
    _close(tl, jl, "logits")
    np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(),
                                  np.asarray(jnp.argmax(jl, -1)))
    _exact_moe_metrics(tm, jm)
    if cfg.is_moe:
        _close(tm["gate_input"], jm["gate_input"], "gate_input")


# ------------------------------------------------------------ serving

# (prompt_len, max_new_tokens): more requests than slots, all at t=0 so
# that a dense model's wall-clock serving clock cannot change admission
TRACE = [(5, 6), (9, 3), (3, 7), (11, 4), (7, 5)]
KV = {"contiguous": ServingSpec(),
      "paged_chunked": ServingSpec(kv="paged", kv_block=4, prefill_chunk=5)}


def _reqs(cls, cfg, seed=9):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, arrival=0.0,
                prompt=rng.integers(0, cfg.vocab_size, size=pl,
                                    dtype=np.int32),
                max_new_tokens=n)
            for i, (pl, n) in enumerate(TRACE)]


def _serve_both(cfg, jcfg, jp, tp, kv, num_devices=4, **eng_kw):
    """The same requests through both packages' engines, with a session
    MoElessController over `num_devices` for a MoE config. Returns
    (port, reference) as (requests, result, controller)."""
    spec = KV[kv]
    out = []
    for eng_cls, req_cls, ctrl_cls, c, p, sp in (
            (ServingEngine, GenRequest, MoElessController, cfg, tp, spec),
            (JServingEngine, JGenRequest, JMoElessController, jcfg, jp,
             JServingSpec(**dataclasses.asdict(spec)))):
        kw = dict(eng_kw)
        if eng_cls is JServingEngine and kw.get("expert_runtime") == "on":
            kw["mesh"] = jax.make_mesh(
                (1, 1, 1), ("data", "ep", "tp"),
                axis_types=(jax.sharding.AxisType.Auto,) * 3)
        ctrl = ctrl_cls(c, num_devices=num_devices) if c.is_moe else None
        reqs = _reqs(req_cls, cfg)
        res = eng_cls(c, p, max_len=24, serving=sp, **kw).serve(
            reqs, num_slots=3, control=ctrl, time_scale=50.0)
        out.append((reqs, res, ctrl))
    return out


def _assert_served_equal(mine, ref):
    (reqs, res, ctrl), (jreqs, jres, jctrl) = mine, ref
    assert [list(r.tokens) for r in reqs] == [list(r.tokens) for r in jreqs]
    assert [r.finish_reason for r in reqs] == \
        [r.finish_reason for r in jreqs]
    assert all(len(r.tokens) == n for r, (_, n) in zip(reqs, TRACE))
    for k in ("iterations", "prefills", "rejected", "cancelled",
              "dropped_tokens"):
        assert getattr(res, k) == getattr(jres, k), k
    if ctrl is None:
        return
    # the modeled clock makes every record deterministic
    assert res.clock_s == jres.clock_s
    rows = lambda rs: sorted(map(dataclasses.astuple, rs))     # noqa: E731
    assert rows(res.records) == rows(jres.records)
    assert ctrl.iterations == jctrl.iterations
    assert ctrl.layer_latency == jctrl.layer_latency
    assert ctrl.cost == jctrl.cost
    assert len(ctrl.plans) == len(jctrl.plans)
    for p, jp_ in zip(ctrl.plans + ctrl.last_plans,
                      jctrl.plans + jctrl.last_plans):
        np.testing.assert_array_equal(p.replicas, jp_.replicas)
        assert p.placement == jp_.placement


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_matches_reference(arch, kv):
    cfg, jcfg, jp, tp = _setup(arch)
    _assert_served_equal(*_serve_both(cfg, jcfg, jp, tp, kv))


@pytest.mark.parametrize("runtime", ["off", "on"])
def test_llama4_interleave_matches_reference(runtime):
    """llama4 at its published ``every_n_layers=2`` (which the smoke
    config drops), 4 layers: a dense FFN and a MoE period each.
    ``forward``'s loads come in period-major order; served tokens,
    plans, the modeled clock and (runtime on) the runtime's meters
    equal the reference's."""
    cfg, jcfg, jp, tp = _setup("llama4-maverick-400b-a17b", every_n=2,
                               num_layers=4, drop_free=runtime == "on")
    assert [s.ffn for s in T.layer_pattern(cfg)] == ["dense", "moe"]
    assert "ffn" in tp["layers"][0] and "moe" in tp["layers"][1]
    toks = _tokens(cfg, (2, 9))
    jl, jm = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, tm = T.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, "logits")
    assert tm["expert_load"].shape == (2, cfg.moe.num_experts)
    _exact_moe_metrics(tm, jm)
    # the runtime's slots: 8 devices, as tests/test_torch_expert_runtime
    kw = {"expert_runtime": "on", "num_devices": 8} if runtime == "on" \
        else {}
    mine, ref = _serve_both(cfg, jcfg, jp, tp, "contiguous", **kw)
    _assert_served_equal(mine, ref)
    assert mine[2].n_layers == 2
    if runtime == "on":
        res, jres = mine[1], ref[1]
        st = dataclasses.asdict(res.runtime.finalize(res.clock_s))
        assert st == dataclasses.asdict(jres.runtime.finalize(jres.clock_s))
        assert st["transfers"] > 0
        assert res.runtime.moe_positions == [1]


# ------------------------------------------------------------ qwen2-vl


def test_qwen2_vl_forward_with_vision_embeddings():
    """Early fusion (patch embeddings replace a prefix of the tokens'
    embeddings) with 3-axis M-RoPE positions, through ``forward`` and
    ``decode_step``."""
    cfg, jcfg, jp, tp = _setup("qwen2-vl-2b")
    b, s = 2, 10
    rng = np.random.default_rng(4)
    toks = _tokens(cfg, (b, s))
    vis = (rng.standard_normal((b, s, cfg.d_model)) * 0.02).astype(
        np.float32)
    mask = np.broadcast_to(np.arange(s)[None] < 4, (b, s)).copy()
    pos = rng.integers(0, s, (b, s, 3)).astype(np.int32)
    batch = {"tokens": toks, "vis_embeds": vis, "vis_mask": mask,
             "positions": pos}
    jl, _ = JT.forward(jcfg, jp, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    tl, _ = T.forward(cfg, tp, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    _close(tl, jl, "forward")
    jcache = JT.init_cache(jcfg, jp, b, 16)
    tcache = T.init_cache(cfg, tp, b, 16)
    jl, _, _ = JT.decode_step(jcfg, jp, {k: jnp.asarray(v)
                                         for k, v in batch.items()},
                              jcache, jnp.asarray(0, jnp.int32))
    tl, _, _ = T.decode_step(cfg, tp, {k: torch.from_numpy(v)
                                       for k, v in batch.items()},
                             tcache, 0)
    _close(tl, jl, "decode_step")
    # the vision rows really changed the logits
    plain, _ = T.forward(cfg, tp, {"tokens": torch.from_numpy(toks),
                                   "positions": torch.from_numpy(pos)})
    assert not torch.allclose(plain, tl)


def test_mrope_matches_reference_and_equals_rope_on_text():
    cfg = get_config("qwen2-vl-2b", smoke=True).with_(dtype="float32")
    hd, theta = cfg.resolved_head_dim, cfg.rope_theta
    rng = np.random.default_rng(2)
    pos3 = rng.integers(0, 4096, (2, 7, 3)).astype(np.int32)
    jc, js = JL.mrope_cos_sin(jnp.asarray(pos3), hd, theta)
    tc, ts = L.mrope_cos_sin(torch.from_numpy(pos3), hd, theta)
    _close(tc, jc, "cos")
    _close(ts, js, "sin")
    # identical axes: M-RoPE is 1-D RoPE bit for bit, in the sublayer too
    pos = torch.from_numpy(pos3[..., 0].copy())
    mc, ms = L.mrope_cos_sin(pos[..., None].expand(2, 7, 3), hd, theta)
    rc, rs = L.rope_cos_sin(pos, hd, theta)
    assert torch.equal(mc, rc) and torch.equal(ms, rs)
    _, _, _, tp = _setup("qwen2-vl-2b")
    pa = {k: v[0] for k, v in tp["layers"][0]["attn"].items()}
    x = torch.from_numpy(rng.standard_normal((2, 7, cfg.d_model)).astype(
        np.float32))
    ym, _ = L.attention_block(pa, cfg, x, pos)
    yr, _ = L.attention_block(pa, cfg.with_(rope="rope"), x, pos)
    assert torch.equal(ym, yr)


# ------------------------------------------------------------ pieces


def test_sliding_window_ring_cache_wraps():
    """qwen3 with a window-8 ring cache of 8 slots over 12 decode steps
    (the reference's ``test_sliding_window_variant_runs``), held step by
    step to the reference."""
    cfg, jcfg, jp, tp = _setup("qwen3-32b")
    jcache = JT.init_cache(jcfg, jp, 1, 8)
    tcache = T.init_cache(cfg, tp, 1, 8)
    jstep = JM.make_serve_step(jcfg, window=8)
    tstep = M.make_serve_step(cfg, window=8)
    toks = _tokens(cfg, (12, 1, 1))
    for i in range(12):
        jl, jcache = jstep(jp, {"tokens": jnp.asarray(toks[i])}, jcache,
                           jnp.asarray(i, jnp.int32))
        tl, tcache = tstep(tp, {"tokens": torch.from_numpy(toks[i])},
                           tcache, i)
        _close(tl, jl, f"step {i}")
    assert torch.isfinite(tl).all()
    np.testing.assert_array_equal(tcache[0]["attn"]["pos"].numpy(),
                                  np.asarray(jcache[0]["attn"]["pos"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_init_norm_match_reference(dtype):
    rng = np.random.default_rng(6)
    d = 48
    x = rng.standard_normal((3, 5, d)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    jy = JL.layer_norm(jnp.asarray(x, dtype), jnp.asarray(w),
                       jnp.asarray(bias))
    ty = L.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(w), torch.from_numpy(bias))
    assert ty.dtype == getattr(torch, dtype)
    # bfloat16 outputs are one rounding of the same float32 values
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), atol=TOL,
                               rtol=TOL if dtype == "float32" else 1e-2)
    for kind in ("rmsnorm", "layernorm"):
        jn = JL.init_norm(None, d, kind, jnp.dtype(dtype))
        tn = L.init_norm(d, kind, getattr(torch, dtype), "cpu")
        assert sorted(tn) == sorted(jn)
        for k in jn:
            assert str(tn[k].dtype).split(".")[-1] == str(jn[k].dtype)
            np.testing.assert_array_equal(tn[k].float().numpy(),
                                          np.asarray(jn[k], np.float32))


def _spec_sig(batch):
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1].replace(
        "bool_", "bool")) for k, v in batch.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_input_specs_match_reference(arch):
    cfg = get_config(arch, smoke=True)
    jcfg = jget_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(0)
    for kind in ("train", "prefill", "decode"):
        shape = InputShape("t", 16, 2, kind)
        jshape = JInputShape("t", 16, 2, kind)
        want = _spec_sig(JM.input_specs(jcfg, jshape, abstract=True))
        got = M.input_specs(cfg, shape, abstract=True)
        assert all(v.device.type == "meta" for v in got.values())
        assert _spec_sig(got) == want
        jc = JM.input_specs(jcfg, jshape, abstract=False,
                            key=jax.random.PRNGKey(0))
        tc = M.input_specs(cfg, shape, abstract=False, generator=gen,
                           device="cpu")
        assert _spec_sig(tc) == _spec_sig(jc) == want
        assert int(tc["tokens"].max()) < cfg.vocab_size
        if "vis_mask" in jc:
            np.testing.assert_array_equal(tc["vis_mask"].numpy(),
                                          np.asarray(jc["vis_mask"]))
            assert int(tc["positions"].max()) < shape.seq_len
    with pytest.raises(ValueError, match="generator"):
        M.input_specs(cfg, InputShape("t", 4, 1, "train"), abstract=False,
                      device="cpu")


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{pre}/{i}")
    else:
        yield pre, tree


# the leaves this slice adds to the weight trees
NEW_LEAVES = {
    "stablelm-12b": ["/layers/0/norm1/bias", "/final_norm/bias"],
    "command-r-plus-104b": ["/layers/0/norm2/bias", "/final_norm/bias"],
    "qwen2-72b": ["/layers/0/attn/bq", "/layers/0/attn/bk",
                  "/layers/0/attn/bv"],
    "qwen2-vl-2b": ["/layers/0/attn/bq"],
    "qwen3-32b": ["/layers/0/attn/q_norm", "/layers/0/attn/k_norm"],
    "llama4-maverick-400b-a17b": ["/layers/0/ffn/w_gate",
                                  "/layers/1/moe/experts/w_down"],
    "grok-1-314b": ["/layers/0/moe/router/w_gate"],
}


@pytest.mark.parametrize("arch", FAMILIES)
def test_from_jax_and_init_params_field_by_field(arch):
    """The reference's bfloat16 tree through ``from_jax``: the same
    paths, shapes, dtypes and bits leaf for leaf; the port's own
    ``init_params`` builds the same paths, shapes and dtypes."""
    jcfg = jget_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    if cfg.is_moe and arch.startswith("llama4"):
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, every_n_layers=2))
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, every_n_layers=2))
    jp = jax.tree.map(np.asarray, _jinit(jcfg, jax.random.PRNGKey(1)))
    tp = from_jax(jp)
    want = dict(_paths(jp))
    got = dict(_paths(tp))
    assert sorted(got) == sorted(want)
    for path in NEW_LEAVES[arch]:
        assert path in got, path
    assert ("/head" in got) == (not cfg.tie_embeddings)
    for path, ref in want.items():
        t = got[path]
        assert tuple(t.shape) == ref.shape, path
        assert str(t.dtype).split(".")[-1] == str(ref.dtype), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      ref.astype(np.float32), err_msg=path)
    mine = dict(_paths(M.init_params(cfg, seed=2, device="cpu")))
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in got.items()}
    # the analytic count covers the new leaves (layernorm biases too)
    assert M.count_params_analytic(cfg) == sum(a.size for a in want.values())
    assert M.count_params_analytic(cfg, active_only=True) == \
        JM.count_params_analytic(jcfg, active_only=True)
