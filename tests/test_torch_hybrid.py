"""PyTorch port, the recurrent stacks: jamba-v0.1-52b (mamba + attention
1:7, MoE every 2) and xlstm-125m (mLSTM/sLSTM) against the JAX reference
on the reference's own float32 weights: ``forward``, prefill into a
cache and batched decode, the batch API and ``engine.serve`` (jamba
with a ``MoElessController``, the expert runtime off and on), the paged
layout's refusal, and the slot pool's splice of recurrent state.

The oracle. The reference prefills a prompt into a cache through its
one-token mixer steps, which read the first prompt token only
(``repro.models.transformer._apply_sublayer``), so its
``decode_step(S > 1)`` and its engine are wrong for these two archs
(``test_prefill_into_cache_fixes_the_reference_fault`` pins it). The
port's prefill is held instead to the reference's ``forward`` over the
prompt (the same tokens in one MoE dispatch: the same capacity, so
``expert_load`` and ``dropped`` are exact at any capacity factor) and,
for decode and the engines, to the reference's ``decode_step`` fed the
prompt one token at a time (``_OracleEngine``), at a capacity factor
where neither path drops a token (``dropped == 0`` asserted on both):
the MoE dispatch of one token at a time then routes as one dispatch of
all of them.

Tolerance: floats atol = rtol = 1e-4, as ``tests/test_torch_model.py``;
the fault check's 2e-3 is the reference's own prefill check
(``tests/test_engine.py``). Exact: greedy tokens, ``expert_load``,
``dropped``, the engines' counters and records, the controller's plans
and modeled clock, the runtime's meters.
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
from repro.core.control import MoElessController as JMoElessController
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.scheduler import GenRequest as JGenRequest
from repro.configs.base import InputShape as JInputShape
from repro_torch.configs import ServingSpec, get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.control import MoElessController
from repro_torch.launch import serve as LS
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv import PagedKVCache, SlotKVCache
from repro_torch.serving.scheduler import GenRequest

torch.set_num_threads(1)

TOL = 1e-4
ARCHS = ["jamba-v0.1-52b", "xlstm-125m"]
_jinit = jax.jit(JM.init_params, static_argnums=0)


@functools.lru_cache(maxsize=None)
def _setup(arch, drop_free=False):
    """Float32 smoke configs of both packages (jamba's optionally at the
    drop-free capacity factor E) and the reference's weights in both
    forms (read-only: no test writes to them)."""
    cfg = get_config(arch, smoke=True).with_(dtype="float32", impl="ref")
    jcfg = jget_config(arch, smoke=True).with_(dtype="float32", impl="ref")
    if drop_free and cfg.is_moe:
        cf = float(cfg.moe.num_experts)
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe,
                                                  capacity_factor=cf))
    jp = _jinit(jcfg, jax.random.PRNGKey(3))
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


def _tokens(cfg, shape, seed=11):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _token_by_token(step):
    """The reference's decode step, a prompt of S > 1 tokens fed to it
    one token at a time: logits concatenated, expert loads and drops
    summed, gate inputs concatenated over the tokens."""
    def run(params, batch, cache, cache_len, *ep):
        s = batch["tokens"].shape[1]
        if s == 1:
            return step(params, batch, cache, cache_len, *ep)
        outs = []
        for t in range(s):
            one = {k: v[:, t:t + 1] for k, v in batch.items()}
            lg, cache, m = step(params, one, cache, cache_len + t, *ep)
            outs.append((lg, m))
        ms = [m for _, m in outs]
        metrics = {}
        if "expert_load" in ms[0]:
            metrics["expert_load"] = sum(m["expert_load"] for m in ms)
            metrics["dropped"] = sum(m["dropped"] for m in ms)
        if "gate_input" in ms[0]:
            metrics["gate_input"] = jnp.concatenate(
                [m["gate_input"] for m in ms], axis=2)
        return jnp.concatenate([lg for lg, _ in outs], axis=1), cache, \
            metrics
    return run


class _OracleEngine(JServingEngine):
    """The reference engine with every prefill fed token by token."""

    def _get_step(self, collect):
        return _token_by_token(super()._get_step(collect))

    def _get_ep_step(self, collect, ctx):
        return _token_by_token(super()._get_ep_step(collect, ctx))


def _assert_no_drops(*metrics):
    for m in metrics:
        if "dropped" in m:
            assert float(np.asarray(m["dropped"]).sum()) == 0.0


# ------------------------------------------------------------ model


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_patterns_match_reference(arch):
    for smoke in (True, False):
        cfg, jcfg = get_config(arch, smoke=smoke), jget_config(arch,
                                                               smoke=smoke)
        got = [(s.mixer, s.ffn) for s in T.layer_pattern(cfg)]
        assert got == [(s.mixer, s.ffn) for s in JT.layer_pattern(jcfg)]
    if arch.startswith("jamba"):
        assert got == [("mamba", "dense"), ("mamba", "moe")] * 2 + \
            [("attn", "dense"), ("mamba", "moe")] + \
            [("mamba", "dense"), ("mamba", "moe")]
    else:
        assert got == [("mlstm", "none"), ("slstm", "none")]


@pytest.mark.parametrize("arch", ARCHS)
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
    assert ("expert_load" in tm) == cfg.is_moe == ("expert_load" in jm)
    if cfg.is_moe:
        np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                      np.asarray(jm["expert_load"]))
        np.testing.assert_array_equal(tm["dropped"].numpy(),
                                      np.asarray(jm["dropped"]))
        _close(tm["gate_input"], jm["gate_input"], "gate_input")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_into_cache_fixes_the_reference_fault(arch):
    """One 8-token prompt (batch 1, the arch's own capacity factor)
    prefilled into a fresh cache: the reference's logits stray from its
    own ``forward`` by more than 1 (its mixers see the first token
    only); the port's stay within 2e-3 of that ``forward``, with the
    same expert loads and drops."""
    cfg, jcfg, jp, tp = _setup(arch)
    toks = _tokens(cfg, (1, 8), seed=0)
    jl, jm = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    jpl, _, _ = JT.decode_step(jcfg, jp, {"tokens": jnp.asarray(toks)},
                               JT.init_cache(jcfg, jp, 1, 16),
                               jnp.asarray(0, jnp.int32))
    assert np.abs(np.asarray(jpl) - np.asarray(jl)).max() > 1.0
    tl, _, tm = T.decode_step(cfg, tp, {"tokens": torch.from_numpy(toks)},
                              T.init_cache(cfg, tp, 1, 16), 0)
    _close(tl, jl, "prefill into the cache vs forward", tol=2e-3)
    if cfg.is_moe:
        np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                      np.asarray(jm["expert_load"]))
        np.testing.assert_array_equal(tm["dropped"].numpy(),
                                      np.asarray(jm["dropped"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_prefill_then_batched_decode(arch):
    """Two prompts prefilled into the cache, then greedy batched decode
    at per-row lengths with one row inactive for a step, against the
    reference's ``forward`` (prefill) and its ``decode_step`` fed the
    prompts token by token (every step): logits allclose, tokens and
    expert loads equal, nothing dropped."""
    cfg, jcfg, jp, tp = _setup(arch, drop_free=True)
    jstep = _token_by_token(jax.jit(functools.partial(
        JT.decode_step, jcfg, collect=True)))
    b, plen, smax = 2, 6, 16
    toks = _tokens(cfg, (b, plen), seed=7)
    jf, _ = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    jl, jcache, jm = jstep(jp, {"tokens": jnp.asarray(toks)},
                           JT.init_cache(jcfg, jp, b, smax),
                           jnp.asarray(0, jnp.int32))
    tl, tcache, tm = T.decode_step(cfg, tp, {"tokens": torch.from_numpy(
        toks)}, T.init_cache(cfg, tp, b, smax), 0, collect=True)
    _close(tl, jf, "prefill vs forward")
    _close(tl, jl, "prefill vs token by token")
    _assert_no_drops(tm, jm)
    if cfg.is_moe:
        np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                      np.asarray(jm["expert_load"]))
        _close(tm["gate_input"], jm["gate_input"], "gate_input")
    lengths = np.asarray([plen, plen - 2], np.int32)
    cur = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    np.testing.assert_array_equal(torch.argmax(tl[:, -1], -1).numpy(), cur)
    for step in range(4):
        active = np.asarray([True, step != 1])
        batch = {"tokens": cur[:, None], "active": active}
        jl, jcache, jm = jstep(jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                               jcache, jnp.asarray(lengths))
        tl, tcache, tm = T.decode_step(
            cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()},
            tcache, torch.from_numpy(lengths), collect=True)
        _close(tl, jl, f"decode step {step}")
        _assert_no_drops(tm, jm)
        if cfg.is_moe:
            np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                          np.asarray(jm["expert_load"]))
        jt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
        np.testing.assert_array_equal(
            torch.argmax(tl[:, -1], -1).numpy(), jt)
        cur = np.where(active, jt, cur).astype(np.int32)
        lengths = lengths + active.astype(np.int32)
    # the recurrent state sits in the cache, float32, written in place
    for j, sub in enumerate(T.layer_pattern(cfg)):
        if sub.mixer != "attn":
            st, jst = tcache[j][sub.mixer], jcache[j][sub.mixer]
            if isinstance(st, dict):
                st, jst = [st[k] for k in sorted(st)], \
                    [jst[k] for k in sorted(jst)]
            assert st[-1].dtype == torch.float32
            for t, ref in zip(st, jst):
                _close(t, ref, f"{sub.mixer} state")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_serve_step_match_reference(arch):
    """``input_specs`` gives the reference's keys, shapes and dtypes; the
    serve step (one token a call into a cache) follows the reference's
    over 6 steps."""
    cfg, jcfg, jp, tp = _setup(arch)
    for kind in ("train", "prefill", "decode"):
        got = M.input_specs(cfg, InputShape("t", 16, 2, kind))
        want = JM.input_specs(jcfg, JInputShape("t", 16, 2, kind))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert all(v.dtype == torch.int32 for v in got.values())
    jstep, tstep = JM.make_serve_step(jcfg), M.make_serve_step(cfg)
    jcache, tcache = JT.init_cache(jcfg, jp, 2, 8), T.init_cache(cfg, tp, 2, 8)
    toks = _tokens(cfg, (6, 2, 1), seed=4)
    for i in range(6):
        jl, jcache = jstep(jp, {"tokens": jnp.asarray(toks[i])}, jcache,
                           jnp.asarray(i, jnp.int32))
        tl, tcache = tstep(tp, {"tokens": torch.from_numpy(toks[i])},
                           tcache, i)
        _close(tl, jl, f"step {i}")


# ------------------------------------------------------------ serving

# (prompt_len, max_new_tokens): more requests than slots, all at t=0 so
# that a dense model's wall-clock serving clock cannot change admission
TRACE = [(5, 6), (9, 3), (3, 7), (11, 4), (7, 5)]


def _reqs(cls, cfg, seed=9):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, arrival=0.0,
                prompt=rng.integers(0, cfg.vocab_size, size=pl,
                                    dtype=np.int32),
                max_new_tokens=n)
            for i, (pl, n) in enumerate(TRACE)]


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_api_matches_oracle(arch):
    """``engine.prefill`` then ``engine.decode`` (jamba with an engine
    MoElessController): greedy tokens, the controller's plans and
    iterations equal the oracle engine's."""
    cfg, jcfg, jp, tp = _setup(arch, drop_free=True)
    toks = _tokens(cfg, (4, 8), seed=2)
    out = []
    for eng_cls, ctrl_cls, c, p, wrap in (
            (ServingEngine, MoElessController, cfg, tp, torch.from_numpy),
            (_OracleEngine, JMoElessController, jcfg, jp, jnp.asarray)):
        ctrl = ctrl_cls(c, num_devices=4) if c.is_moe else None
        eng = eng_cls(c, p, max_len=32, controller=ctrl)
        tok, cache, clen = eng.prefill({"tokens": wrap(toks)})
        gen, cache, clen = eng.decode(tok, cache, clen, 4)
        out.append((np.asarray(tok), np.asarray(gen), clen, ctrl))
    (tok, gen, clen, ctrl), (jtok, jgen, jclen, jctrl) = out
    np.testing.assert_array_equal(tok, jtok)
    np.testing.assert_array_equal(gen, jgen)
    assert clen == jclen == 12 and gen.shape == (4, 4)
    if ctrl is not None:
        assert ctrl.iterations == jctrl.iterations == 5
        assert len(ctrl.plans) == cfg.num_layers // cfg.moe.every_n_layers
        for a, b in zip(ctrl.plans, jctrl.plans):
            np.testing.assert_array_equal(a.replicas, b.replicas)
            assert a.placement == b.placement


def _serve_both(cfg, jcfg, jp, tp, num_devices=4, **eng_kw):
    """The same requests through the port's engine and the oracle
    engine, with a session MoElessController over `num_devices` for a
    MoE config. Returns (port, oracle) as (requests, result,
    controller)."""
    out = []
    for eng_cls, req_cls, ctrl_cls, c, p in (
            (ServingEngine, GenRequest, MoElessController, cfg, tp),
            (_OracleEngine, JGenRequest, JMoElessController, jcfg, jp)):
        kw = dict(eng_kw)
        if eng_cls is _OracleEngine and kw.get("expert_runtime") == "on":
            kw["mesh"] = jax.make_mesh(
                (1, 1, 1), ("data", "ep", "tp"),
                axis_types=(jax.sharding.AxisType.Auto,) * 3)
        ctrl = ctrl_cls(c, num_devices=num_devices) if c.is_moe else None
        reqs = _reqs(req_cls, cfg)
        res = eng_cls(c, p, max_len=24, **kw).serve(
            reqs, num_slots=3, control=ctrl, time_scale=50.0)
        out.append((reqs, res, ctrl))
    return out


@pytest.mark.parametrize("arch,runtime", [("jamba-v0.1-52b", "off"),
                                          ("jamba-v0.1-52b", "on"),
                                          ("xlstm-125m", "off")])
def test_serve_matches_oracle(arch, runtime):
    """``engine.serve`` over the contiguous slot pool (5 requests, 3
    slots, so slots are reused): tokens, finish reasons, counters,
    records, the controller's plans and modeled clock and, runtime on,
    the runtime's meters equal the oracle engine's; nothing dropped."""
    cfg, jcfg, jp, tp = _setup(arch, drop_free=True)
    kw = {"expert_runtime": "on", "num_devices": 8} if runtime == "on" \
        else {}
    (reqs, res, ctrl), (jreqs, jres, jctrl) = _serve_both(cfg, jcfg, jp,
                                                          tp, **kw)
    assert [list(r.tokens) for r in reqs] == [list(r.tokens) for r in jreqs]
    assert [r.finish_reason for r in reqs] == \
        [r.finish_reason for r in jreqs]
    assert all(len(r.tokens) == n for r, (_, n) in zip(reqs, TRACE))
    for k in ("iterations", "prefills", "rejected", "cancelled",
              "dropped_tokens"):
        assert getattr(res, k) == getattr(jres, k), k
    assert res.dropped_tokens == 0.0
    if ctrl is None:
        return
    assert res.clock_s == jres.clock_s
    rows = lambda rs: sorted(map(dataclasses.astuple, rs))     # noqa: E731
    assert rows(res.records) == rows(jres.records)
    assert ctrl.iterations == jctrl.iterations
    assert ctrl.layer_latency == jctrl.layer_latency
    assert ctrl.cost == jctrl.cost
    for p, jp_ in zip(ctrl.plans + ctrl.last_plans,
                      jctrl.plans + jctrl.last_plans):
        np.testing.assert_array_equal(p.replicas, jp_.replicas)
        assert p.placement == jp_.placement
    if runtime == "on":
        st = dataclasses.asdict(res.runtime.finalize(res.clock_s))
        assert st == dataclasses.asdict(jres.runtime.finalize(jres.clock_s))
        assert st["transfers"] > 0
        assert res.runtime.moe_positions == [1]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_kv_raises(arch):
    cfg, jcfg, jp, tp = _setup(arch)
    spec = ServingSpec(kv="paged", kv_block=4)
    with pytest.raises(ValueError, match="attention-only"):
        ServingEngine(cfg, tp, max_len=24, serving=spec)
    with pytest.raises(ValueError, match="attention-only"):
        JServingEngine(jcfg, jp, max_len=24,
                       serving=JServingSpec(kv="paged", kv_block=4))
    with pytest.raises(ValueError, match="attention-only"):
        PagedKVCache(cfg, tp, 2, 16)
    with pytest.raises(ValueError, match="attention-only"):
        T.init_paged_cache(cfg, tp, 8, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_runs_at_exact_length_and_splices_every_leaf(arch):
    """A recurrent model's prompt is not padded to a bucket (a pad token
    would advance its state); inserting the prefilled row into a slot of
    a pool whose every leaf holds other values overwrites each of the
    slot's leaves, recurrent state included."""
    cfg, _, _, tp = _setup(arch)
    eng = ServingEngine(cfg, tp, max_len=24)
    tok, cache, plen, _, mask = eng.prefill_request(_tokens(cfg, (5,)))
    assert plen == 5 and mask.shape == (5,) and bool(mask.all())
    pool = SlotKVCache(cfg, tp, 3, 24)
    gen = torch.Generator().manual_seed(0)

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    for leaf in leaves(pool.cache):
        leaf.copy_(torch.randint(-5, 5, leaf.shape, generator=gen))
    slot = pool.alloc()
    pool.insert(slot, cache, plen)
    kinds = set()
    for j, sub in enumerate(T.layer_pattern(cfg)):
        kinds.add(sub.mixer)
        for got, want in zip(leaves(pool.cache[j]), leaves(cache[j])):
            assert torch.equal(got[:, slot], want[:, 0].to(got.dtype))
    assert kinds - {"attn"}


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_on_the_cpu(arch, capsys):
    LS.main(["--device", "cpu", "--arch", arch, "--requests", "3",
             "--prompt-len", "6", "--gen", "3", "--slots", "2"])
    out = capsys.readouterr().out
    assert f"served 3 requests x 3 tokens with {arch} on cpu" in out
    assert ("replica slots/layer" in out) == arch.startswith("jamba")
