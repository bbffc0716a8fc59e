"""PyTorch port, the training path against the JAX reference on the
CPU, float32 smoke configs, ``impl="ref"`` on both sides, the
reference's weights through ``params.from_jax``:

* ``TokenStream`` batches: bitwise equal.
* ``loss_fn``: loss and ``aux_loss`` allclose at atol = rtol = 1e-5,
  every gradient at atol = rtol = 1e-5 (observed: 4e-6 at most).
* One ``make_train_step`` update: parameters allclose at atol = 5e-4,
  rtol = 1e-4 (AdamW's first step is g / (|g| + eps) times lr = 1e-3,
  so a gradient near its float32 noise moves its element by up to 2 lr;
  observed 1.1e-4 at most), the step counter and the moments' layout
  exactly; with two microbatches the metrics too ('expert_load' float32).
* Within the port: ``remat`` none / full / dots bitwise equal; the
  reference's grad-accumulation and loss-decrease tests; checkpoints
  exact across packages; a resumed ``train`` equal bit for bit to the
  uninterrupted one (the reference's is not: it restarts its optimizer).
* The kernels refuse autograd: ``impl="cuda"`` on a CPU tensor that
  requires grad raises ``NotImplementedError`` before the device check.
"""
import functools
from collections import Counter

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.configs.base import MoESpec as JMoESpec
from repro.models import model as JM
from repro.training import checkpoint as JC
from repro.training import data as JD
from repro.training import optimizer as JO
from repro.training import train_loop as JTL
from repro_torch.configs import INPUT_SHAPES, InputShape, MoESpec, get_config
from repro_torch.configs import list_archs
from repro_torch.kernels import ops as OPS
from repro_torch.launch import train as LT
from repro_torch.models import model as M
from repro_torch.params import from_jax
from repro_torch.training import checkpoint as C
from repro_torch.training import data as D
from repro_torch.training import optimizer as O
from repro_torch.training import train_loop as TL

torch.set_num_threads(1)

GRAD_TOL = 1e-5           # atol = rtol: loss, aux_loss, gradients
STEP_ATOL, STEP_RTOL = 5e-4, 1e-4   # parameters after one AdamW update
LR = 1e-3
ARCHS = ("mixtral-8x7b", "qwen3-32b", "qwen2-vl-2b", "jamba-v0.1-52b",
         "xlstm-125m")


def _cfgs(arch, **over):
    cfg = get_config(arch, smoke=True).with_(dtype="float32", impl="ref",
                                             **over)
    jcfg = jget_config(arch, smoke=True).with_(dtype="float32", impl="ref",
                                               **over)
    return cfg, jcfg


def _batch(cfg, b=2, s=16, seed=0):
    """Numpy inputs of a training step (a vlm's patch embeddings, mask
    and 3-axis positions too)."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
           for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        out["vis_embeds"] = (rng.standard_normal((b, s, cfg.d_model))
                             * 0.02).astype(np.float32)
        out["vis_mask"] = np.broadcast_to(np.arange(s)[None] < s // 2,
                                          (b, s)).copy()
        if cfg.rope == "mrope":
            out["positions"] = rng.integers(0, s, (b, s, 3), dtype=np.int32)
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _opt(M_):
    return M_.adamw(LR, weight_decay=0.01)


@functools.lru_cache(maxsize=None)
def _reference(arch, microbatches=1, remat="full"):
    """The reference's loss, metrics and gradients at its weights, and
    one ``make_train_step`` update from a fresh AdamW state (one jit)."""
    _, jcfg = _cfgs(arch)
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(1))
    grad_fn = jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b, remat=remat), has_aux=True)
    step = JM.make_train_step(jcfg, _opt(JO), remat=remat,
                              microbatches=microbatches)
    b = jax.tree.map(jnp.asarray, _batch(jcfg))
    out = jax.jit(lambda p, st, b: (grad_fn(p, b), step(p, st, b)))(
        jp, _opt(JO).init(jp), b)
    return jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, out)


def _close(got, want, atol, rtol, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_token_stream_matches_reference(seed):
    dc = dict(vocab_size=256, seq_len=32, global_batch=3, seed=seed)
    got, want = D.TokenStream(D.DataConfig(**dc)), \
        JD.TokenStream(JD.DataConfig(**dc))
    for step in (0, 3, 11):
        g, w = got.batch(step), want.batch(step)
        for k in ("tokens", "labels"):
            assert g[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------- loss


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_reference(arch):
    cfg, _ = _cfgs(arch)
    jp, (((jtotal, jm), jg), _) = _reference(arch, 1, "full")
    p = from_jax(jp)
    live = O._map(lambda t: t.requires_grad_(), p)
    total, m = M.loss_fn(cfg, live, _torch_batch(_batch(cfg)))
    grads = torch.autograd.grad(total, O._leaves(live))
    _close(total, jtotal, GRAD_TOL, GRAD_TOL, "total")
    for k in ("loss", "aux_loss"):
        _close(m[k], jm[k], GRAD_TOL, GRAD_TOL, k)
    if "expert_load" in jm:
        np.testing.assert_array_equal(m["expert_load"].numpy(),
                                      jm["expert_load"])
    keys = [k for k, _ in C.leaf_paths(p)]
    assert len(grads) == len(keys) == len(jax.tree.leaves(jg))
    for k, g in zip(keys, grads):
        _close(g, _leaf(jg, k), GRAD_TOL, GRAD_TOL, f"grad {k}")


def _leaf(tree, key):
    for part in key.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


STEP_CASES = [(a, 1, "full", "full") for a in ARCHS] + \
    [("mixtral-8x7b", 2, "full", "none")]


@pytest.mark.parametrize("arch,microbatches,jremat,remat", STEP_CASES)
def test_train_step_matches_reference(arch, microbatches, jremat, remat):
    cfg, _ = _cfgs(arch)
    jp, (_, (jnew, jstate, jm)) = _reference(arch, microbatches, jremat)
    p = from_jax(jp)
    opt = _opt(O)
    step = M.make_train_step(cfg, opt, remat=remat,
                             microbatches=microbatches)
    new, state, m = step(p, opt.init(p), _torch_batch(_batch(cfg)))
    assert not any(t.requires_grad for t in O._leaves(p) + O._leaves(new))
    for k, t in C.leaf_paths(new):
        _close(t, _leaf(jnew, k), STEP_ATOL, STEP_RTOL, f"param {k}")
    assert int(state["step"]) == int(jstate["step"]) == 1
    for k in jm:
        if k == "expert_load":
            assert m[k].dtype == (torch.int32 if microbatches == 1
                                  else torch.float32)
            np.testing.assert_array_equal(m[k].numpy(), jm[k])
        else:
            _close(m[k], jm[k], GRAD_TOL, GRAD_TOL, k)
    # the input tree is untouched
    for (k, t), (_, t0) in zip(C.leaf_paths(p), C.leaf_paths(from_jax(jp))):
        assert torch.equal(t, t0), k


# ---------------------------------------------------------------- remat


class _Ops(TorchDispatchMode):
    """The aten overloads dispatched under the mode, counted."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-v0.1-52b",
                                  "xlstm-125m"])
def test_remat_modes_bitwise_equal(arch):
    """none, full and dots give the same loss and gradients bit for bit;
    backward recomputes the products under full, only the batched ones
    (bmm) under dots, none under none (the dispatched overloads,
    counted)."""
    cfg, _ = _cfgs(arch)
    p = M.init_params(cfg, 0, "cpu")
    b = _torch_batch(_batch(cfg))
    out, ops = {}, {}
    for remat in ("none", "full", "dots"):
        live = O._map(lambda t: t.detach().requires_grad_(), p)
        total, m = M.loss_fn(cfg, live, b, remat=remat)
        with _Ops() as rec:
            grads = torch.autograd.grad(total, O._leaves(live))
        out[remat] = (total.detach(), grads, m)
        ops[remat] = rec.ops
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert ops["none"][mm] > 0 and ops["none"][bmm] > 0
    assert ops["full"][mm] > ops["none"][mm]
    assert ops["full"][bmm] > ops["none"][bmm]
    assert ops["dots"][mm] == ops["none"][mm]
    assert ops["dots"][bmm] == ops["full"][bmm]
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for g, g0 in zip(out[remat][1], out["none"][1]):
            assert torch.equal(g, g0), remat
        for k, v in out["none"][2].items():
            assert torch.equal(out[remat][2][k].detach(), v.detach()), k


def test_unknown_remat_and_grad_shardings_raise():
    cfg, _ = _cfgs("qwen3-32b")
    p = M.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="remat"):
        M.loss_fn(cfg, p, _torch_batch(_batch(cfg)), remat="everything")
    with pytest.raises(ValueError, match="NamedSharding"):
        M.make_train_step(cfg, _opt(O), grad_shardings={})


# ------------------------------------------------- the reference's tests


def test_grad_accumulation_equivalence():
    cfg = get_config("qwen3-32b", smoke=True).with_(
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
        head_dim=32, d_ff=128, vocab_size=128, dtype="float32", impl="ref")
    params = M.init_params(cfg, 0, "cpu")
    opt = O.adamw(1e-3)
    st = opt.init(params)
    batch = M.input_specs(cfg, InputShape("t", 16, 4, "train"),
                          abstract=False,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    p1, _, m1 = M.make_train_step(cfg, opt, microbatches=1)(params, st,
                                                            batch)
    p2, _, m2 = M.make_train_step(cfg, opt, microbatches=2)(params, st,
                                                            batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    for a, b in zip(O._leaves(p1), O._leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3)


def test_loss_decreases():
    cfg = get_config("mixtral-8x7b", smoke=True).with_(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, impl="ref",
        moe=MoESpec(num_experts=4, top_k=2, d_ff=256))
    res, _ = TL.train(cfg, steps=30, seq_len=64, global_batch=4, lr=2e-3,
                      verbose=False, device="cpu")
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
    assert len(res.step_s) == len(res.expert_loads) == 30
    for load in res.expert_loads:   # every token routed top_k times a layer
        np.testing.assert_array_equal(load.sum(-1), 4 * 64 * 2)


# ---------------------------------------------------------------- window


def test_window_helpers_match_reference():
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jget_config(arch)
        for name, shape in INPUT_SHAPES.items():
            js = J_INPUT_SHAPES[name]
            assert M.needs_window(cfg, shape) == JM.needs_window(jcfg, js)
            assert M.effective_window(cfg, shape) == \
                JM.effective_window(jcfg, js)
            assert M.kv_cache_len(cfg, shape) == JM.kv_cache_len(jcfg, js)
    assert M.LONG_CONTEXT_WINDOW == JM.LONG_CONTEXT_WINDOW


# ---------------------------------------------------------------- checkpoints


def test_checkpoint_roundtrip_exact(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((3, 5), generator=g).to(torch.bfloat16),
            "n": torch.randint(-9, 9, (4,), generator=g, dtype=torch.int32),
            "layers": [{"a": torch.randn((2, 2), generator=g)},
                       {"b": torch.randn((7,), generator=g)
                        .to(torch.bfloat16)}],
            "step": torch.tensor(5, dtype=torch.int32)}
    C.save(tmp_path / "ck", tree, step=5)
    zeros = O._map(torch.zeros_like, tree)
    back = C.restore(tmp_path / "ck", zeros)
    assert C.latest_step(tmp_path / "ck.npz") == 5
    for (k, a), (_, b) in zip(C.leaf_paths(tree), C.leaf_paths(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    with pytest.raises(ValueError, match="mismatch"):
        C.restore(tmp_path / "ck", {"w": tree["w"]})


def test_checkpoints_cross_packages(tmp_path):
    """A reference-written file restores into the port equal to
    ``from_jax``; the port's file restores into the reference; both
    bf16 (stored as float32) and exact."""
    cfg = get_config("mixtral-8x7b", smoke=True)
    jcfg = jget_config("mixtral-8x7b", smoke=True)
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(4))
    JC.save(tmp_path / "ref", jp, step=2)
    want = from_jax(jax.tree.map(np.asarray, jp))
    got = C.restore(tmp_path / "ref", O._map(torch.zeros_like, want))
    assert C.latest_step(tmp_path / "ref.npz") == 2
    for (k, a), (_, b) in zip(C.leaf_paths(got), C.leaf_paths(want)):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b), k
    mine = M.init_params(cfg, 3, "cpu")
    C.save(tmp_path / "port", mine, step=7)
    back = JC.restore(tmp_path / "port", jp)
    assert JC.latest_step(tmp_path / "port.npz") == 7
    for k, t in C.leaf_paths(mine):
        leaf = np.asarray(_leaf(back, k))
        assert leaf.dtype == ml_dtypes.bfloat16, k
        np.testing.assert_array_equal(leaf.astype(np.float32),
                                      t.float().numpy(), err_msg=k)


# ---------------------------------------------------------------- resume


RESUME = dict(steps=6, seq_len=16, global_batch=2, lr=1e-2, seed=0,
              verbose=False)


def _resume_cfg(jax_side: bool):
    get, spec = (jget_config, JMoESpec) if jax_side else (get_config,
                                                          MoESpec)
    return get("mixtral-8x7b", smoke=True).with_(
        d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
        vocab_size=128, dtype="float32", impl="ref",
        moe=spec(num_experts=4, top_k=2, d_ff=128))


def _interrupt_at(module, monkeypatch, step):
    """Make `module`'s train loop stop (raise) when it asks for `step`."""
    class Stop(Exception):
        pass

    class Stream(module.TokenStream):
        def batch(self, s):
            if s == step:
                raise Stop
            return super().batch(s)

    monkeypatch.setattr(module, "TokenStream", Stream)
    return Stop


def test_resume_is_exact(tmp_path, monkeypatch):
    """3 steps, a checkpoint, an interruption and a resume end where 6
    uninterrupted steps end: parameters, moments and step, bit for
    bit."""
    cfg = _resume_cfg(False)
    _, p_full = TL.train(cfg, checkpoint_path=tmp_path / "full",
                         device="cpu", **RESUME)
    with monkeypatch.context() as mp:
        stop = _interrupt_at(TL, mp, 3)
        with pytest.raises(stop):
            TL.train(cfg, checkpoint_path=tmp_path / "cut",
                     checkpoint_every=3, device="cpu", **RESUME)
    assert C.latest_step(tmp_path / "cut.npz") == 3
    res, p_res = TL.train(cfg, checkpoint_path=tmp_path / "cut",
                          device="cpu", **RESUME)
    assert len(res.losses) == 3
    for (k, a), (_, b) in zip(C.leaf_paths(p_full), C.leaf_paths(p_res)):
        assert torch.equal(a, b), k
    for name in ("full.opt.npz", "cut.opt.npz", "full.npz", "cut.npz"):
        assert (tmp_path / name).exists()
    with np.load(tmp_path / "full.opt.npz") as a, \
            np.load(tmp_path / "cut.opt.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("mu/") for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert int(a["step"]) == 6


def test_reference_resume_restarts_its_optimizer(tmp_path, monkeypatch,
                                                 capsys):
    """The reference's resume restores the parameters alone (a fresh
    AdamW state: zero moments, step 0), so it ends more than 1e-3 away
    from its uninterrupted run; its checkpoint restores into the port's
    loop with a fresh optimizer state, said in the log."""
    jcfg = _resume_cfg(True)
    _, full = JTL.train(jcfg, **RESUME)
    with monkeypatch.context() as mp:
        stop = _interrupt_at(JTL, mp, 3)
        with pytest.raises(stop):
            JTL.train(jcfg, checkpoint_path=str(tmp_path / "ref"),
                      checkpoint_every=3, **RESUME)
    cfg = _resume_cfg(False)
    like = M.init_params(cfg, 0, "cpu")
    fresh = O.adamw(1e-2).init(like)
    p, state, step = TL.restore_checkpoint(tmp_path / "ref", like, fresh)
    assert step == 3 and state is fresh
    assert "fresh optimizer state" in capsys.readouterr().out
    with np.load(tmp_path / "ref.npz") as f:   # the reference's parameters
        for k, t in C.leaf_paths(p):
            np.testing.assert_array_equal(t.numpy(), f[k], err_msg=k)
    _, resumed = JTL.train(jcfg, checkpoint_path=str(tmp_path / "ref"),
                           **RESUME)
    gap = max(float(jnp.abs(a - b).max()) for a, b in
              zip(jax.tree.leaves(full), jax.tree.leaves(resumed)))
    assert gap > 1e-3, gap


# ---------------------------------------------------------------- refusal


def _refusal_calls():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)   # noqa: E731
    gs = torch.tensor([2, 1], dtype=torch.int32)
    q, kv = r(1, 2, 4), r(1, 3, 1, 4)
    pos = torch.zeros((1, 3), dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    scale = torch.ones((2, 4))
    w8 = torch.ones((2, 4, 4), dtype=torch.int8)
    return {
        "fused_gate_up": (lambda x, w, i: OPS.expert_ffn_impl(
            x, w, w, w, gs, i), r(2, 3, 4), r(2, 4, 4)),
        "gmm": (lambda x, w, i: OPS.gmm_impl(x, w, gs, i), r(2, 3, 4),
                r(2, 4, 4)),
        "fused_gate_up_quant": (lambda x, s, i: OPS.expert_ffn_quant_impl(
            x, w8, s, w8, s, w8, s, gs, i), r(2, 3, 4), scale),
        "gmm_quant": (lambda x, s, i: OPS.gmm_quant_impl(x, w8, s, gs, i),
                      r(2, 3, 4), scale),
        "decode_attention": (lambda x, k, i: OPS.decode_attention_impl(
            x, k, k, pos, one, one, window=0, impl=i), q, kv),
        "decode_attention_paged": (
            lambda x, k, i: OPS.decode_attention_paged_impl(
                x, k, k, torch.zeros((1, 3), dtype=torch.int32),
                torch.zeros((1, 1), dtype=torch.int32), one, one,
                window=0, impl=i), q, kv),
    }


@pytest.mark.parametrize("name", list(_refusal_calls()))
def test_kernels_refuse_autograd(name):
    """impl='cuda' on CPU tensors that require grad: NotImplementedError
    naming the kernel, before the device check; under no_grad the old
    ValueError; impl='auto' on CPU tensors is the plain path, and
    differentiable."""
    fn, x, w = _refusal_calls()[name]
    w = w.requires_grad_()
    with pytest.raises(NotImplementedError, match=f"{name}: .*no backward"):
        fn(x, w, "cuda")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fn(x, w, "cuda")
    fn(x, w, "auto").float().sum().backward()
    assert w.grad is not None


def test_train_step_at_cuda_impl_refuses_autograd():
    """A train step whose expert FFN would launch the kernel raises at
    the first one, fused_gate_up, instead of dropping the experts from
    the graph."""
    cfg, _ = _cfgs("mixtral-8x7b")
    p = M.init_params(cfg, 0, "cpu")
    step = M.make_train_step(cfg.with_(impl="cuda"), _opt(O))
    with pytest.raises(NotImplementedError, match="fused_gate_up"):
        step(p, _opt(O).init(p), _torch_batch(_batch(cfg)))


# ---------------------------------------------------------------- launcher


def test_launcher_trains_on_cpu(tmp_path, capsys):
    ck = tmp_path / "ck"
    LT.main(["--device", "cpu", "--steps", "2", "--seq-len", "16",
             "--batch", "2", "--checkpoint", str(ck),
             "--checkpoint-every", "1"])
    out = capsys.readouterr().out
    assert "impl=ref" in out and "done: loss" in out
    assert C.latest_step(f"{ck}.npz") == 2 and (tmp_path / "ck.opt.npz") \
        .exists()
