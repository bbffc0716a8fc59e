"""PyTorch port, ``transformer.forward`` and the step builders against
the JAX reference on the reference's float32 weights (mixtral-8x7b and
phi-3.5-moe smoke configs).

Exact: ``expert_load`` and ``dropped``. Allclose (atol = rtol = 1e-4,
float32 through every layer): logits, ``aux_loss``, ``gate_input`` and
``router_logits``; with ``last_only``, a sliding window and a padded
``token_mask`` too. Within the port: ``forward`` against its own
``decode_step(cache_len=0)`` on the same prompt, the step builders
against the calls they wrap, and ``forward`` through the EP slot plane
at ep=1 against the capacity dispatch at a drop-free capacity factor.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.params import from_jax
from repro_torch.serving.expert_runtime import ExpertRuntime

torch.set_num_threads(1)

TOL = 1e-4      # atol = rtol, float32 logits and activations
NAMES = ("mixtral-8x7b", "phi-3.5-moe")


@functools.lru_cache(maxsize=None)
def _setup(name):
    """Float32 smoke configs of both packages and the reference's
    weights in both forms (read-only)."""
    cfg = get_config(name, smoke=True).with_(dtype="float32")
    jcfg = jget_config(name, smoke=True).with_(dtype="float32", impl="ref")
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(2))
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


def _tokens(cfg, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=TOL, rtol=TOL, err_msg=what)


CASES = {
    "plain": {},
    "last_only": {"last_only": True},
    "window": {"window": 4},
    "padded": {"mask": True},
    "collect": {"collect": True},
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name, case):
    cfg, jcfg, jp, tp = _setup(name)
    kw = dict(CASES[case])
    toks = _tokens(cfg)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if kw.pop("mask", False):   # row 1's last 5 tokens are padding
        mask = np.ones(toks.shape, bool)
        mask[1, -5:] = False
        jb["token_mask"] = jnp.asarray(mask)
        tb["token_mask"] = torch.from_numpy(mask)
    jl, jm = JT.forward(jcfg, jp, jb, **kw)
    with torch.no_grad():
        tl, tm = T.forward(cfg, tp, tb, **kw)
    _close(tl, jl, "logits")
    assert tl.shape == jl.shape
    np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                  np.asarray(jm["expert_load"]))
    np.testing.assert_array_equal(tm["dropped"].numpy(),
                                  np.asarray(jm["dropped"]))
    _close(tm["aux_loss"], jm["aux_loss"], "aux_loss")
    assert sorted(tm) == sorted(jm)
    if kw.get("collect"):
        for k in ("gate_input", "router_logits"):
            assert tm[k].shape == jm[k].shape, k
            _close(tm[k], jm[k], k)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_own_decode_step(name):
    """forward's logits and loads equal a prefill into a fresh cache."""
    cfg, _, _, tp = _setup(name)
    tb = {"tokens": torch.from_numpy(_tokens(cfg, seed=1))}
    with torch.no_grad():
        fl, fm = T.forward(cfg, tp, tb)
        cache = T.init_cache(cfg, tp, 2, 16)
        dl, _, dm = T.decode_step(cfg, tp, tb, cache, 0)
    _close(fl, dl, "logits")
    assert torch.equal(fm["expert_load"], dm["expert_load"])
    assert torch.equal(fm["dropped"], dm["dropped"])


def test_step_builders_wrap_forward_and_decode_step():
    cfg, _, _, tp = _setup("mixtral-8x7b")
    tb = {"tokens": torch.from_numpy(_tokens(cfg, seed=2))}
    with torch.no_grad():
        pl, pm = M.make_prefill_step(cfg)(tp, tb)
        fl, fm = T.forward(cfg, tp, tb, last_only=True)
        assert pl.shape == (2, 1, cfg.padded_vocab)
        assert torch.equal(pl, fl)
        assert torch.equal(pm["expert_load"], fm["expert_load"])
        c1, c2 = (T.init_cache(cfg, tp, 2, 16) for _ in range(2))
        sl, c1 = M.make_serve_step(cfg)(tp, tb, c1, 0)
        dl, c2, _ = T.decode_step(cfg, tp, tb, c2, 0)
    assert torch.equal(sl, dl)
    assert all(torch.equal(a["attn"]["k"], b["attn"]["k"])
               for a, b in zip(c1, c2))


def test_forward_ep_plane_equals_capacity_dispatch_drop_free():
    """At a drop-free capacity factor the EP slot plane (static
    single-replica plan, ep=1) and the capacity dispatch give the same
    logits, loads and drops: the reference's contract
    (tests/test_drop_equivalence.py) held within the port."""
    cfg, _, _, tp = _setup("mixtral-8x7b")
    cfg = cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    rt = ExpertRuntime(cfg, tp, num_devices=4, slots_per_device=2,
                       keep_alive=1e9)
    rt.bootstrap(None)
    tb = {"tokens": torch.from_numpy(_tokens(cfg, seed=3))}
    with torch.no_grad():
        rl, rm = T.forward(cfg, tp, tb, collect=True)
        el, em = T.forward(cfg, tp, tb, collect=True, ep_ctx=rt.ctx,
                           ep_state=rt.ep_state())
    assert float(rm["dropped"].sum()) == 0.0
    assert float(em["dropped"].sum()) == 0.0
    _close(el, rl, "logits")
    assert torch.equal(em["expert_load"], rm["expert_load"])
    _close(em["gate_input"], rm["gate_input"], "gate_input")
    assert "router_logits" not in em   # the EP plane emits none


def test_forward_rejects_what_is_not_ported():
    cfg, _, _, tp = _setup("mixtral-8x7b")
    tb = {"tokens": torch.from_numpy(_tokens(cfg))}
    # remat arrived with the training slice: its values run (the same
    # logits as without), an unknown one raises
    for remat in ("full", "dots"):
        assert torch.equal(T.forward(cfg, tp, tb, remat=remat)[0],
                           T.forward(cfg, tp, tb)[0])
    with pytest.raises(ValueError, match="remat"):
        T.forward(cfg, tp, tb, remat="offload")
    # encoder inputs arrived with the enc-dec slice: a decoder-only
    # config ignores them, as the reference does
    assert torch.equal(
        T.forward(cfg, tp, dict(tb, enc_embeds=torch.zeros(1)))[0],
        T.forward(cfg, tp, tb)[0])
