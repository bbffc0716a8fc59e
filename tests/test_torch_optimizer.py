"""PyTorch port, ``training/optimizer.py`` against the reference's on
the same trees (nested dicts and lists, float32 and bfloat16 leaves):
``global_norm``, ``clip_by_global_norm``, AdamW (clipped and unclipped,
with and without weight decay, a constant and a ``cosine_schedule``
learning rate) and SGD over several updates, and the schedule itself.
Float32 values allclose at atol = rtol = 1e-6; bfloat16 parameters at
one bf16 ulp (rtol 2^-7); ``step`` exactly.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.training import optimizer as JO
from repro_torch.training import optimizer as O

torch.set_num_threads(1)

TOL = 1e-6


def _tree(seed, bf16_leaf=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    tree = {"a": f(3, 4), "b": [f(5), {"c": f(2, 2, 3)}]}
    if bf16_leaf:
        tree["d"] = f(6).astype(ml_dtypes.bfloat16)
    return tree


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    def leaf(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(leaf, tree)


def _assert_tree_close(got, want):
    g_leaves = jax.tree.leaves(got)
    w_leaves = jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        w = np.asarray(w)
        if w.dtype == ml_dtypes.bfloat16:
            np.testing.assert_allclose(g.float().numpy(),
                                       w.astype(np.float32), rtol=2 ** -7,
                                       atol=TOL)
        else:
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip(max_norm):
    tree = _tree(0, bf16_leaf=False)
    np.testing.assert_allclose(float(O.global_norm(_torch(tree))),
                               float(JO.global_norm(_jax(tree))),
                               rtol=TOL)
    got, gn = O.clip_by_global_norm(_torch(tree), max_norm)
    want, wn = JO.clip_by_global_norm(_jax(tree), max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=TOL)
    _assert_tree_close(got, want)


OPTS = {
    "adamw": lambda M: M.adamw(3e-3, clip_norm=None),
    "adamw_clipped": lambda M: M.adamw(3e-3, clip_norm=1.0),
    "adamw_decay": lambda M: M.adamw(1e-2, weight_decay=0.1,
                                     clip_norm=0.5),
    "adamw_cosine": lambda M: M.adamw(M.cosine_schedule(1e-2, 2, 6),
                                      weight_decay=0.01),
    "sgd": lambda M: M.sgd(1e-2),
    "sgd_clipped": lambda M: M.sgd(1e-2, momentum=0.5, clip_norm=1.0),
}


@pytest.mark.parametrize("name", list(OPTS))
def test_updates_match_reference(name):
    jopt, opt = OPTS[name](JO), OPTS[name](O)
    params = _tree(1)
    jp, tp = _jax(params), _torch(params)
    js, ts = jopt.init(jp), opt.init(tp)
    for i in range(6):
        grads = _tree(10 + i)
        jp, js = jopt.update(jp, _jax(grads), js)
        tp, ts = opt.update(tp, _torch(grads), ts)
        _assert_tree_close(tp, jp)
    for k in js:
        if k == "step":
            assert ts["step"].dtype == torch.int32
            assert int(ts["step"]) == int(js["step"]) == 6
        else:
            _assert_tree_close(ts[k], js[k])


def test_update_leaves_its_arguments():
    opt = O.adamw(1e-2)
    tp = _torch(_tree(2))
    before = [t.clone() for t in jax.tree.leaves(tp)]
    state = opt.init(tp)
    opt.update(tp, _torch(_tree(3)), state)
    assert all(torch.equal(a, b) for a, b in zip(before, jax.tree.leaves(tp)))
    assert int(state["step"]) == 0


def test_cosine_schedule_matches_reference():
    jfn, fn = JO.cosine_schedule(1e-2, 3, 10), O.cosine_schedule(1e-2, 3, 10)
    for s in range(14):
        np.testing.assert_allclose(
            float(fn(torch.tensor(s, dtype=torch.int32))),
            float(jfn(jnp.asarray(s, jnp.int32))), rtol=TOL, atol=1e-9)
