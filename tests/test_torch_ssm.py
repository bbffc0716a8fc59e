"""PyTorch port, the recurrent mixers (``repro_torch.models.ssm``: Mamba,
mLSTM, sLSTM) against the JAX reference's ``repro.models.ssm`` on the
reference's own float32 weights: ``*_seq`` from the zero state,
``*_step`` from a state, ``*_seq`` from a state (a prompt prefilled into
a cache that already holds one) against the reference's ``*_seq`` over
the whole input, the zero states, the associative scan's combine order,
the weight bridge at bfloat16 and float32, and the parameter count.

Tolerance: floats atol = rtol = 1e-4 (float32, sums and products in the
reference's order except where torch reduces einsums its own way). The
scan is held bit for bit against ``jax.lax.associative_scan`` run op by
op (under ``jit`` XLA fuses multiply-adds, which changes last bits).
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
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.params import from_jax

torch.set_num_threads(1)

TOL = 1e-4
ARCHS = ["jamba-v0.1-52b", "xlstm-125m"]


@functools.lru_cache(maxsize=None)
def _mixer(kind):
    """(port cfg, reference cfg, reference params, port params) of one
    mixer of a float32 smoke config."""
    arch = "jamba-v0.1-52b" if kind == "mamba" else "xlstm-125m"
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    jcfg = jget_config(arch, smoke=True).with_(dtype="float32")
    key, d, h = jax.random.PRNGKey(5), cfg.d_model, cfg.num_heads
    if kind == "mamba":
        jp = JS.init_mamba(key, d, jcfg.ssm, jnp.float32)
    elif kind == "mlstm":
        jp = JS.init_mlstm(key, d, h, jcfg.ssm.expand, jnp.float32)
    else:
        jp = JS.init_slstm(key, d, h, jnp.float32)
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


def _run(kind, cfg, p, x, state=None, step=False, ref=False):
    """One mixer call in either package: x numpy (B, S, D)."""
    mod = JS if ref else S
    arg = cfg.ssm if kind == "mamba" else cfg.num_heads
    xs = jnp.asarray(x) if ref else torch.from_numpy(x)
    if step:
        return getattr(mod, f"{kind}_step")(p, xs, state, arg)
    if ref:
        assert state is None           # the reference starts from zero
        return getattr(mod, f"{kind}_seq")(p, xs, arg)
    return getattr(mod, f"{kind}_seq")(p, xs, arg, state)


def _flat(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return [tree]


def _close(got, want, what=""):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape, what
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL, err_msg=what)


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("s", [1, 6, 13])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_seq_from_zero_matches_reference(kind, s):
    cfg, jcfg, jp, tp = _mixer(kind)
    x = _x(cfg, 2, s, seed=s)
    jy, jst = _run(kind, jcfg, jp, x, ref=True)
    ty, tst = _run(kind, cfg, tp, x)
    _close(ty, jy, "y")
    _close(tst, jst, "state")


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_step_from_a_state_matches_reference(kind):
    """A state reached over 7 tokens, then 4 single-token steps."""
    cfg, jcfg, jp, tp = _mixer(kind)
    x = _x(cfg, 2, 11, seed=1)
    _, jst = _run(kind, jcfg, jp, x[:, :7], ref=True)
    tst = from_jax(jax.tree.map(np.asarray, jst))
    for t in range(7, 11):
        jy, jst = _run(kind, jcfg, jp, x[:, t:t + 1], jst, step=True,
                       ref=True)
        ty, tst = _run(kind, cfg, tp, x[:, t:t + 1], tst, step=True)
        _close(ty, jy, f"y at {t}")
        _close(tst, jst, f"state at {t}")


@pytest.mark.parametrize("split", [1, 5, 9])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_seq_from_a_state_continues_the_reference_seq(kind, split):
    """``*_seq`` over tokens [split, 12) from the state after [0, split)
    equals the tail of the reference's ``*_seq`` over all 12 tokens,
    output and final state: what a prompt prefilled into a cache
    computes. The reference's ``*_step`` on the same chunk does not (it
    reads the first token only)."""
    cfg, jcfg, jp, tp = _mixer(kind)
    x = _x(cfg, 2, 12, seed=3)
    jy, jst = _run(kind, jcfg, jp, x, ref=True)
    _, tmid = _run(kind, cfg, tp, x[:, :split])
    ty, tst = _run(kind, cfg, tp, x[:, split:], tmid)
    _close(ty, jy[:, split:], "y")
    _close(tst, jst, "state")
    if split <= 10:
        _, jmid = _run(kind, jcfg, jp, x[:, :split], ref=True)
        wrong, _ = _run(kind, jcfg, jp, x[:, split:], jmid, step=True,
                        ref=True)
        # its one-token output (B, 1, D) broadcasts over the chunk
        assert np.abs(np.asarray(wrong) - np.asarray(jy)[:, split + 1:]
                      ).max() > 1e-2


def test_zero_states_match_reference():
    cfg, jcfg, jp, tp = _mixer("mamba")
    _close(S.init_mamba_state(tp, cfg.ssm, 3),
           JS.init_mamba_state(jp, jcfg, 3), "mamba")
    x = get_config("xlstm-125m", smoke=True)
    jx = jget_config("xlstm-125m", smoke=True)
    _close(S.init_mlstm_state(x, 3, x.ssm.expand, "cpu"),
           JS.init_mlstm_state(jx, 3, jx.ssm.expand), "mlstm")
    _close(S.init_slstm_state(x.d_model, x.num_heads, 3, "cpu"),
           JS.init_slstm_state(jx.d_model, jx.num_heads, 3), "slstm")
    # a leading (periods, batch) shape, as the stacked cache holds
    st = S.init_slstm_state(x.d_model, x.num_heads, (2, 3), "cpu")
    assert [tuple(t.shape) for t in st] == [(2, 3, 256)] * 2 + \
        [(2, 3, 4), (2, 3, 256)]
    assert all(t.dtype == torch.float32 for t in st)
    assert float(st[2].max()) == float(np.float32(-1e30))


def _combine(x, y):
    (ax, bx), (ay, by) = x, y
    return ax * ay, bx * ay + by


@pytest.mark.parametrize("n", [1, 2, 7, 8, 13, 128])
def test_associative_scan_combines_in_the_reference_order(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 5, 3)).astype(np.float32)
    b = rng.standard_normal((2, n, 5, 3)).astype(np.float32)
    ja, jb = jax.lax.associative_scan(
        _combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, tb = S._associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("t", [130, 256])
def test_scan_linear_recurrence_chunks_as_the_reference(t):
    """Chunks of min(128, T) shrunk to a divisor of T (130 -> 65, 256 ->
    128), from a nonzero h0: hidden states and the final one."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.5, 1.0, (1, t, 4, 2)).astype(np.float32)
    b = rng.standard_normal((1, t, 4, 2)).astype(np.float32)
    h0 = rng.standard_normal((1, 4, 2)).astype(np.float32)
    jhs, jh = JS._scan_linear_recurrence(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(h0))
    ths, th = S._scan_linear_recurrence(torch.from_numpy(a),
                                        torch.from_numpy(b),
                                        torch.from_numpy(h0))
    _close(ths, jhs, "hs")
    _close(th, jh, "h_T")


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{pre}/{i}")
    else:
        yield pre, tree


# the float32 leaves of a bfloat16 model (the reference's init)
F32_LEAVES = {"jamba-v0.1-52b": ["/layers/0/mamba/a_log",
                                 "/layers/0/mamba/d_skip"],
              "xlstm-125m": ["/layers/0/mlstm/b_i", "/layers/0/mlstm/b_f",
                             "/layers/1/slstm/bias"]}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_and_init_params_field_by_field(arch, dtype):
    """The reference's tree through ``from_jax``: the same paths, shapes,
    dtypes and bits leaf for leaf (the float32 leaves of a bfloat16
    model stay float32); the port's ``init_params`` builds the same
    paths, shapes and dtypes; the analytic count is the tree's."""
    jcfg = jget_config(arch, smoke=True).with_(dtype=dtype)
    cfg = get_config(arch, smoke=True).with_(dtype=dtype)
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(1)))
    want = dict(_paths(jp))
    got = dict(_paths(from_jax(jp)))
    assert sorted(got) == sorted(want)
    for path, ref in want.items():
        t = got[path]
        assert tuple(t.shape) == ref.shape, path
        assert str(t.dtype).split(".")[-1] == str(ref.dtype), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      ref.astype(np.float32), err_msg=path)
    for path in F32_LEAVES[arch]:
        assert got[path].dtype == torch.float32, path
    mine = dict(_paths(M.init_params(cfg, seed=2, device="cpu")))
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in got.items()}
    # a constant leaf: the same values to the last bit but one (the
    # reference's CPU log rounds one value the other way)
    np.testing.assert_allclose(
        mine[F32_LEAVES[arch][0]].numpy(), want[F32_LEAVES[arch][0]],
        rtol=2e-7, atol=0)
    assert M.count_params_analytic(cfg) == sum(a.size for a in want.values())
    assert M.count_params_analytic(cfg, active_only=True) == \
        JM.count_params_analytic(jcfg, active_only=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_counts_match_reference(arch):
    full = get_config(arch)
    jfull = jget_config(arch)
    assert M.count_params_analytic(full) == JM.count_params_analytic(jfull)
    assert M.count_params_analytic(full, active_only=True) == \
        JM.count_params_analytic(jfull, active_only=True)
    assert dataclasses.asdict(full.ssm) == dataclasses.asdict(jfull.ssm)
