"""PyTorch port, the dry-run slice on the CPU:

* ``models.model.abstract_params`` / ``abstract_cache`` (meta-device
  trees) equal the reference's ``jax.eval_shape`` trees in shape and
  dtype, leaf by leaf, for the twelve full configs (x four input shapes
  for the cache); ``count_params_analytic`` equals the reference's.
* ``launch.dryrun.run_one`` on full combinations (one each of train,
  prefill, decode and long_500k) makes no tensor off the meta device,
  writes only into the results directory it is given, and reckons the
  argument bytes that the reference's own ``NamedSharding.shard_shape``
  gives leaf by leaf; ``count_step``'s extrapolation from corners equals
  a full meta run exactly (mixtral, xlstm and jamba smoke configs at
  three periods and four microbatches).
* In a subprocess (the reference's dry-run sets XLA_FLAGS at import, so
  this process never imports it): the reference's
  ``cost_analysis()["flops"]`` is per device and counts a scanned
  microbatch and a scanned layer period once, as ``launch/dryrun.py``
  states (its ``flops_per_scan_body`` is that quantity).
* ``set_moe_dispatch_groups(2)``: the port's ``forward`` equals the
  reference's at the same setting (float32, atol = rtol = 1e-5).
* Each Mamba lever (``fused_y``, ``chunk_remat``, ``inline_ab``) on a
  float32 smoke jamba mixer equals the reference's same lever, output
  and gradients (atol = rtol = 1e-5), and the default path.

Every global a test sets (dispatch groups, Mamba levers, activation
mesh) is restored in ``finally`` in both packages.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.distributed import sharding as JS
from repro.models import model as JM
from repro.models import ssm as JS_SSM
from repro.models import transformer as JT
from repro_torch.configs import INPUT_SHAPES, InputShape, get_config
from repro_torch.configs import list_archs
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.params import from_jax

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = list_archs()
TOL = 1e-5
TIMEOUT_S = 300


def _key(k):
    return getattr(k, "key", getattr(k, "idx", None))


def _ref_leaves(tree):
    return {tuple(_key(k) for k in path): (tuple(v.shape), str(v.dtype))
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    out = {}
    SH.tree_map_with_path(lambda p, v: out.__setitem__(
        p, (tuple(v.shape), str(v.dtype).split(".")[-1])), tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    got = M.abstract_params(get_config(arch))
    leaves = []
    SH.tree_map_with_path(lambda p, v: leaves.append(v), got)
    assert all(v.device.type == "meta" for v in leaves)
    assert _port_leaves(got) == _ref_leaves(
        JM.abstract_params(jget_config(arch)))
    assert M.count_params_analytic(get_config(arch)) == \
        JM.count_params_analytic(jget_config(arch))
    assert M.count_params_analytic(get_config(arch), active_only=True) == \
        JM.count_params_analytic(jget_config(arch), active_only=True)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_matches_reference(arch, shape):
    got = M.abstract_cache(get_config(arch), INPUT_SHAPES[shape])
    leaves = []
    SH.tree_map_with_path(lambda p, v: leaves.append(v), got)
    assert all(v.device.type == "meta" for v in leaves)
    assert _port_leaves(got) == _ref_leaves(
        JM.abstract_cache(jget_config(arch), J_INPUT_SHAPES[shape]))


class _OffMeta(TorchDispatchMode):
    """Records every operation output that is not on the meta device."""

    def __init__(self):
        super().__init__()
        self.off = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.off.append((str(func), tuple(t.shape)))
        return out


def _ref_argument_bytes(arch, shape):
    """The reference's per-rank argument bytes on its 16x16 mesh, from
    its own specs' ``shard_shape``: params, AdamW moments and step, batch
    (train); params, batch, cache and a replicated int32 (decode)."""
    mesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    jcfg, jshape = jget_config(arch), J_INPUT_SHAPES[shape]
    aparams = JM.abstract_params(jcfg)
    batch = JM.input_specs(jcfg, jshape)
    trees = [(aparams, JS.params_shardings(aparams, mesh)),
             (batch, JS.batch_shardings(batch, mesh))]
    extra = 0
    if jshape.kind == "train":
        for _ in ("mu", "nu"):
            f32 = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape,
                                                              jnp.float32),
                               aparams)
            trees.append((f32, JS.params_shardings(f32, mesh)))
        extra = 4                                 # the step counter
    if jshape.kind == "decode":
        cache = JM.abstract_cache(jcfg, jshape)
        trees.append((cache, JS.cache_shardings(cache, mesh)))
        extra = 4                                 # cache_len
    total = extra
    for tree, sh in trees:
        for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(sh)):
            total += int(np.prod(s.shard_shape(a.shape))) * \
                jnp.dtype(a.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape", [
    ("mixtral-8x7b", "train_4k"), ("qwen3-32b", "prefill_32k"),
    ("phi-3.5-moe", "decode_32k"), ("jamba-v0.1-52b", "long_500k")])
def test_run_one_allocates_nothing(arch, shape, tmp_path):
    before = T._MOE_GROUPS["groups"], dict(S.MAMBA_OPTS), S._time_loop
    with _OffMeta() as mode:
        r = D.run_one(arch, shape, verbose=False, results_dir=tmp_path)
    assert mode.off == []
    assert (T._MOE_GROUPS["groups"], S.MAMBA_OPTS, S._time_loop) == before
    assert [p.name for p in tmp_path.iterdir()] == \
        [f"{arch}__{shape}__16x16.json"]
    assert json.loads((tmp_path / f"{arch}__{shape}__16x16.json")
                      .read_text()) == r
    assert D.RESULTS_DIR.parts[-2:] == ("results", "torch_dryrun")
    assert r["argument_bytes_per_device"] == _ref_argument_bytes(arch, shape)
    assert r["flops"] > 0 and r["peak_bytes_per_device"] > 0
    assert r["flops"] * r["num_devices"] == r["flops_global"]
    # the reference's quantity: each scanned loop (periods, microbatches)
    # counted once, so far below the full count
    assert 0 < r["flops_per_scan_body"] < r["flops"] / (
        8 if r["kind"] == "train" else 2)
    assert r["collective_bytes"] is None and r["temp_bytes_per_device"] is None
    assert r["peak_bytes_per_device"] == r["argument_bytes_per_device"] + \
        r["output_bytes_per_device"] - r["alias_bytes_per_device"]
    if r["kind"] == "train":
        tokens = INPUT_SHAPES[shape].global_batch * INPUT_SHAPES[shape].seq_len
        assert r["flops_global"] >= 6 * r["active_params"] * tokens


def _direct(cfg, shape, variant):
    """The step's counts from one meta run of all of it."""
    step, args, _ = D.build_step(cfg, shape, variant)
    with D._ByteCounter() as bc, \
            torch.utils.flop_counter.FlopCounterMode(display=False) as fc:
        step(*args)
    return fc.get_total_flops(), bc.bytes


@pytest.mark.parametrize("arch,seq,mb", [("mixtral-8x7b", 32, 4),
                                         ("xlstm-125m", 4, 3),
                                         ("jamba-v0.1-52b", 384, 2)])
def test_count_step_extrapolation_is_exact(arch, seq, mb):
    """Three periods, `mb` microbatches of one row and loop trips
    (xlstm's four tokens, jamba's three Mamba chunks): the count
    extrapolated from corners equals a full meta run, bytes too."""
    cfg = get_config(arch, smoke=True)
    cfg = cfg.with_(num_layers=3 * len(T.layer_pattern(cfg)))
    shape = InputShape("t", seq, mb, "train")
    variant = {"microbatches": mb}
    saved = dict(S.MAMBA_OPTS)
    try:
        c = D.count_step(cfg, shape, variant)
        assert c["corners"] > 1
        assert (c["flops"], c["bytes"]) == _direct(cfg, shape, variant)
    finally:
        S.MAMBA_OPTS.update(saved)


COST_SCRIPT = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.devices()                  # 8 host devices before the module below
from repro.launch import dryrun as D
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.models import transformer as T
from repro.distributed.sharding import set_activation_mesh
cfg = get_config("mixtral-8x7b", smoke=True).with_(impl="ref",
                                                  num_layers=1)
shape = InputShape("t", 32, 8, "train")
out = {}
for data, mb, layers in ((1, 1, 1), (1, 2, 1), (8, 2, 1), (1, 1, 2)):
    cfg = cfg.with_(num_layers=layers)
    mesh = jax.make_mesh((data, 1), ("data", "model"),
                         devices=jax.devices()[:data],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    T.set_moe_dispatch_groups(data)
    set_activation_mesh(mesh)
    D.build_step._mesh = mesh
    step, args, shb = D.build_step(cfg, shape, {"microbatches": mb})
    with mesh:
        c = jax.jit(step, in_shardings=shb(mesh)).lower(*args).compile()
    out[f"{data}x{mb}" + ("" if layers == 1 else f"L{layers}")] = \
        c.cost_analysis()["flops"]
print(json.dumps(out))
'''


@pytest.fixture(scope="module", autouse=True)
def cost_proc(tmp_path_factory):
    """The reference's cost question in a subprocess, started with this
    module's first test so that it runs beside the others."""
    script = tmp_path_factory.mktemp("cost") / "cost.py"
    script.write_text(COST_SCRIPT)
    proc = subprocess.Popen(
        [sys.executable, str(script)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"})
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def test_reference_flops_are_per_device(cost_proc):
    try:
        out, err = cost_proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        cost_proc.kill()
        raise AssertionError(f"the reference's cost script ran past "
                             f"{TIMEOUT_S} s") from None
    assert cost_proc.returncode == 0, err[-3000:]
    f = json.loads(out.strip().splitlines()[-1])
    # per device: eight data ranks each count about an eighth
    assert f["8x2"] < f["1x2"] / 4
    # a scanned microbatch is counted once: two halves count about half
    assert f["1x2"] < 0.6 * f["1x1"]
    # so is a scanned layer period: a second layer adds only its update
    assert f["1x1L2"] < 1.1 * f["1x1"]


def _smoke_pair(arch):
    cfg = get_config(arch, smoke=True).with_(dtype="float32", impl="ref")
    jcfg = jget_config(arch, smoke=True).with_(dtype="float32", impl="ref")
    return cfg, jcfg


def test_dispatch_groups_match_reference():
    cfg, jcfg = _smoke_pair("mixtral-8x7b")
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(3))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16),
                                               dtype=np.int32)
    try:
        JT.set_moe_dispatch_groups(2)
        T.set_moe_dispatch_groups(2)
        want, wm = JT.forward(jcfg, jp, {"tokens": jnp.asarray(tokens)})
        got, gm = T.forward(cfg, tp, {"tokens": torch.from_numpy(tokens)})
        T.set_moe_dispatch_groups(1)
        one, _ = T.forward(cfg, tp, {"tokens": torch.from_numpy(tokens)})
    finally:
        JT.set_moe_dispatch_groups(1)
        T.set_moe_dispatch_groups(1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_array_equal(gm["expert_load"].numpy(),
                                  np.asarray(wm["expert_load"]))
    np.testing.assert_array_equal(gm["dropped"].numpy(),
                                  np.asarray(wm["dropped"]))
    assert not torch.equal(one, got)       # the setting is live


@pytest.mark.parametrize("lever", [None, "fused_y", "chunk_remat",
                                   "inline_ab"])
def test_mamba_lever_matches_reference(lever):
    """jamba's smoke mixer (d_model 256, d_state 8) over 192 tokens (two
    chunks: 128 shrunk to a divisor, 96): the output, the final state
    and the gradients of a fixed projection of both, against the
    reference's same lever."""
    cfg, _ = _smoke_pair("jamba-v0.1-52b")
    rng = np.random.default_rng(5)
    jp = JS_SSM.init_mamba(jax.random.PRNGKey(2), cfg.d_model, cfg.ssm,
                           jnp.float32)
    x = rng.standard_normal((2, 192, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 192, cfg.d_model)).astype(np.float32)
    opts = {} if lever is None else {lever: True}
    saved_j, saved_p = dict(JS_SSM.MAMBA_OPTS), dict(S.MAMBA_OPTS)
    try:
        JS_SSM.set_mamba_opts(**opts)
        S.set_mamba_opts(**opts)

        def jloss(p, xx):
            y, st = JS_SSM.mamba_seq(p, xx, cfg.ssm)
            return jnp.sum(y * w) + jnp.sum(st["ssm"]), (y, st["ssm"])
        (_, (jy, jh)), (jgp, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
        tp = {k: v.requires_grad_() for k, v in
              from_jax(jax.tree.map(np.asarray, jp)).items()}
        tx = torch.from_numpy(x).requires_grad_()
        y, st = S.mamba_seq(tp, tx, cfg.ssm)
        (torch.sum(y * torch.from_numpy(w)) + torch.sum(st["ssm"])).backward()
    finally:
        JS_SSM.MAMBA_OPTS.update(saved_j)
        S.MAMBA_OPTS.update(saved_p)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(st["ssm"].detach().numpy(), np.asarray(jh),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=TOL,
                               rtol=TOL)
    for k, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgp[k]),
                                   atol=TOL, rtol=TOL, err_msg=k)


def test_set_mamba_opts_rejects_unknown():
    with pytest.raises(ValueError, match="unknown Mamba"):
        S.set_mamba_opts(fused=True)


def test_cli_writes_under_torch_dryrun_only(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(D, "RESULTS_DIR", tmp_path / "torch_dryrun")
    saved = dict(S.MAMBA_OPTS)
    try:
        D.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                "--mamba-inline"])
    finally:
        S.MAMBA_OPTS.update(saved)
    assert "all dry-runs passed" in capsys.readouterr().out
    assert [p.name for p in tmp_path.rglob("*.json")] == \
        ["xlstm-125m__decode_32k__16x16.json"]
    assert (tmp_path / "torch_dryrun").is_dir()
