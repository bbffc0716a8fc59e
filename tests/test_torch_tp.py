"""PyTorch port, tensor-parallel execution (model > 1): ``models.model.
make_train_step(grad_shardings=)`` and ``make_prefill_step(
param_shardings=)`` on (1, 2) and (2, 2) ("data", "model") ``launch.
mesh.ProcessMesh``es of gloo ranks on the CPU, against the reference's
one-process steps at ``set_moe_dispatch_groups(data)``: float32 smoke
configs, ``impl="ref"``, the reference's weights (``params.from_jax``),
two steps of 8 x 16 tokens, AdamW at lr 1e-4 with weight decay 0.01.

Tolerances, as ``tests/test_torch_zero2.py`` states them: loss and aux
loss atol = rtol = 1e-5; expert loads and drops exactly; parameters
after two updates atol = 5e-4, rtol = 1e-4 (AdamW moves an element whose
gradient sits at its float32 noise by up to 2 lr a step, so 4 lr over
two steps must stay under the atol: at lr 1e-3 the port's own
one-process step misses the reference by 6.9e-4 at qwen3's embed[4, 50],
whose step-2 gradient is -1.65e-7 there and 8.9e-8 here); the float32
accumulator, assembled from every rank's shard, against the reference's
gradients atol = rtol = 1e-5 (the reference's step hands them to a
capturing optimizer); step 1's sharded update against the unsharded
AdamW update of the assembled accumulator atol = rtol = 1e-6 (the same
gradients; only the clip's norm is summed in another order). Logits of
``forward`` and of the prefill atol = rtol = 1e-4 (float32 through two
layers, sums in another order, as ``tests/test_torch_model.py``); the
prefill's greedy tokens exactly.

Cases: mixtral on (1, 2) and (2, 2) at one and two microbatches; a clip
of 0.05 on (2, 2), which every step hits, also with the embedding held
whole on every rank (a leaf the clip must count once); qwen3-32b (a
dense FFN) and command-r+ (tied embeddings) on (1, 2); the prefill of
mixtral on (2, 2); ``forward`` of every one of the twelve smoke configs
on (1, 2); the three operators of ``distributed.tensor_parallel``
against their definitions, backward included; each rank's shard shapes
against ``params_shardings(fsdp=False)`` (parameters) and ``(fsdp=True)``
(μ, ν). The ranks run in a subprocess that spawns them (``launch.mesh.
spawn_local``: a file rendezvous, collectives bounded at 60 s, each
spawn killed after 300 s), so this process forks nothing. The raises and
the layout identities run in process. About 75 s on one worker.
"""
import json
import os
import pathlib
import pickle
import subprocess
import sys
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import InputShape
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import (LogicalMesh, ProcessMesh, dp_axes,
                                     make_production_mesh)
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.training import optimizer as O

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 660
LOSS_TOL, ACC_TOL, FWD_TOL = 1e-5, 1e-5, 1e-4
STEP_ATOL, STEP_RTOL = 5e-4, 1e-4
LR, CLIP_SMALL, STEPS = 1e-4, 0.05, 2
UPDATE_TOL = 1e-6
MIXTRAL, QWEN3, CMDR = "mixtral-8x7b", "qwen3-32b", "command-r-plus-104b"
# name: (arch, (data, model), microbatches, clip norm, a leaf held whole
# on every rank or None)
CASES = {"mixtral-1x2-mb1": (MIXTRAL, (1, 2), 1, 1.0, None),
         "mixtral-1x2-mb2": (MIXTRAL, (1, 2), 2, 1.0, None),
         "mixtral-2x2-mb1": (MIXTRAL, (2, 2), 1, 1.0, None),
         "mixtral-2x2-mb2": (MIXTRAL, (2, 2), 2, 1.0, None),
         "mixtral-2x2-clip": (MIXTRAL, (2, 2), 2, CLIP_SMALL, None),
         "mixtral-2x2-whole-embed": (MIXTRAL, (2, 2), 2, CLIP_SMALL,
                                     "embed"),
         "qwen3-1x2": (QWEN3, (1, 2), 1, 1.0, None),
         "command-r-1x2": (CMDR, (1, 2), 2, 1.0, None)}


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


PORT_SCRIPT = r'''
import dataclasses, json, pickle, sys, time
import numpy as np
import torch
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch.mesh import make_process_mesh, spawn_local
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.params import from_jax
from repro_torch.training import optimizer as O
from repro_torch.training.optimizer import _leaves

OUT = sys.argv[1]
CASES = json.loads(sys.argv[2])
LR, STEPS = float(sys.argv[3]), int(sys.argv[4])


def unflatten(flat):
    root = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    def fix(n):
        if isinstance(n, dict):
            if n and all(k.isdigit() for k in n):
                return [fix(n[str(i)]) for i in range(len(n))]
            return {k: fix(v) for k, v in n.items()}
        return n
    return fix(root)


def setup(arch):
    cfg = get_config(arch, smoke=True).with_(dtype="float32", impl="ref")
    return cfg, from_jax(unflatten(dict(np.load(f"{OUT}/w-{arch}.npz"))))


def batches():
    data = np.load(f"{OUT}/batches.npz")
    return [{k: torch.from_numpy(data[f"{k}{i}"])
             for k in ("tokens", "labels")} for i in range(STEPS)]


def shapes(tree):
    return [tuple(t.shape) for t in _leaves(tree)]


def train_case(mesh, arch, mb, clip, whole):
    cfg, params = setup(arch)
    gs = SH.params_shardings(params, mesh, fsdp=True)
    layout = SH.params_shardings(params, mesh, fsdp=False)
    if whole:
        gs[whole] = layout[whole] = SH.replicated(mesh)
    opt = O.adamw(LR, weight_decay=0.01, clip_norm=clip)
    state = opt.init(SH.shard_tree(params, gs))
    step = M.make_train_step(cfg, opt, microbatches=mb, grad_shardings=gs)
    p = SH.shard_tree(params, step.param_shardings, copy=True)
    metrics = []
    for i, b in enumerate(batches()):
        if i == 0:   # step 1 in its two halves, the accumulator kept
            m, g = step.grads(p, b)
            local_sq = float(sum(torch.sum(a * a) for a in _leaves(g)))
            acc = [a.numpy().copy() for a in _leaves(g)]
            p, state = step.apply(p, g, state)
            params1 = [t.numpy().copy() for t in _leaves(p)]
        else:
            p, state, m = step(p, state, b)
        metrics.append({k: v.numpy().tolist() for k, v in m.items()})
    want_p = shapes(SH.shard_tree(params, layout))
    want_o = shapes(SH.shard_tree(params, gs))
    return dict(metrics=metrics, acc=acc, local_sq=local_sq, params1=params1,
                params=[t.numpy().copy() for t in _leaves(p)],
                param_specs=[tuple(s.spec) for s in
                             _leaves(step.param_shardings)],
                fsdp_false_specs=[tuple(s.spec) for s in _leaves(layout)],
                grad_specs=[tuple(s.spec) for s in _leaves(gs)],
                shapes_ok=shapes(p) == want_p,
                moments_ok=shapes(state["mu"]) == shapes(state["nu"])
                == want_o,
                stats=dict(step.stats))


def forwards(mesh):
    out = {}
    data = np.load(f"{OUT}/forward.npz")
    for arch in list_archs():
        cfg, params = setup(arch)
        batch = {k.split("/", 1)[1]: torch.from_numpy(v)
                 for k, v in data.items() if k.startswith(arch + "/")}
        shards = SH.shard_tree(params, SH.params_shardings(
            params, mesh, fsdp=False), copy=True)
        with torch.no_grad():
            logits, m = T.forward(cfg, shards, batch, data_mesh=mesh)
            if logits.shape[-1] != cfg.padded_vocab:
                logits = TP.gather_from_model(logits, mesh, 2)
        out[arch] = dict(logits=logits.numpy().copy(),
                         metrics={k: v.numpy().tolist()
                                  for k, v in m.items()},
                         vocab_split=shards["embed"].shape[0]
                         != params["embed"].shape[0])
    return out


def operators(mesh):
    r = mesh.index("model")
    x = (torch.arange(12.).reshape(3, 4) * (r + 1)).requires_grad_()
    y = TP.copy_to_model(x, mesh)
    y.backward(torch.full((3, 4), float(r + 1)))
    copy = dict(y=y.detach().numpy().copy(), grad=x.grad.numpy().copy())
    x = (torch.arange(12.).reshape(3, 4) * (r + 1)).requires_grad_()
    y = TP.reduce_from_model(x, mesh)
    y.backward(torch.full((3, 4), float(r + 1)))
    reduce = dict(y=y.detach().numpy().copy(), grad=x.grad.numpy().copy())
    x = (torch.arange(6.).reshape(3, 2) + 10 * r).requires_grad_()
    y = TP.gather_from_model(x, mesh, 1)
    y.backward(torch.arange(12.).reshape(3, 4))
    gather = dict(y=y.detach().numpy().copy(), grad=x.grad.numpy().copy())
    return dict(rank=r, copy=copy, reduce=reduce, gather=gather)


def prefill(mesh):
    cfg, params = setup("mixtral-8x7b")
    ps = SH.params_shardings(params, mesh, fsdp=False)
    step = M.make_prefill_step(cfg, param_shardings=ps)
    batch = {"tokens": torch.from_numpy(np.load(f"{OUT}/prefill.npy"))}
    with torch.no_grad():
        logits, m = step(SH.shard_tree(params, ps, copy=True), batch)
    return dict(logits=logits.numpy().copy(),
                metrics={k: v.numpy().tolist() for k, v in m.items()},
                host_ms=dict(mesh.host_ms))


def bf16_case():
    cfg = get_config("mixtral-8x7b", smoke=True).with_(
        num_layers=1, dtype="bfloat16", impl="ref")
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    rng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    return cfg, M.init_params(cfg, 3, "cpu"), batch


def bf16_forward(mesh=None):
    """The bf16 case's logits (gathered) and loss, on `mesh`'s shards or
    in one process."""
    cfg, params, batch = bf16_case()
    if mesh is not None:
        params = SH.shard_tree(params, SH.params_shardings(
            params, mesh, fsdp=False), copy=True)
    with torch.no_grad():
        logits, _ = T.forward(cfg, params, batch, data_mesh=mesh)
        _, m = M.loss_fn(cfg, params, batch, data_mesh=mesh)
    if mesh is not None:
        logits = TP.gather_from_model(logits, mesh, 2)
    return dict(logits=logits.float().numpy().copy(), loss=float(m["loss"]))


def world(rank, shape):
    torch.set_num_threads(1)
    mesh = make_process_mesh(*shape, device="cpu")
    out = {"coords": mesh.coords}
    for name, (arch, mshape, mb, clip, whole) in CASES.items():
        if tuple(mshape) == shape:
            T.set_moe_dispatch_groups(shape[0])
            try:
                out[name] = train_case(mesh, arch, mb, clip, whole)
            finally:
                T.set_moe_dispatch_groups(1)
    if shape == (1, 2):
        out["forward"] = forwards(mesh)
        out["operators"] = operators(mesh)
        out["bf16"] = bf16_forward(mesh)
    else:
        out["prefill"] = prefill(mesh)
    return out


if __name__ == "__main__":
    t0 = time.perf_counter()
    res = {}
    for shape in ((1, 2), (2, 2)):
        res[shape] = spawn_local(world, shape[0] * shape[1], backend="gloo",
                                 args=(shape,), wall_s=300.0)
    res["bf16"] = bf16_forward()
    res["seconds"] = time.perf_counter() - t0
    with open(f"{OUT}/port.pkl", "wb") as fh:
        pickle.dump(res, fh)
'''


def _capturing(opt):
    """The reference's optimizer `opt`, its state also holding the last
    step's gradients (so the reference's own step hands them out)."""
    def init(p):
        return {"inner": opt.init(p), "grads": jax.tree.map(
            lambda x: jnp.zeros(x.shape, jnp.float32), p)}

    def update(p, g, s):
        p, inner = opt.update(p, g, s["inner"])
        return p, {"inner": inner,
                   "grads": jax.tree.map(lambda x: x.astype(jnp.float32), g)}
    return JO.Optimizer(init=init, update=update)


def _jsmoke(arch):
    return jget_config(arch, smoke=True).with_(dtype="float32", impl="ref")


def _forward_batch(cfg, rng, b=2, s=8):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "audio":
        batch["enc_embeds"] = (rng.standard_normal(
            (b, cfg.encdec.encoder_seq_len, cfg.d_model)) * 0.02).astype(
                np.float32)
    if cfg.family == "vlm":
        batch["vis_embeds"] = (rng.standard_normal((b, s, cfg.d_model))
                               * 0.02).astype(np.float32)
        batch["vis_mask"] = np.broadcast_to(np.arange(s)[None] < 4,
                                            (b, s)).copy()
        if cfg.rope == "mrope":
            batch["positions"] = rng.integers(0, s, (b, s, 3)).astype(
                np.int32)
    return batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    init = jax.jit(JM.init_params, static_argnums=0)
    weights = {}
    for arch in list_archs():
        weights[arch] = init(_jsmoke(arch), jax.random.PRNGKey(1))
        np.savez(out / f"w-{arch}.npz",
                 **_flatten(jax.tree.map(np.asarray, weights[arch])))
    rng = np.random.default_rng(4)
    batches = [{k: rng.integers(0, 512, (8, 16), dtype=np.int32)
                for k in ("tokens", "labels")} for _ in range(STEPS)]
    np.savez(out / "batches.npz", **{f"{k}{i}": b[k] for i, b in
                                     enumerate(batches) for k in b})
    fwd = {arch: _forward_batch(_jsmoke(arch), rng) for arch in list_archs()}
    np.savez(out / "forward.npz", **{f"{a}/{k}": v for a, b in fwd.items()
                                     for k, v in b.items()})
    prefill_tokens = rng.integers(0, 512, (8, 16), dtype=np.int32)
    np.save(out / "prefill.npy", prefill_tokens)
    (out / "port.py").write_text(PORT_SCRIPT)
    proc = subprocess.Popen(
        [sys.executable, str(out / "port.py"), str(out),
         json.dumps(CASES), str(LR), str(STEPS)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    ref, done = {}, {}
    try:
        for name, (arch, (dp, _), mb, clip, _) in CASES.items():
            if (arch, dp, mb, clip) in done:   # the layout changes nothing
                ref[name] = ref[done[arch, dp, mb, clip]]
                continue
            done[arch, dp, mb, clip] = name
            JT.set_moe_dispatch_groups(dp)
            opt = _capturing(JO.adamw(LR, weight_decay=0.01, clip_norm=clip))
            step = jax.jit(JM.make_train_step(_jsmoke(arch), opt,
                                              microbatches=mb))
            p, state, metrics, grads = weights[arch], None, [], None
            state = opt.init(p)
            for b in batches:
                p, state, m = step(p, state, b)
                metrics.append({k: np.asarray(v) for k, v in m.items()})
                if grads is None:
                    grads = jax.tree.map(np.asarray, state["grads"])
            ref[name] = dict(metrics=metrics, grads=_flatten(grads),
                             params=_flatten(jax.tree.map(np.asarray, p)),
                             init=_flatten(jax.tree.map(np.asarray,
                                                        weights[arch])))
        JT.set_moe_dispatch_groups(2)
        lg, m = jax.jit(JM.make_prefill_step(_jsmoke(MIXTRAL)))(
            weights[MIXTRAL], {"tokens": prefill_tokens})
        ref["prefill"] = dict(logits=np.asarray(lg), metrics={
            k: np.asarray(v) for k, v in m.items()})
        JT.set_moe_dispatch_groups(1)
        ref["forward"] = {}
        for arch in list_archs():
            lg, m = JT.forward(_jsmoke(arch), weights[arch],
                               {k: jnp.asarray(v)
                                for k, v in fwd[arch].items()})
            ref["forward"][arch] = dict(logits=np.asarray(lg), metrics={
                k: np.asarray(v) for k, v in m.items()})
    finally:
        JT.set_moe_dispatch_groups(1)
        try:
            log, _ = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            raise AssertionError(f"the ranks ran past {TIMEOUT_S} s:\n"
                                 f"{log[-4000:]}") from None
    assert proc.returncode == 0, f"the ranks failed:\n{log[-6000:]}"
    with open(out / "port.pkl", "rb") as fh:
        port = pickle.load(fh)
    return {"ref": ref, "port": port}


def _logical(shape):
    return LogicalMesh(OrderedDict(zip(("data", "model"), shape)),
                       ("data", "model"))


def _assembled(ranks, name, key, specs_key, shape):
    """Every leaf of rank results `key`, assembled from all ranks'
    shards under the specs `specs_key`."""
    mesh = _logical(shape)
    r0 = ranks[0][name]
    return [SH.assemble([torch.from_numpy(r[name][key][i]) for r in ranks],
                        SH.NamedSharding(mesh, SH.P(*spec))).numpy()
            for i, spec in enumerate(r0[specs_key])]


@pytest.mark.parametrize("case", list(CASES))
def test_tp_step_matches_reference_step(runs, case):
    """Loss, aux loss, loads and drops of both steps on every rank; the
    parameters after two steps, assembled from every rank's shard."""
    _, shape, *_ = CASES[case]
    ref, ranks = runs["ref"][case], runs["port"][shape]
    for r in ranks:
        for want, got in zip(ref["metrics"], r[case]["metrics"]):
            for k in ("loss", "aux_loss"):
                np.testing.assert_allclose(got[k], want[k], atol=LOSS_TOL,
                                           rtol=LOSS_TOL, err_msg=k)
            for k in ("expert_load", "dropped"):
                if k in want:
                    np.testing.assert_array_equal(np.asarray(got[k]),
                                                  want[k], err_msg=k)
    got = _assembled(ranks, case, "params", "param_specs", shape)
    for (k, want), g in zip(ref["params"].items(), got):
        np.testing.assert_allclose(g, want, atol=STEP_ATOL, rtol=STEP_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_assembled_accumulator_equals_reference_gradients(runs, case):
    """Step 1's float32 accumulator shards, assembled over data and
    model, against the reference's gradients: a model rank's gradient
    summed twice over the group (a summing gather, a summing copy after
    a row product) would show here as a factor of 2."""
    _, shape, *_ = CASES[case]
    ref, ranks = runs["ref"][case], runs["port"][shape]
    got = _assembled(ranks, case, "acc", "grad_specs", shape)
    assert len(got) == len(ref["grads"])
    for (k, want), g in zip(ref["grads"].items(), got):
        np.testing.assert_allclose(g, want, atol=ACC_TOL, rtol=ACC_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_update_equals_unsharded_update(runs, case):
    """Step 1's parameters, assembled, against ``optimizer.update`` of
    the whole parameters on the assembled accumulator: the clip's norm
    summed over both axes, each shard updated and gathered back."""
    _, shape, _, clip, _ = CASES[case]
    ranks = runs["port"][shape]
    g = [torch.from_numpy(a) for a in
         _assembled(ranks, case, "acc", "grad_specs", shape)]
    p0 = [torch.from_numpy(np.array(a)) for a in
          runs["ref"][case]["init"].values()]
    opt = O.adamw(LR, weight_decay=0.01, clip_norm=clip)
    want, _ = opt.update(p0, g, opt.init(p0))
    got = _assembled(ranks, case, "params1", "param_specs", shape)
    for w, a in zip(want, got):
        np.testing.assert_allclose(a, w.numpy(), atol=UPDATE_TOL,
                                   rtol=UPDATE_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_rank_layouts_are_the_dry_runs(runs, case):
    """Each rank holds its parameters as ``params_shardings(fsdp=False)``
    and μ, ν as ``(fsdp=True)``; the step's parameter layout is the
    former entry for entry; data replicas hold equal parameters."""
    _, shape, *_ = CASES[case]
    ranks = runs["port"][shape]
    for r in ranks:
        c = r[case]
        assert c["shapes_ok"] and c["moments_ok"]
        assert c["param_specs"] == c["fsdp_false_specs"]
        twin = next(q for q in ranks if q["coords"][1] == r["coords"][1])
        for a, b in zip(c["params"], twin[case]["params"]):
            assert np.array_equal(a, b)


def test_clip_is_global_over_both_axes(runs):
    """At clip 0.05 every step clips: the reference's gradient norm is
    far above it, while each rank's own accumulator shard holds well
    under its square; the step matches the reference all the same."""
    ranks = runs["port"][(2, 2)]
    g = runs["ref"]["mixtral-2x2-clip"]["grads"]
    total = sum(float(np.sum(v.astype(np.float64) ** 2)) for v in g.values())
    assert total > CLIP_SMALL ** 2 * 100
    for r in ranks:
        assert r["mixtral-2x2-clip"]["local_sq"] < 0.9 * total


def test_whole_leaf_counted_once(runs):
    """The embedding held whole on every (2, 2) rank (its accumulator
    too; the head stays vocabulary-parallel): its squared norm sits in
    each rank's own sum, yet the step, which matches the reference at
    clip 0.05, counts it once."""
    g = runs["ref"]["mixtral-2x2-whole-embed"]["grads"]
    emb = float(np.sum(g["embed"].astype(np.float64) ** 2))
    total = sum(float(np.sum(v.astype(np.float64) ** 2)) for v in g.values())
    assert emb > 0.01 * total
    for r in runs["port"][(2, 2)]:
        assert r["mixtral-2x2-whole-embed"]["local_sq"] >= emb * (1 - 1e-4)
        assert r["mixtral-2x2-whole-embed"]["local_sq"] > \
            r["mixtral-2x2-clip"]["local_sq"]


def test_tp_prefill_matches_reference_prefill(runs):
    """The (2, 2) prefill: every rank returns the global (B, 1, V)
    last-position logits, the reference's within 1e-4, its greedy tokens
    and loads exactly."""
    ref, ranks = runs["ref"]["prefill"], runs["port"][(2, 2)]
    for r in ranks:
        got = r["prefill"]
        assert got["logits"].shape == ref["logits"].shape
        np.testing.assert_allclose(got["logits"], ref["logits"],
                                   atol=FWD_TOL, rtol=FWD_TOL)
        assert np.array_equal(got["logits"].argmax(-1),
                              ref["logits"].argmax(-1))
        for k in ("expert_load", "dropped"):
            np.testing.assert_array_equal(np.asarray(got["metrics"][k]),
                                          ref["metrics"][k], err_msg=k)
        np.testing.assert_allclose(got["metrics"]["aux_loss"],
                                   ref["metrics"]["aux_loss"], atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
    assert "all_reduce/model" in ranks[0]["prefill"]["host_ms"]


@pytest.mark.parametrize("arch", list_archs())
def test_tp_forward_matches_reference_forward(runs, arch):
    """``forward`` on this rank's shards of the (1, 2) layout, its
    vocabulary columns gathered, against the reference's ``forward``."""
    ref = runs["ref"]["forward"][arch]
    for r in runs["port"][(1, 2)]:
        got = r["forward"][arch]
        assert got["vocab_split"]
        np.testing.assert_allclose(got["logits"], ref["logits"],
                                   atol=FWD_TOL, rtol=FWD_TOL)
        for k in ("expert_load", "dropped"):
            if k in ref["metrics"]:
                np.testing.assert_array_equal(np.asarray(got["metrics"][k]),
                                              ref["metrics"][k], err_msg=k)


def test_bf16_tp_rounds_where_one_process_rounds(runs):
    """bf16, the mixtral smoke config at 1 layer, 4 x 64 tokens, a
    drop-free capacity: the (1, 2) forward against the port's one-process
    forward. The expert partials are summed in float32 before the
    combine, where one process rounds the expert outputs, so the logits
    match but for a few float32 sum-order ties and the loss within 1e-5;
    summed after the combine, most logits move by an ulp and the loss by
    ~1e-4, which fails here."""
    one = runs["port"]["bf16"]
    for r in runs["port"][(1, 2)]:
        got = r["bf16"]
        moved = float(np.mean(got["logits"] != one["logits"]))
        assert moved < 0.01, moved
        assert abs(got["loss"] - one["loss"]) <= LOSS_TOL


def test_operators_against_their_definitions(runs):
    """copy: identity, gradient summed; reduce: sum, gradient as it is;
    gather: concatenation, gradient this rank's slice with no sum (a
    summing backward would give twice the slice)."""
    ops = [r["operators"] for r in runs["port"][(1, 2)]]
    base = np.arange(12.).reshape(3, 4)
    for o in ops:
        r = o["rank"]
        np.testing.assert_array_equal(o["copy"]["y"], base * (r + 1))
        np.testing.assert_array_equal(o["copy"]["grad"],
                                      np.full((3, 4), 1.0 + 2.0))
        np.testing.assert_array_equal(o["reduce"]["y"], base * 3)
        np.testing.assert_array_equal(o["reduce"]["grad"],
                                      np.full((3, 4), r + 1.0))
        np.testing.assert_array_equal(
            o["gather"]["y"], np.concatenate(
                [np.arange(6.).reshape(3, 2) + 10 * q for q in (0, 1)], 1))
        np.testing.assert_array_equal(o["gather"]["grad"],
                                      base[:, 2 * r:2 * r + 2])


# ------------------------------------------------------------ in process


@pytest.mark.parametrize("arch", list_archs())
def test_zero2_parameter_layout_is_fsdp_false(arch):
    """``grad_shardings`` without the data axes is ``params_shardings(
    fsdp=False)``, entry for entry, on the meshes the reference's
    dry-run uses (16x16, 32x8, 2x16x16) and on (2, 2)."""
    aparams = M.abstract_params(get_config(arch))
    for mesh in (make_production_mesh(), make_production_mesh(
            shape=(32, 8)), make_production_mesh(multi_pod=True),
            _logical((2, 2))):
        got = SH.without_axes(SH.params_shardings(aparams, mesh, fsdp=True),
                              dp_axes(mesh))
        want = SH.params_shardings(aparams, mesh, fsdp=False)
        assert [s.spec for s in O._leaves(got)] == \
            [s.spec for s in O._leaves(want)]


def _meshes(shape):
    """One ``ProcessMesh`` for each rank of `shape`, no process group
    (layouts only)."""
    n = shape[0] * shape[1]
    return [ProcessMesh(shape=OrderedDict(data=shape[0], model=shape[1]),
                        rank=r, coords=(r // shape[1], r % shape[1]),
                        device=torch.device("cpu")) for r in range(n)]


def test_copied_shards_own_their_storage_and_assemble():
    """``shard_tree(copy=True)``: contiguous tensors of their own (a
    view would keep the whole leaf alive); ``assemble`` of every rank's
    shards is the leaf again; a spec pickles as itself."""
    cfg = get_config(MIXTRAL, smoke=True).with_(dtype="float32")
    params = M.init_params(cfg, 0, "cpu")
    meshes = _meshes((2, 2))
    shs = [SH.params_shardings(params, m, fsdp=True) for m in meshes]
    parts = [SH.shard_tree(params, s, copy=True) for s in shs]
    full = O._leaves(params)
    for i, leaf in enumerate(full):
        mine = [O._leaves(p)[i] for p in parts]
        for t in mine:
            assert t.is_contiguous()
            assert t.untyped_storage().data_ptr() != \
                leaf.untyped_storage().data_ptr()
        spec = O._leaves(shs[0])[i]
        assert torch.equal(SH.assemble(mine, spec), leaf)
    spec = SH.P(None, "model", ("data", "pod"))
    assert pickle.loads(pickle.dumps(spec)) == spec
    assert type(pickle.loads(pickle.dumps(spec))) is SH.PartitionSpec


def test_model_dim_and_refusals():
    """``model_dim`` of the reference's layouts; a (1, 2) decode step
    builds with its cache's layout (``tests/test_torch_tp_decode.py``
    runs it); a decode step and a prefill build on the (2, 2) ZeRO-3
    layout (``tests/test_torch_zero3.py`` runs them); int8 banks and the
    EP plane at model > 1 raise naming the queue."""
    cfg = get_config(MIXTRAL, smoke=True).with_(dtype="float32")
    params = M.init_params(cfg, 0, "cpu")
    tp2 = _meshes((1, 2))[0]
    ps = SH.params_shardings(params, tp2, fsdp=False)
    assert SH.model_dim(ps["embed"]) == 0
    assert SH.model_dim(ps["layers"][0]["moe"]["experts"]["w_gate"]) == 3
    assert SH.model_dim(ps["layers"][0]["moe"]["experts"]["w_down"]) == 2
    assert SH.model_dim(ps["layers"][0]["attn"]["wk"]) == 1
    assert SH.model_dim(SH.replicated(tp2)) is None
    cs = SH.cache_shardings(M.abstract_cache(cfg, InputShape(
        "decode", 128, 2, "decode")), tp2)
    assert callable(M.make_serve_step(cfg, param_shardings=ps,
                                      cache_shardings=cs))
    M.make_serve_step(cfg, param_shardings=SH.params_shardings(
        params, _meshes((1, 1))[0], fsdp=False))
    m22 = _meshes((2, 2))[0]
    assert callable(M.make_prefill_step(cfg, param_shardings=SH.
                                        params_shardings(params, m22,
                                                         fsdp=True)))
    assert callable(M.make_serve_step(cfg, param_shardings=SH.
                                      params_shardings(params, m22,
                                                       fsdp=True),
                                      cache_shardings=cs))
    shards = SH.shard_tree(params, ps, copy=True)
    with pytest.raises(NotImplementedError, match="EP slot plane"):
        from repro_torch.models import transformer as T
        T.forward(cfg, shards, {"tokens": torch.zeros((1, 4), dtype=torch.
                                                      int32)},
                  data_mesh=tp2, ep_ctx=object())
    bank = dict(shards["layers"][0]["moe"]["experts"])
    bank = {k: v[0] for k, v in bank.items()}
    bank["w_up_scale"] = torch.ones(1)
    with pytest.raises(NotImplementedError, match="int8"):
        MOE.dispatch_moe({"router": {"w_gate": torch.zeros(256, 4)},
                          "experts": bank}, torch.zeros((1, 4, 256)),
                         top_k=2, num_experts=4, capacity_factor=1.0,
                         model_mesh=tp2)
