"""PyTorch port, the ZeRO-2 train step (``models.model.make_train_step(
grad_shardings=...)`` on a (data=2, model=1) ``launch.mesh.ProcessMesh``)
on two gloo ranks on the CPU, against the reference's one-process
``make_train_step`` at ``set_moe_dispatch_groups(2)``: the mixtral smoke
config at float32, ``impl="ref"``, the reference's weights, two steps of
8 x 16 tokens, AdamW at lr 1e-3 with weight decay 0.01.

Tolerances, as ``tests/test_torch_training.py`` states them: loss and
aux loss atol = rtol = 1e-5; expert loads and drops exactly; parameters
after two updates atol = 5e-4, rtol = 1e-4 (AdamW moves an element whose
gradient sits at its float32 noise by up to 2 lr a step); the gathered
float32 accumulator against the port's one-process gradients atol =
rtol = 1e-5.

Cases: one and two microbatches (clip 1.0); a clip of 0.05, which every
step hits, where each rank's own shard norm would clip differently; the
same with the embedding's gradient replicated (spec P()), all-reduced
and counted once in the norm. The ranks run in a subprocess that spawns
them (``launch.mesh.spawn_local``: a file rendezvous, collectives
bounded at 60 s, the ranks killed after 120 s), so this process forks
nothing. The raises run in process. About 40 s on one worker.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import ProcessMesh, make_process_mesh
from repro_torch.models import model as M
from repro_torch.params import from_jax
from repro_torch.training import optimizer as O

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
LOSS_TOL = 1e-5
STEP_ATOL, STEP_RTOL = 5e-4, 1e-4
LR, CLIP_SMALL, STEPS = 1e-3, 0.05, 2
# name: (microbatches, clip norm, the embedding's gradient replicated)
CASES = {"mb1": (1, 1.0, False), "mb2": (2, 1.0, False),
         "clip": (2, CLIP_SMALL, False), "replicated": (2, CLIP_SMALL, True)}


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
import json, sys, time
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
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


def setup():
    torch.set_num_threads(1)
    cfg = get_config("mixtral-8x7b", smoke=True).with_(dtype="float32",
                                                        impl="ref")
    params = from_jax(unflatten(dict(np.load(f"{OUT}/weights.npz"))))
    data = np.load(f"{OUT}/batches.npz")
    batches = [{k: torch.from_numpy(data[f"{k}{i}"])
                for k in ("tokens", "labels")} for i in range(STEPS)]
    return cfg, params, batches


def flat(tree):
    out = {}
    SH.tree_map_with_path(lambda p, v: out.__setitem__(
        "/".join(map(str, p)), v.detach().numpy().copy()), tree)
    return out


def rank(r):
    cfg, params, batches = setup()
    mesh = make_process_mesh(2, 1, device="cpu")
    T.set_moe_dispatch_groups(2)
    out = {}
    for name, (mb, clip, rep) in CASES.items():
        gs = SH.params_shardings(params, mesh, fsdp=True)
        if rep:
            gs["embed"] = SH.replicated(mesh)
        opt = O.adamw(LR, weight_decay=0.01, clip_norm=clip)
        state = opt.init(SH.shard_tree(params, gs))
        step = M.make_train_step(cfg, opt, microbatches=mb,
                                 grad_shardings=gs)
        _, acc = step.grads(params, batches[0])
        sq = [float(torch.sum(a * a)) for a in _leaves(acc)]
        gathered = {}
        for path, a in zip(flat(acc), _leaves(acc)):
            j = SH.data_dim(SH.leaf_at(gs, tuple(
                int(p) if p.isdigit() else p for p in path.split("/"))))
            gathered[path] = a.numpy().copy() if j is None else \
                mesh.all_gather(a.movedim(j, 0).contiguous(), "data") \
                .flatten(0, 1).movedim(0, j).numpy().copy()
        p, metrics = params, []
        for b in batches:
            p, state, m = step(p, state, b)
            metrics.append({k: v.numpy().tolist() for k, v in m.items()})
        out[name] = dict(
            metrics=metrics, params=flat(p), grads=gathered,
            acc_bytes=sum(a.numel() * a.element_size() for a in _leaves(acc)),
            mu_bytes=sum(a.numel() * a.element_size()
                         for a in _leaves(state["mu"])),
            nu_bytes=sum(a.numel() * a.element_size()
                         for a in _leaves(state["nu"])),
            local_sq=sum(sq), stats=dict(step.stats))
    return out


if __name__ == "__main__":
    t0 = time.perf_counter()
    cfg, params, batches = setup()
    T.set_moe_dispatch_groups(2)
    plain = {}
    for name, (mb, clip, rep) in CASES.items():
        opt = O.adamw(LR, weight_decay=0.01, clip_norm=clip)
        step = M.make_train_step(cfg, opt, microbatches=mb)
        _, g = step.grads(params, batches[0])
        p, state = params, opt.init(params)
        for b in batches:
            p, state, _ = step(p, state, b)
        plain[name] = dict(params=flat(p), grads=flat(g),
                           f32_bytes=sum(4 * v.numel() for v in _leaves(p)),
                           global_sq=float(sum(torch.sum(v * v)
                                               for v in _leaves(g))))
    ranks = spawn_local(rank, 2, backend="gloo", wall_s=120.0)
    res = {"seconds": time.perf_counter() - t0}
    arrays = {}
    for name in CASES:
        r0, r1 = ranks[0][name], ranks[1][name]
        res[name] = dict(
            metrics=[r0["metrics"], r1["metrics"]],
            acc_bytes=[r0["acc_bytes"], r1["acc_bytes"]],
            mu_bytes=[r0["mu_bytes"], r1["mu_bytes"]],
            nu_bytes=[r0["nu_bytes"], r1["nu_bytes"]],
            f32_bytes=plain[name]["f32_bytes"],
            local_sq=[r0["local_sq"], r1["local_sq"]],
            global_sq=plain[name]["global_sq"],
            ranks_equal=all(np.array_equal(r0["params"][k], r1["params"][k])
                            for k in r0["params"]),
            grads_equal=all(np.array_equal(r0["grads"][k], r1["grads"][k])
                            for k in r0["grads"]),
            stats=r0["stats"])
        for k, v in r0["params"].items():
            arrays[f"{name}/zero2/params/{k}"] = v
            arrays[f"{name}/plain/params/{k}"] = plain[name]["params"][k]
        for k, v in r0["grads"].items():
            arrays[f"{name}/zero2/grads/{k}"] = v
            arrays[f"{name}/plain/grads/{k}"] = plain[name]["grads"][k]
    np.savez(f"{OUT}/port.npz", **arrays)
    with open(f"{OUT}/port.json", "w") as fh:
        json.dump(res, fh)
'''


def _smoke():
    cfg = get_config("mixtral-8x7b", smoke=True).with_(dtype="float32",
                                                        impl="ref")
    jcfg = jget_config("mixtral-8x7b", smoke=True).with_(dtype="float32",
                                                         impl="ref")
    return cfg, jcfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero2")
    _, jcfg = _smoke()
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(1))
    np.savez(out / "weights.npz", **_flatten(jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(4)
    batches = [{k: rng.integers(0, jcfg.vocab_size, (8, 16), dtype=np.int32)
                for k in ("tokens", "labels")} for _ in range(STEPS)]
    np.savez(out / "batches.npz", **{f"{k}{i}": b[k] for i, b in
                                     enumerate(batches) for k in b})
    (out / "port.py").write_text(PORT_SCRIPT)
    proc = subprocess.Popen(
        [sys.executable, str(out / "port.py"), str(out),
         json.dumps(CASES), str(LR), str(STEPS)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    ref = {}
    try:
        JT.set_moe_dispatch_groups(2)
        for name, (mb, clip, _) in CASES.items():
            opt = JO.adamw(LR, weight_decay=0.01, clip_norm=clip)
            step = jax.jit(JM.make_train_step(jcfg, opt, microbatches=mb))
            p, state, metrics = jp, opt.init(jp), []
            for b in batches:
                p, state, m = step(p, state, b)
                metrics.append({k: np.asarray(v) for k, v in m.items()})
            ref[name] = dict(metrics=metrics,
                             params=_flatten(jax.tree.map(np.asarray, p)))
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
    return {"ref": ref, "port": json.loads((out / "port.json").read_text()),
            "arrays": dict(np.load(out / "port.npz"))}


@pytest.mark.parametrize("case", list(CASES))
def test_zero2_matches_reference_step(runs, case):
    ref, port = runs["ref"][case], runs["port"][case]
    for r in range(2):                    # every rank reports the same
        for want, got in zip(ref["metrics"], port["metrics"][r]):
            for k in ("loss", "aux_loss"):
                np.testing.assert_allclose(got[k], want[k], atol=LOSS_TOL,
                                           rtol=LOSS_TOL, err_msg=k)
            for k in ("expert_load", "dropped"):
                np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                              err_msg=k)
    assert port["ranks_equal"] and port["grads_equal"]
    for k, want in ref["params"].items():
        np.testing.assert_allclose(runs["arrays"][f"{case}/zero2/params/{k}"],
                                   want, atol=STEP_ATOL, rtol=STEP_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_gathered_accumulator_equals_one_process_gradients(runs, case):
    arrays = runs["arrays"]
    keys = [k.split("/grads/")[1] for k in arrays
            if k.startswith(f"{case}/plain/grads/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(arrays[f"{case}/zero2/grads/{k}"],
                                   arrays[f"{case}/plain/grads/{k}"],
                                   atol=LOSS_TOL, rtol=LOSS_TOL, err_msg=k)
        np.testing.assert_allclose(arrays[f"{case}/zero2/params/{k}"],
                                   arrays[f"{case}/plain/params/{k}"],
                                   atol=STEP_ATOL, rtol=STEP_RTOL, err_msg=k)


def test_accumulator_and_moments_are_half(runs):
    for case in ("mb1", "mb2", "clip"):
        p = runs["port"][case]
        assert p["acc_bytes"] == [p["f32_bytes"] // 2] * 2
        assert p["mu_bytes"] == p["nu_bytes"] == [p["f32_bytes"] // 2] * 2
        assert p["stats"]["transpose_bytes"] > 0     # data dims off dim 0
        assert p["stats"]["gathered_bytes"] > 0


def test_clip_is_global(runs):
    """At clip 0.05 every step clips; each rank's own shard norm is well
    under the global one, so a rank clipping by its own norm would take
    another step (and miss the reference, which the step matches)."""
    p = runs["port"]["clip"]
    assert p["global_sq"] > CLIP_SMALL ** 2 * 100
    for sq in p["local_sq"]:
        assert sq < 0.9 * p["global_sq"]
    assert sum(p["local_sq"]) == pytest.approx(p["global_sq"], rel=1e-5)


def test_replicated_leaf_counted_once(runs):
    """The embedding's gradient replicated over both ranks: its squared
    norm sits in each rank's local sum, but the step (which matches the
    reference) counts it once."""
    p, q = runs["port"]["replicated"], runs["port"]["clip"]
    emb = float(np.sum(runs["arrays"]["replicated/zero2/grads/embed"] ** 2))
    assert emb > 0.01 * p["global_sq"]
    assert sum(p["local_sq"]) == pytest.approx(p["global_sq"] + emb,
                                               rel=1e-5)
    assert p["acc_bytes"][0] > q["acc_bytes"][0]     # the whole leaf


def test_model_axis_and_mismatched_tree_raise():
    cfg, _ = _smoke()
    params = M.init_params(cfg, 0, "cpu")
    tp2 = ProcessMesh(shape=OrderedDict(data=1, model=2), rank=0,
                      coords=(0, 0), device=torch.device("cpu"))
    step = M.make_train_step(cfg, O.adamw(LR), grad_shardings=SH.
                             params_shardings(params, tp2))
    assert [s.spec for s in O._leaves(step.param_shardings)] == [
        s.spec for s in O._leaves(SH.params_shardings(params, tp2,
                                                      fsdp=False))]
    mesh = make_process_mesh(1, 1, device="cpu")
    other = M.init_params(get_config("qwen3-32b", smoke=True).with_(
        dtype="float32"), 0, "cpu")
    step = M.make_train_step(cfg, O.adamw(LR), grad_shardings=SH.
                             params_shardings(other, mesh))
    batch = {k: torch.zeros((2, 8), dtype=torch.int32)
             for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="does not match"):
        step(params, O.adamw(LR).init(params), batch)
    with pytest.raises(ValueError, match="NamedSharding"):
        M.make_train_step(cfg, O.adamw(LR), grad_shardings={"embed": None})


def test_one_rank_zero2_is_the_plain_step():
    """A (1, 1) process mesh: the ZeRO-2 step is the one-process step,
    bit for bit."""
    cfg, _ = _smoke()
    params = M.init_params(cfg, 0, "cpu")
    mesh = make_process_mesh(1, 1, device="cpu")
    gs = SH.params_shardings(params, mesh)
    opt = O.adamw(LR, weight_decay=0.01)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 8),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    for mb in (1, 2):
        got = M.make_train_step(cfg, opt, microbatches=mb, grad_shardings=gs)(
            params, opt.init(SH.shard_tree(params, gs)), batch)
        want = M.make_train_step(cfg, opt, microbatches=mb)(
            params, opt.init(params), batch)
        for a, b in zip(O._leaves(got[0]), O._leaves(want[0])):
            assert torch.equal(a, b)
        for k in want[2]:
            assert torch.equal(got[2][k], want[2][k]), k
    assert dataclasses.is_dataclass(mesh) and mesh.groups == {}
