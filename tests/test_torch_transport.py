"""PyTorch port, the collectives of ranks that share one card through
staging buffers they all map (``launch.transport.SharedBuffers``,
``launch.mesh`` ``transport="shared"``), against the process group's own
collectives (``transport="group"``) and against the sums they define.

The reference has no counterpart: its collectives are XLA's, inside
``shard_map``. On the CPU the buffers are files every rank maps shared
(on a card, CUDA IPC; the ``cuda``-marked case runs that path); a
staging buffer of 40 bytes makes every collective here move in many
chunks, the last one short (64 KiB in the steps below).

Collectives: ``all_gather``, ``all_reduce`` (sum and max),
``reduce_scatter``, ``all_to_all`` and ``all_reduce_autograd`` (its
forward and backward) in float32, bfloat16 and int64, over the "data"
and "model" groups of a (2, 2) mesh and the four-rank "data" group of a
(4, 1) mesh. Each rank's inputs come from a numpy seed of (case, rank),
so the expected result is recomputed here: the shared transport's sums
run in the dtype in group-rank order, and equal that sum bit for bit;
the group's equal it exactly where the result is an exact function of
the inputs (gathers, all-to-alls, maxima, integer sums, two-rank sums)
and within one rounding a term elsewhere (atol = rtol = 1e-6 in
float32, 2e-2 in bfloat16). Every member of an all-reduce holds the same
bits.

End to end on (2, 2), float32 smoke configs, random weights from a
seed: mixtral-8x7b's and xlstm-125m's sharded decode steps
(``make_serve_step``) and mixtral-8x7b's ZeRO-3 training step give the
same bits under both transports (every group has two ranks, whose sum
is the same in either order). The ranks run in a subprocess that spawns
them (``launch.mesh.spawn_local``: a file rendezvous, collectives
bounded at 60 s, each spawn killed after 300 s), so this process forks
nothing. About 30 s on one worker.
"""
import json
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as MESH

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
STAGE = 40
DTYPES = ("float32", "bfloat16", "int64")
OPS = ("all_gather", "all_reduce", "all_reduce_max", "reduce_scatter",
       "all_to_all", "all_reduce_autograd")
# (mesh, group): the group's size is 2 on (2, 2) and 4 on (4, 1)
GROUPS = (((2, 2), "data"), ((2, 2), "model"), ((4, 1), "data"))
SHAPE = (8, 13)          # 104 elements: chunks of 40 bytes end short
STEP_CASES = ("serve-mixtral-8x7b", "serve-xlstm-125m", "train-mixtral-8x7b")
TOL = {"float32": 1e-6, "bfloat16": 2e-2, "int64": 0}


def _cases():
    return [f"{op}-{dt}-{m[0]}x{m[1]}-{g}" for m, g in GROUPS for op in OPS
            for dt in DTYPES if not (op == "all_reduce_autograd"
                                     and dt == "int64")]


CASES = _cases()


def _parse(name):
    op, dt, m, g = name.rsplit("-", 3)
    return op, dt, tuple(int(v) for v in m.split("x")), g


def _input(name, rank):
    """The rank's input of `name` (numpy; bfloat16 inputs are float32
    values that bfloat16 holds exactly)."""
    op, dt, _, _ = _parse(name)
    rng = np.random.default_rng([CASES.index(name), rank])
    if dt == "int64":
        return rng.integers(-1000, 1000, SHAPE).astype(np.int64)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    if dt == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _members(shape, group, rank):
    """This rank's group members, in group-rank order (row-major over
    (data, model))."""
    d, m = rank // shape[1], rank % shape[1]
    if group == "data":
        return [i * shape[1] + m for i in range(shape[0])]
    return [d * shape[1] + j for j in range(shape[1])]


PORT_SCRIPT = r'''
import json, pickle, sys, time
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import transport
from repro_torch.launch.mesh import (make_process_mesh,
                                     release_shared_buffers, spawn_local)
from repro_torch.models import model as M
from repro_torch.training import optimizer as O
from repro_torch.training.optimizer import _leaves

OUT = sys.argv[1]
CASES = json.loads(sys.argv[2])
STAGE = int(sys.argv[3])
STEP_CASES = json.loads(sys.argv[4])


def collectives(mesh, rank, shape):
    inputs = np.load(f"{OUT}/inputs.npz")
    out = {}
    for name in CASES:
        op, dt, m, group = name.rsplit("-", 3)
        if tuple(int(v) for v in m.split("x")) != shape:
            continue
        x = torch.from_numpy(inputs[f"{name}/{rank}"]).to(
            getattr(torch, dt))
        if op == "all_gather":
            y = mesh.all_gather(x, group)
        elif op == "all_reduce":
            y = mesh.all_reduce(x, group)
        elif op == "all_reduce_max":
            y = mesh.all_reduce(x, group, op="max")
        elif op == "reduce_scatter":
            y = mesh.reduce_scatter(x, group)
        elif op == "all_to_all":
            y = mesh.all_to_all(x, group)
        else:
            leaf = x.clone().requires_grad_(True)
            fwd = mesh.all_reduce_autograd(leaf * 2, group)
            (g,) = torch.autograd.grad(fwd, leaf, torch.ones_like(fwd))
            y = torch.stack([fwd.detach(), g])
        out[name] = y.float().numpy().copy()
    return out


def serve(mesh, arch):
    cfg = get_config(arch, smoke=True).with_(dtype="float32", impl="ref")
    params = M.init_params(cfg, seed=3, device="cpu")
    cache = M.T.init_cache(cfg, params, 4, 16)
    ps = SH.params_shardings(params, mesh, fsdp=True)
    cs = SH.cache_shardings(cache, mesh, seq_over_dp=arch != "mixtral-8x7b")
    step = M.make_serve_step(cfg, param_shardings=ps, cache_shardings=cs)
    p = SH.shard_tree(params, ps, copy=True)
    held = SH.shard_tree(cache, cs, copy=True)
    rng = np.random.default_rng(7)
    out, n = [], 0
    with torch.no_grad():
        for s in (5, 1, 1, 1):
            tokens = torch.from_numpy(rng.integers(0, 512, (4, s)))
            logits, held = step(p, {"tokens": tokens}, held, n)
            out.append(logits.numpy().copy())
            n += s
    return out + [t.numpy().copy() for t in _leaves(held)]


def train(mesh):
    cfg = get_config("mixtral-8x7b", smoke=True).with_(dtype="float32",
                                                       impl="ref")
    params = M.init_params(cfg, seed=4, device="cpu")
    ps = SH.params_shardings(params, mesh, fsdp=True)
    opt = O.adamw(1e-3, weight_decay=0.01)
    step = M.make_train_step(cfg, opt, microbatches=2, param_shardings=ps)
    p = SH.shard_tree(params, ps, copy=True)
    state = opt.init(p)
    rng = np.random.default_rng(8)
    losses = []
    for _ in range(2):
        b = {k: torch.from_numpy(rng.integers(0, 512, (8, 12)))
             for k in ("tokens", "labels")}
        p, state, m = step(p, state, b)
        losses.append(float(m["loss"]))
    return [np.asarray(losses)] + [t.detach().numpy().copy()
                                   for t in _leaves(p)]


def world(rank, shape):
    torch.set_num_threads(1)
    transport.STAGE_BYTES = STAGE
    group = make_process_mesh(*shape, device="cpu", transport="group")
    shared = make_process_mesh(*shape, device="cpu", transport="shared")
    res = {"auto_is_group": make_process_mesh(
               *shape, device="cpu").shared is None,
           "shared_on": shared.shared is not None and group.shared is None,
           "group": collectives(group, rank, shape),
           "shared": collectives(shared, rank, shape)}
    if shape == (2, 2):
        # the steps at a stage of 64 KiB (fewer barriers)
        release_shared_buffers()
        transport.STAGE_BYTES = 1 << 16
        shared = make_process_mesh(*shape, device="cpu", transport="shared")
        for name in STEP_CASES:
            kind, arch = name.split("-", 1)
            res[name] = {
                t: serve(m, arch) if kind == "serve" else train(m)
                for t, m in (("group", group), ("shared", shared))}
    return res


if __name__ == "__main__":
    t0 = time.perf_counter()
    res = {shape: spawn_local(world, shape[0] * shape[1], backend="gloo",
                              args=(shape,), wall_s=300.0)
           for shape in ((2, 2), (4, 1))}
    res["seconds"] = time.perf_counter() - t0
    with open(f"{OUT}/port.pkl", "wb") as fh:
        pickle.dump(res, fh)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("transport")
    arrays = {f"{n}/{r}": _input(n, r) for n in CASES
              for r in range(4)}
    np.savez(out / "inputs.npz", **arrays)
    (out / "port.py").write_text(PORT_SCRIPT)
    proc = subprocess.run(
        [sys.executable, str(out / "port.py"), str(out), json.dumps(CASES),
         str(STAGE), json.dumps(STEP_CASES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=TIMEOUT_S, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                                "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, f"the ranks failed:\n{proc.stdout[-6000:]}"
    with open(out / "port.pkl", "rb") as fh:
        return pickle.load(fh)


def _in_order_sum(parts, dtype):
    """The group's sum in its dtype, in group-rank order."""
    t = [torch.from_numpy(p).to(getattr(torch, dtype)) for p in parts]
    acc = t[0].clone()
    for p in t[1:]:
        acc += p
    return acc


def _expected(name, rank):
    """What `name` gives `rank`, from every member's input: (the result
    as float32, whether the process group's result must equal it
    exactly)."""
    op, dt, shape, group = _parse(name)
    members = _members(shape, group, rank)
    parts = [_input(name, r) for r in members]
    n, i = len(members), members.index(rank)
    exact = dt == "int64" or n == 2
    if op == "all_gather":
        return np.stack(parts), True
    if op == "all_reduce_max":
        return np.maximum.reduce(parts), True
    if op == "all_to_all":
        blocks = [np.split(p, n, axis=0)[i] for p in parts]
        return np.concatenate(blocks, axis=0), True
    total = _in_order_sum(parts, dt)
    if op == "all_reduce":
        return total.float().numpy(), exact
    if op == "reduce_scatter":
        return np.split(total.float().numpy(), n, axis=0)[i], exact
    twice = _in_order_sum([p * 2 for p in parts], dt).float().numpy()
    grad = 2 * _in_order_sum([np.ones(SHAPE, np.float32)] * n,
                             dt).float().numpy()
    return np.stack([twice, grad]), exact


@pytest.mark.parametrize("name", CASES)
def test_collective_equals_its_definition(runs, name):
    """The shared transport's result equals the in-order sum (or the
    gather, maximum, exchange) bit for bit on every rank; the process
    group's equals it exactly where that is defined, else within one
    rounding a term; all members of an all-reduce hold the same bits."""
    op, dt, shape, group = _parse(name)
    ranks = runs[shape]
    for rank, r in enumerate(ranks):
        want, exact = _expected(name, rank)
        got_shared, got_group = r["shared"][name], r["group"][name]
        assert got_shared.shape == want.shape == got_group.shape
        np.testing.assert_array_equal(got_shared, want, err_msg="shared")
        if exact:
            np.testing.assert_array_equal(got_group, want, err_msg="group")
        else:
            np.testing.assert_allclose(got_group, want, atol=TOL[dt],
                                       rtol=TOL[dt], err_msg="group")
        if op in ("all_reduce", "all_reduce_max", "all_reduce_autograd"):
            for other in _members(shape, group, rank):
                np.testing.assert_array_equal(
                    ranks[other]["shared"][name], got_shared)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_transport_choice(runs, shape):
    """On the CPU "auto" keeps the process group; "shared" maps the
    buffers."""
    for r in runs[shape]:
        assert r["auto_is_group"] and r["shared_on"]


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_steps_equal_across_transports(runs, case):
    """Logits, caches, losses and parameters bit for bit under both
    transports, on every rank of (2, 2)."""
    for r in runs[(2, 2)]:
        got, want = r[case]["shared"], r[case]["group"]
        assert len(got) == len(want) > 0
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.isfinite(g).all() if g.dtype.kind == "f" else True
            np.testing.assert_array_equal(g, w, err_msg=f"{case} [{i}]")


def test_unknown_transport_is_refused():
    with pytest.raises(ValueError, match="transport"):
        MESH.shared_buffers("cpu", "nccl")


CARD_SCRIPT = r'''
import sys
import torch
from repro_torch.launch.mesh import make_process_mesh, spawn_local


def world(rank):
    shared = make_process_mesh(2, 1, device="cuda:0")
    group = make_process_mesh(2, 1, device="cuda:0", transport="group")
    x = torch.randn(3, 1 << 20, device="cuda:0", generator=torch.Generator(
        "cuda:0").manual_seed(rank))
    pairs = [(shared.all_gather(x, "data"), group.all_gather(x, "data")),
             (shared.all_reduce(x, "data"), group.all_reduce(x, "data")),
             (shared.reduce_scatter(x[:2], "data"),
              group.reduce_scatter(x[:2], "data")),
             (shared.all_to_all(x[:2], "data"),
              group.all_to_all(x[:2], "data"))]
    return {"on": shared.shared is not None,
            "equal": [torch.equal(a, b) for a, b in pairs]}


if __name__ == "__main__":
    res = spawn_local(world, 2, backend="gloo", wall_s=120.0)
    assert all(r["on"] and all(r["equal"]) for r in res), res
'''


@pytest.mark.cuda
def test_card_ranks_share_buffers(tmp_path):
    """Two ranks on one card: "auto" maps the buffers through CUDA IPC,
    and each collective equals gloo's bit for bit (two ranks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (tmp_path / "card.py").write_text(CARD_SCRIPT)
    proc = subprocess.run(
        [sys.executable, str(tmp_path / "card.py")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=TIMEOUT_S,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout[-4000:]
