"""PyTorch port, the expert-parallel layout (``params_shardings(
ep_experts=True)``): each model rank holds E/model whole experts and runs
the expert FFN on its experts' rows of the dispatch buffer, the outputs
all-gathered over the model group before the combine
(``models.moe.dispatch_moe(model_mesh=)`` on a bank of E/model experts,
``distributed.tensor_parallel.gather_experts``). The prefill, decode and
ZeRO-2 and ZeRO-3 train steps of ``launch.dryrun.build_step(mesh=
ProcessMesh, variant={"ep_experts": True, ...})`` on (1, 2) and (2, 2)
("data", "model") ``launch.mesh.ProcessMesh``es of gloo ranks on the CPU,
for the five MoE smoke configs (mixtral-8x7b, phi-3.5-moe, jamba-v0.1-52b,
llama4-maverick-400b-a17b, grok-1-314b; E = 4 each), float32,
``impl="ref"``, the reference's weights (``params.from_jax``).

Steps: the 8 x 16 prefill (fsdp=False on (1, 2); fsdp=False and ZeRO-3
on (2, 2)) at dispatch groups 2; the decode step, B 4 rows one token a
step for 4 steps from length 62 in a 128-slot cache (the writes cross
from the first half of the slots into the second), under the cache
layouts of the reference's dry-run (mixtral under each on both meshes,
each other config under one a mesh, in turn; fsdp=False on (1, 2),
ZeRO-3 on (2, 2)); one train
step, 8 x 16 tokens, AdamW at lr 1e-4, one microbatch, remat "none", on
the ZeRO-2 layout (parameters E-split, accumulator and moments the
reference's ``params_shardings(fsdp=True)``, F over "model") and on the
ZeRO-3 layout (``fsdp_params`` on), at dispatch groups 2.

Against the port's one-process step, bit for bit, where the split
changes nothing but the experts' placement: the prefill's logits and
metrics, and every decode step's logits, loads, drops and cache where
the cache's layout splits neither its sequence nor its rows (each
expert's rows are computed whole and only concatenated: the prediction
of the slice). Where it is not bit for bit, the test names the
operation that rounds differently and holds the step at
``tests/test_torch_zero3.py``'s tolerances: a decode step whose cache
splits on its sequence merges the ranks' attention by their softmax
statistics (``tensor_parallel.merge_softmax``); one whose rows split
over data runs each rank's dispatch group alone, at top-1 one row an
expert, which the CPU's ``bmm`` sums in another order than two; and a
train step at model 2 takes
its cross entropy over each rank's vocabulary columns
(``tensor_parallel.vocab_cross_entropy``: the sum of exponentials in two
parts), so its gradients, clip norm and parameters round otherwise (its
loss is compared at 1e-5). The MoE sublayer alone is bit for bit, forward
and backward: its output, its input's and router's gradients, and each
rank's expert gradients against the one-process gradients' rows.

Against the reference's one-process steps (``set_moe_dispatch_groups``
as the port's): logits atol = rtol = 1e-4, greedy tokens, loads and
drops exactly; loss atol = rtol = 1e-5; parameters after the step
atol = 5e-4, rtol = 1e-4; and the step's float32 accumulator, assembled
from the ranks' shards, against the port's one-process gradients at
atol = rtol = 1e-5.

Layout: each rank's parameter shards before and after equal
``params_shardings(ep_experts=True)``'s, its resident parameter,
optimizer and cache bytes the dry-run's reckoning; no expert leaf is
gathered over "model": ``ProcessMesh.nbytes["all_gather/model"]`` of
every step equals the weights the default layout gathers at use (its
banks are column/row pairs, never gathered), and the expert outputs'
gather ("all_gather/model/experts") moves E x rows x D floats a MoE
layer. The control: the expert outputs gathered in rolled order must
leave the one-process logits. The ranks run in a subprocess that spawns
them (``launch.mesh.spawn_local``: a file rendezvous, collectives
bounded at 60 s, each spawn killed after 300 s), so this process forks
nothing; the layouts' refusals run in process.
"""
import json
import os
import pathlib
import pickle
import subprocess
import sys
from collections import OrderedDict
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch.mesh import LogicalMesh, ProcessMesh
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.params import from_jax
from repro_torch.training import optimizer as O

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
LOSS_TOL, ACC_TOL, FWD_TOL = 1e-5, 1e-5, 1e-4
STEP_ATOL, STEP_RTOL = 5e-4, 1e-4
CONTROL_MOVE = 1e-2
LR = 1e-4
MIXTRAL = "mixtral-8x7b"
ARCHS = (MIXTRAL, "phi-3.5-moe", "jamba-v0.1-52b",
         "llama4-maverick-400b-a17b", "grok-1-314b")
MESHES = ((1, 2), (2, 2))
PB, PS = 8, 16                 # prefill and train batch: rows, tokens
# decode: B rows, one token a step from length START on (the slots
# before it hold the cache's zeros, visible alike to every package), so
# the writes cross from the first half of the SLOTS into the second
B, SLOTS, START, STEPS = 4, 128, 62, 4
LAYOUTS = {"default": {}, "seq_over_dp": {"seq_over_dp": True},
           "cache_heads_model": {"cache_heads_model": True}}
CELLS = [(a, m) for a in ARCHS for m in MESHES]


def _decodes():
    """(arch, mesh, layout) of the decode cases: mixtral under every
    layout on both meshes; each other config under one layout a mesh,
    the layouts in turn, so that each runs every config's sublayers."""
    names = list(LAYOUTS)
    return [(a, m, lay) for i, a in enumerate(ARCHS)
            for j, m in enumerate(MESHES)
            for lay in (names if a == MIXTRAL
                        else [names[(i + 2 * j) % len(names)]])]


DECODES = _decodes()


def _cell(arch, shape):
    return f"{arch}-{shape[0]}x{shape[1]}"


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
import json, math, pickle, sys, time
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_process_mesh, spawn_local
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.params import from_jax
from repro_torch.training import optimizer as O
from repro_torch.training.optimizer import _leaves

OUT = sys.argv[1]
ARCHS = json.loads(sys.argv[2])
LAYOUTS, DECODES = json.loads(sys.argv[3])
PB, PS, B, SLOTS, START, STEPS = json.loads(sys.argv[4])
LR = float(sys.argv[5])
MIXTRAL = ARCHS[0]


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


def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def shapes(tree):
    out = {}
    SH.tree_map_with_path(
        lambda path, t: out.__setitem__(path, tuple(t.shape)), tree)
    return out


def arrays(tree):
    return [t.detach().numpy().copy() for t in _leaves(tree)]


def specs(shardings, like):
    """The specs of `shardings` in the leaf order of the tree `like`."""
    out = []
    SH.tree_map_with_path(
        lambda path, _: out.append(tuple(SH.leaf_at(shardings, path).spec)),
        like)
    return out


def record(logits, m):
    return {"logits": logits.numpy().copy(),
            **{k: m[k].numpy().copy() for k in ("expert_load", "dropped")
               if k in m}}


def expert_bytes(cfg, tokens, groups, layers):
    """Bytes of the expert outputs' gathers: E x rows x D floats a MoE
    layer, rows its dispatch groups' capacities (``moe.dispatch_moe``)."""
    cap = max(1, math.ceil(cfg.moe.capacity_factor * cfg.moe.top_k
                           * (tokens // groups) / cfg.moe.num_experts))
    return layers * cfg.moe.num_experts * groups * cap * cfg.d_model * 4


def leaves_of(cache):
    out = {}
    for j, c in enumerate(cache):
        (mixer, sub), = c.items()
        for path, t in T._leaf_paths(sub):
            out["/".join(map(str, (j, mixer) + path))] = t
    return out


class Rolled:
    """The control: the expert outputs gathered, then rolled by one
    rank's block of experts (each expert's rows land on another's)."""

    def __enter__(self):
        self.inner = inner = TP.gather_experts

        def rolled(y, mesh):
            return torch.roll(inner(y, mesh), y.shape[0], dims=0)
        TP.gather_experts = rolled
        return self

    def __exit__(self, *exc):
        TP.gather_experts = self.inner


def prefill(mesh, cfg, params, control):
    batch = {"tokens": torch.from_numpy(np.load(f"{OUT}/prefill.npy"))}
    dp, m = mesh.shape["data"], mesh.shape["model"]
    variants = {"default": {"fsdp_params": False},
                "ep": {"fsdp_params": False, "ep_experts": True}}
    if dp > 1:
        variants["ep-zero3"] = {"ep_experts": True}
    out = {}
    T.set_moe_dispatch_groups(2)
    for name, v in variants.items():
        step, args, shardings = D.build_step(
            cfg, InputShape("p", PS, PB, "prefill"), v, mesh=mesh)
        ps = shardings(mesh)[0]
        p = SH.shard_tree(params, ps, copy=True)
        mesh.nbytes.clear()
        with torch.no_grad():
            lg, met = step(p, batch)
        out[name] = dict(record(lg, met), nbytes=dict(mesh.nbytes),
                         resident=nbytes(p),
                         reckoned=SH.shard_nbytes(args[0], ps),
                         shapes=shapes(p) == shapes(SH.shard_tree(args[0],
                                                                  ps)),
                         specs=specs(ps, p))
        if name == "ep" and control:
            with Rolled(), torch.no_grad():
                out["control"] = step(p, batch)[0].numpy().copy()
    layers = len(out["default"]["expert_load"])
    out["logits_bytes"] = PB // dp * cfg.padded_vocab * 4
    out["expert_bytes"] = expert_bytes(cfg, PB // dp * PS, 2 // dp, layers)
    return out


def decode(mesh, cfg, params, layout):
    tokens = torch.from_numpy(np.load(f"{OUT}/decode.npy"))
    fsdp = mesh.shape["data"] > 1
    v = {"fsdp_params": fsdp, "ep_experts": True, **LAYOUTS[layout]}
    step, args, shardings = D.build_step(
        cfg, InputShape("d", SLOTS, B, "decode"), v, mesh=mesh)
    ps, _, cs, _ = shardings(mesh)
    p = SH.shard_tree(params, ps, copy=True)
    held = SH.shard_tree(T.init_cache(cfg, params, B, SLOTS), cs, copy=True)
    rec = {"resident": (nbytes(p), nbytes(held)),
           "reckoned": (SH.shard_nbytes(args[0], ps),
                        SH.shard_nbytes(args[2], cs)),
           "shapes": shapes(p) == shapes(SH.shard_tree(args[0], ps)),
           "specs": specs(ps, p)}
    mesh.nbytes.clear()
    steps = []
    with torch.no_grad():
        for i in range(STEPS):
            lg, held = step(p, {"tokens": tokens[:, i:i + 1]}, held,
                            torch.full((B,), START + i, dtype=torch.int32))
            steps.append(record(lg, step.metrics))
    rec.update(steps=steps, nbytes=dict(mesh.nbytes),
               cache={k: t.numpy().copy() for k, t in leaves_of(held).items()},
               cache_specs={k: tuple(s.spec)
                            for k, s in leaves_of(cs).items()})
    return rec


def train(mesh, cfg, params):
    data = np.load(f"{OUT}/train.npz")
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
    out = {}
    T.set_moe_dispatch_groups(2)
    for name, fsdp in (("zero2", False), ("zero3", True)):
        step, args, shardings = D.build_step(
            cfg, InputShape("t", PS, PB, "train"),
            {"microbatches": 1, "remat": "none", "fsdp_params": fsdp,
             "ep_experts": True}, mesh=mesh)
        ps, os_, _ = shardings(mesh)
        p = SH.shard_tree(params, ps, copy=True)
        opt = O.adamw(LR)
        # ZeRO-2 keeps its moments in the accumulator's layout (the
        # dry-run's), ZeRO-3 in the parameters'
        state = opt.init(p if fsdp else SH.shard_tree(params, os_["mu"]))
        want = shapes(SH.shard_tree(args[0], ps))
        before = shapes(p) == want
        # the accumulator's layout: ZeRO-2's the moments', ZeRO-3's the
        # parameters'
        acc_specs = specs(ps if fsdp else os_["mu"], p)
        mesh.nbytes.clear()
        met, g = step.grads(p, batch)
        acc = arrays(g)
        p, state = step.apply(p, g, state)
        out[name] = dict(
            metrics={k: v.numpy().tolist() for k, v in met.items()},
            params=arrays(p), specs=specs(ps, p), acc=acc,
            acc_specs=acc_specs,
            step_specs=specs(step.param_shardings, p),
            shapes=(before, shapes(p) == want),
            moments=shapes(state["mu"]) == shapes(state["nu"]),
            resident=(nbytes(p), nbytes(state["mu"]) + nbytes(state["nu"])
                      + nbytes(state["step"])),
            reckoned=(SH.shard_nbytes(args[0], ps),
                      SH.shard_nbytes(args[1], os_)),
            nbytes=dict(mesh.nbytes),
            batch_bytes=step.stats.get("batch_bytes", 0))
    return out


def moe_layer(mesh, cfg, params):
    """The MoE sublayer alone, forward and backward: one process's on
    the whole bank against this rank's on its experts, from the same
    input and output gradient."""
    p = T._period(params["layers"][0], 0)["moe"]
    ps = SH.params_shardings(params, mesh, fsdp=False, ep_experts=True)
    mine = T._period(SH.shard_tree(params, ps, copy=True)["layers"][0],
                     0)["moe"]["experts"]
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((4, 8, cfg.d_model), generator=gen)
    dy = torch.randn((4, 8, cfg.d_model), generator=gen)

    def run(bank, **kw):
        live = {"router": {"w_gate": p["router"]["w_gate"].clone()
                           .requires_grad_()},
                "experts": {k: v.clone().requires_grad_()
                            for k, v in bank.items()}}
        xl = x.clone().requires_grad_()
        y, met = MOE.dispatch_moe(
            live, xl, top_k=cfg.moe.top_k, num_experts=cfg.moe.num_experts,
            capacity_factor=cfg.moe.capacity_factor, act=cfg.act,
            groups=1, impl="ref", **kw)
        y.backward(dy)
        return {"y": y.detach().numpy().copy(),
                "dx": xl.grad.numpy().copy(),
                "router": live["router"]["w_gate"].grad.numpy().copy(),
                "experts": {k: v.grad.numpy().copy()
                            for k, v in live["experts"].items()},
                "load": met["expert_load"].numpy().copy()}
    n = mine["w_down"].shape[0]
    lo = mesh.index("model") * n
    return {"one": run(p["experts"]),
            "ep": run(mine, model_mesh=mesh),
            "rows": (lo, lo + n)}


def operators(mesh):
    """gather_experts and move_split against their definitions."""
    m, r = mesh.shape["model"], mesh.index("model")
    whole = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    mine = whole.chunk(m, 0)[r].clone().requires_grad_()
    y = TP.gather_experts(mine, mesh)
    g = torch.arange(whole.numel(), dtype=torch.float32).reshape(whole.shape)
    y.backward(g)
    moved = TP.move_split(mine.detach(), mesh, 0, 2, tag="grads")
    back = TP.move_split(moved, mesh, 2, 0, tag="params")
    return {"y": y.detach().numpy().copy(), "grad": mine.grad.numpy().copy(),
            "want_grad": g.chunk(m, 0)[r].numpy().copy(),
            "moved": moved.numpy().copy(),
            "want_moved": whole.chunk(m, 2)[r].numpy().copy(),
            "back": back.numpy().copy(),
            "want_back": whole.chunk(m, 0)[r].numpy().copy(),
            "nbytes": dict(mesh.nbytes)}


def world(rank, shape):
    torch.set_num_threads(1)
    mesh = make_process_mesh(*shape, device="cpu")
    out = {"coords": mesh.coords}
    try:
        for arch in ARCHS:
            cfg, params = setup(arch)
            out[arch] = {
                "prefill": prefill(mesh, cfg, params, arch == MIXTRAL),
                "train": train(mesh, cfg, params),
                "decode": {lay: decode(mesh, cfg, params, lay)
                           for a, m, lay in DECODES
                           if a == arch and tuple(m) == shape}}
            if arch == MIXTRAL:
                out["moe"] = moe_layer(mesh, cfg, params)
                mesh.nbytes.clear()
                out["operators"] = operators(mesh)
    finally:
        T.set_moe_dispatch_groups(1)
    return out


if __name__ == "__main__":
    t0 = time.perf_counter()
    res = {shape: spawn_local(world, shape[0] * shape[1], backend="gloo",
                              args=(shape,), wall_s=300.0)
           for shape in ((1, 2), (2, 2))}
    res["seconds"] = time.perf_counter() - t0
    with open(f"{OUT}/port.pkl", "wb") as fh:
        pickle.dump(res, fh)
'''


def _jsmoke(arch):
    return jget_config(arch, smoke=True).with_(dtype="float32", impl="ref")


def _tsmoke(arch):
    return get_config(arch, smoke=True).with_(dtype="float32", impl="ref")


def _cache_leaves(cache) -> dict:
    out = {}
    for j, c in enumerate(cache):
        (mixer, sub), = c.items()
        for path, t in T._leaf_paths(sub):
            out["/".join(map(str, (j, mixer) + path))] = t.numpy().copy()
    return out


def _record(logits, m):
    return {"logits": np.asarray(logits).copy(),
            **{k: np.asarray(m[k]).copy() for k in ("expert_load", "dropped")
               if k in m}}


def _port_one_process(params, arch, prefill_tokens, decode_tokens, batch):
    """The port's one-process steps: the prefill and the train step at
    dispatch groups 2, the decode steps at groups 1 and 2."""
    cfg = _tsmoke(arch)
    out = {}
    try:
        T.set_moe_dispatch_groups(2)
        with torch.no_grad():
            out["prefill"] = _record(*M.make_prefill_step(cfg)(
                params, {"tokens": torch.from_numpy(prefill_tokens)}))
        opt = O.adamw(LR)
        step = M.make_train_step(cfg, opt, remat="none")
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        m, g = step.grads(params, b)
        p, _ = step.apply(params, g, opt.init(params))
        out["train"] = {"metrics": {k: v.numpy().tolist()
                                    for k, v in m.items()},
                        "grads": [t.numpy().copy() for t in O._leaves(g)],
                        "params": [t.numpy().copy() for t in O._leaves(p)]}
        for groups in (1, 2):
            T.set_moe_dispatch_groups(groups)
            step = M.make_serve_step(cfg)
            cache = T.init_cache(cfg, params, B, SLOTS)
            steps = []
            with torch.no_grad():
                for i in range(STEPS):
                    lg, cache = step(
                        params,
                        {"tokens": torch.from_numpy(decode_tokens[:, i:i + 1])},
                        cache, torch.full((B,), START + i, dtype=torch.int32))
                    steps.append(_record(lg, step.metrics))
            out["decode", groups] = {"steps": steps,
                                     "cache": _cache_leaves(cache)}
    finally:
        T.set_moe_dispatch_groups(1)
    return out


def _reference(weights, arch, prefill_tokens, decode_tokens, batch):
    """The reference's one-process steps, as ``_port_one_process``."""
    cfg = _jsmoke(arch)
    out = {}
    try:
        JT.set_moe_dispatch_groups(2)
        out["prefill"] = _record(*jax.jit(JM.make_prefill_step(cfg))(
            weights, {"tokens": prefill_tokens}))
        opt = JO.adamw(LR)
        p, _, m = jax.jit(JM.make_train_step(cfg, opt))(
            weights, opt.init(weights), batch)
        out["train"] = {"metrics": {k: np.asarray(v) for k, v in m.items()},
                        "params": _flatten(jax.tree.map(np.asarray, p))}
        for groups in (1, 2):
            JT.set_moe_dispatch_groups(groups)
            step = jax.jit(partial(JT.decode_step, cfg))
            cache = JT.init_cache(cfg, weights, B, SLOTS)
            steps = []
            for i in range(STEPS):
                lg, cache, m = step(weights,
                                    {"tokens": decode_tokens[:, i:i + 1]},
                                    cache, jnp.full((B,), START + i,
                                                    jnp.int32))
                steps.append(_record(lg, m))
            out["decode", groups] = steps
    finally:
        JT.set_moe_dispatch_groups(1)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ep_experts")
    init = jax.jit(JM.init_params, static_argnums=0)
    weights, params = {}, {}
    for arch in ARCHS:
        weights[arch] = init(_jsmoke(arch), jax.random.PRNGKey(3))
        flat = jax.tree.map(np.asarray, weights[arch])
        np.savez(out / f"w-{arch}.npz", **_flatten(flat))
        params[arch] = from_jax(flat)
    rng = np.random.default_rng(32)
    prefill_tokens = rng.integers(0, 512, (PB, PS), dtype=np.int32)
    decode_tokens = rng.integers(0, 512, (B, STEPS), dtype=np.int32)
    batch = {k: rng.integers(0, 512, (PB, PS), dtype=np.int32)
             for k in ("tokens", "labels")}
    np.save(out / "prefill.npy", prefill_tokens)
    np.save(out / "decode.npy", decode_tokens)
    np.savez(out / "train.npz", **batch)
    (out / "port.py").write_text(PORT_SCRIPT)
    proc = subprocess.Popen(
        [sys.executable, str(out / "port.py"), str(out), json.dumps(ARCHS),
         json.dumps([LAYOUTS, DECODES]),
         json.dumps([PB, PS, B, SLOTS, START, STEPS]),
         str(LR)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    one, ref = {}, {}
    try:
        for arch in ARCHS:
            one[arch] = _port_one_process(params[arch], arch, prefill_tokens,
                                          decode_tokens, batch)
            ref[arch] = _reference(weights[arch], arch, prefill_tokens,
                                   decode_tokens, batch)
    finally:
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
    return {"one": one, "ref": ref, "port": port}


def _logical(shape):
    return LogicalMesh(OrderedDict(zip(("data", "model"), shape)),
                       ("data", "model"))


def _assemble(ranks, get, specs, shape):
    """Every leaf, assembled from all ranks' shards (``get(rank)``: the
    rank's list of leaves) under `specs`."""
    mesh = _logical(shape)
    return [SH.assemble([torch.from_numpy(get(r)[i]) for r in ranks],
                        SH.NamedSharding(mesh, SH.P(*spec))).numpy()
            for i, spec in enumerate(specs)]


def _same_record(got, want) -> bool:
    return set(got) >= set(want) and all(
        np.array_equal(got[k], want[k]) for k in want)


def _near(got, want, metrics=True):
    np.testing.assert_allclose(got["logits"], want["logits"], atol=FWD_TOL,
                               rtol=FWD_TOL)
    np.testing.assert_array_equal(got["logits"].argmax(-1),
                                  want["logits"].argmax(-1))
    if metrics:
        for k in ("expert_load", "dropped"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[_cell(*c) for c in CELLS])
def test_prefill_matches_one_process_and_reference(runs, arch, shape):
    """The prefill on the E-split layout (fsdp=False; ZeRO-3 too on
    (2, 2)) on every rank: the port's one-process logits and metrics bit
    for bit (the prediction), the reference's within 1e-4 with greedy
    tokens, loads and drops exactly."""
    one, ref = runs["one"][arch]["prefill"], runs["ref"][arch]["prefill"]
    for r in runs["port"][shape]:
        for name in ("ep", "ep-zero3"):
            if name not in r[arch]["prefill"]:
                continue
            got = r[arch]["prefill"][name]
            assert _same_record(got, one), name
            _near(got, ref)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[_cell(*c) for c in CELLS])
def test_prefill_gathers_no_expert_leaf(runs, arch, shape):
    """Through ``ProcessMesh.nbytes``: the E-split prefill gathers over
    "model" exactly the bytes the default layout gathers (the weights
    gathered at use and the logits' columns; the default layout's banks
    are column/row pairs, never gathered), so no expert leaf; its expert
    outputs' gather moves E x rows x D floats a MoE layer; the ZeRO-3
    layout gathers its banks over data only."""
    for r in runs["port"][shape]:
        pre = r[arch]["prefill"]
        base = pre["default"]["nbytes"]["all_gather/model"]
        assert "all_gather/model/experts" not in pre["default"]["nbytes"]
        for name in ("ep", "ep-zero3"):
            if name not in pre:
                continue
            nb = pre[name]["nbytes"]
            assert nb["all_gather/model"] == base, (name, nb)
            assert nb["all_gather/model/experts"] == pre["expert_bytes"], nb
        if "ep-zero3" in pre:
            assert "all_gather/data/params" in pre["ep-zero3"]["nbytes"]


@pytest.mark.parametrize("arch,shape", CELLS, ids=[_cell(*c) for c in CELLS])
def test_rank_layout_is_the_dry_runs(runs, arch, shape):
    """Each rank's parameter shards are ``params_shardings(ep_experts=
    True)``'s (the banks split on E) in every step, before and after the
    train step, their bytes and the optimizer's and the cache's the
    dry-run's reckoning; the ZeRO-2 step's moments keep the accumulator's
    layout (the reference's: F over "model")."""
    for r in runs["port"][shape]:
        pre = r[arch]["prefill"]
        for name in ("ep", "ep-zero3"):
            if name in pre:
                assert pre[name]["shapes"]
                assert pre[name]["resident"] == pre[name]["reckoned"]
        for d in r[arch]["decode"].values():
            assert d["shapes"] and d["resident"] == d["reckoned"]
        for name, t in r[arch]["train"].items():
            assert t["shapes"] == (True, True), name
            assert t["moments"] and t["resident"] == t["reckoned"], name
            assert t["step_specs"] == t["specs"], name
        banks = [s for s in pre["ep"]["specs"] if len(s) == 4
                 and s[1] == "model"]
        assert banks, pre["ep"]["specs"]


@pytest.mark.parametrize("arch,shape,layout", DECODES,
                         ids=[f"{_cell(a, m)}-{lay}" for a, m, lay in DECODES])
def test_decode_matches_one_process_and_reference(runs, arch, shape, layout):
    """Four decode steps under the cache layout (fsdp=False on (1, 2),
    ZeRO-3 on (2, 2)) on every rank. Against the port's one-process step
    at dispatch groups = data: bit for bit where the layout splits
    neither a sequence nor the rows (every expert computed whole, only
    concatenated). Else logits within 1e-4, tokens, loads and drops
    exactly, the assembled cache within 1e-4 (positions exactly), and
    the operation that rounds otherwise is not the experts': a sequence
    split merges the ranks' attention by their softmax statistics
    (``merge_softmax``); rows split over data give each rank its own
    dispatch group, and at top-1 (llama4) its expert products run on
    C = 1 row an expert where one process's two groups run C = 2, and the
    CPU's ``bmm`` sums one row in another order (one process on rows 0-1
    alone differs from its four-row step alike). Against the reference's
    ``decode_step`` the same tolerances."""
    dp = shape[0]
    one = runs["one"][arch]["decode", dp]
    ref = runs["ref"][arch]["decode", dp]
    ranks = runs["port"][shape]
    # whether the layout split a sequence (its attention merged by the
    # ranks' softmax statistics)
    d0 = ranks[0][arch]["decode"][layout]
    merges = any(k.endswith("/softmax") for k in d0["nbytes"])
    rows = any("data" in (e if isinstance(e, (tuple, list)) else (e,))
               for e in next(iter(d0["cache_specs"].values()))[1:2] if e)
    exact = not merges and not rows
    for r in ranks:
        got = r[arch]["decode"][layout]["steps"]
        assert len(got) == len(one["steps"]) == STEPS
        for g, w, f in zip(got, one["steps"], ref):
            if exact:
                assert _same_record(g, w)
            else:
                _near(g, w)
            _near(g, f)
    mesh = _logical(shape)
    for k, want in one["cache"].items():
        got = SH.assemble([torch.from_numpy(r[arch]["decode"][layout]
                                            ["cache"][k]) for r in ranks],
                          SH.NamedSharding(mesh, SH.P(*d0["cache_specs"][k])))
        got = got.numpy()
        if not exact and not k.endswith("pos"):
            np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[_cell(*c) for c in CELLS])
def test_decode_gathers_no_expert_leaf(runs, arch, shape):
    """Each decode step gathers over "model" the weights the default
    layout's prefill gathers at use (its all_gather/model bytes less its
    logits' columns), and no more: no expert leaf; the expert outputs'
    gather ran."""
    for r in runs["port"][shape]:
        pre = r[arch]["prefill"]
        weights = pre["default"]["nbytes"]["all_gather/model"] \
            - pre["logits_bytes"]
        for layout, d in r[arch]["decode"].items():
            nb = d["nbytes"]
            assert nb["all_gather/model"] == STEPS * weights, (layout, nb)
            assert nb["all_gather/model/experts"] > 0


@pytest.mark.parametrize("arch,shape", CELLS, ids=[_cell(*c) for c in CELLS])
@pytest.mark.parametrize("zero", ["zero2", "zero3"])
def test_train_step_matches_one_process_and_reference(runs, arch, shape,
                                                      zero):
    """One train step on the E-split layout, ZeRO-2 (the accumulator and
    moments F-split, the banks moved between the splits by all-to-all)
    and ZeRO-3. Loss and aux loss within 1e-5 of the port's one-process
    step and the reference's, loads and drops exactly; the parameters
    after the step, assembled from every rank's shards, within atol
    5e-4, rtol 1e-4 of both. Not bit for bit with one process: at model
    2 the cross entropy sums the exponentials of each rank's vocabulary
    columns over the group (``vocab_cross_entropy``), so the gradients
    round otherwise from the head down (the default layout's step alike;
    ``test_moe_sublayer_is_bit_for_bit`` holds the MoE itself)."""
    one = runs["one"][arch]["train"]
    ref = runs["ref"][arch]["train"]
    ranks = runs["port"][shape]
    for r in ranks:
        t = r[arch]["train"][zero]
        for w in (one["metrics"], ref["metrics"]):
            for k in ("loss", "aux_loss"):
                np.testing.assert_allclose(t["metrics"][k], w[k],
                                           atol=LOSS_TOL, rtol=LOSS_TOL,
                                           err_msg=k)
            for k in ("expert_load", "dropped"):
                np.testing.assert_array_equal(np.asarray(t["metrics"][k]),
                                              np.asarray(w[k]), err_msg=k)
    got = _assemble(ranks, lambda r: r[arch]["train"][zero]["params"],
                    ranks[0][arch]["train"][zero]["specs"], shape)
    assert len(got) == len(one["params"]) == len(ref["params"])
    for g, w, (k, f) in zip(got, one["params"], ref["params"].items()):
        np.testing.assert_allclose(g, w, atol=STEP_ATOL, rtol=STEP_RTOL,
                                   err_msg=k)
        np.testing.assert_allclose(g, f, atol=STEP_ATOL, rtol=STEP_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[_cell(*c) for c in CELLS])
@pytest.mark.parametrize("zero", ["zero2", "zero3"])
def test_train_step_collectives(runs, arch, shape, zero):
    """The train step gathers over "model" the weights at use (the
    default prefill's less its logits) and its rows (the batch's
    sequence split over "model"), and no expert leaf; ZeRO-2 at data or
    model > 1 moves the banks' gradient and parameters by all-to-all
    over "model" by name, ZeRO-3 gathers its banks over data only."""
    for r in runs["port"][shape]:
        pre, t = r[arch]["prefill"], r[arch]["train"][zero]
        nb = t["nbytes"]
        weights = pre["default"]["nbytes"]["all_gather/model"] \
            - pre["logits_bytes"]
        assert nb["all_gather/model"] == weights + shape[1] \
            * t["batch_bytes"], nb
        assert nb["all_gather/model/experts"] > 0
        moved = {"all_to_all/model/grads", "all_to_all/model/params"}
        if zero == "zero2":
            assert moved <= set(nb), nb
        else:
            assert not moved & set(nb), nb
        if zero == "zero3" and shape[0] > 1:
            assert "all_gather/data/params" in nb


@pytest.mark.parametrize("arch,shape", CELLS, ids=[_cell(*c) for c in CELLS])
@pytest.mark.parametrize("zero", ["zero2", "zero3"])
def test_train_accumulator_matches_one_process_gradients(runs, arch, shape,
                                                         zero):
    """The step's float32 accumulator, assembled from every rank's shard
    in its layout (ZeRO-2's F-split, ZeRO-3's E-split), against the
    port's one-process gradients within atol = rtol = 1e-5
    (``tests/test_torch_zero3.py``'s): an expert's gradient landing on
    another expert's rows, summed twice over the model group or left
    partial would be far outside it (one step's parameters at 5e-4 could
    not see it: AdamW's first step moves each weight by at most 2 lr)."""
    want = runs["one"][arch]["train"]["grads"]
    ranks = runs["port"][shape]
    got = _assemble(ranks, lambda r: r[arch]["train"][zero]["acc"],
                    ranks[0][arch]["train"][zero]["acc_specs"], shape)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ACC_TOL, rtol=ACC_TOL)


def test_moe_sublayer_is_bit_for_bit(runs):
    """mixtral's first MoE sublayer from the same input and output
    gradient, on each rank's experts against one process on the whole
    bank: output, input and router gradients, loads, bit for bit; each
    rank's expert gradients are the one-process gradients' rows of its
    experts, bit for bit."""
    for shape in MESHES:
        for r in runs["port"][shape]:
            one, ep, (lo, hi) = r["moe"]["one"], r["moe"]["ep"], \
                r["moe"]["rows"]
            for k in ("y", "dx", "router", "load"):
                assert np.array_equal(ep[k], one[k]), k
            for k, g in ep["experts"].items():
                assert np.array_equal(g, one["experts"][k][lo:hi]), k


def test_rolled_expert_outputs_fail(runs):
    """The control: mixtral's prefill with the expert outputs gathered
    in rolled order (each expert's rows land on another expert's) leaves
    the one-process logits by more than 1e-2 on every rank of both
    meshes."""
    want = runs["one"][MIXTRAL]["prefill"]["logits"]
    for shape in MESHES:
        for r in runs["port"][shape]:
            bad = r[MIXTRAL]["prefill"]["control"]
            assert np.abs(bad - want).max() > CONTROL_MOVE


def test_operators_against_their_definitions(runs):
    """``gather_experts``: the model group's (2, 6, 8) blocks of a
    (4, 6, 8) tensor in rank order, its gradient this rank's block of
    the output's; ``move_split``: the E-split block re-cut to the
    F-split block of the same whole, and back; each metered by name."""
    for shape in MESHES:
        for r in runs["port"][shape]:
            o = r["operators"]
            np.testing.assert_array_equal(
                o["y"], np.arange(4 * 6 * 8, dtype=np.float32)
                .reshape(4, 6, 8))
            for k in ("grad", "moved", "back"):
                np.testing.assert_array_equal(o[k], o[f"want_{k}"])
            assert {"all_gather/model/experts", "all_to_all/model/grads",
                    "all_to_all/model/params"} <= set(o["nbytes"])


# ------------------------------------------------------------ in process


def _mesh(shape, rank=0):
    return ProcessMesh(shape=OrderedDict(data=shape[0], model=shape[1]),
                       rank=rank, coords=(rank // shape[1], rank % shape[1]),
                       device=torch.device("cpu"))


def test_split_experts_and_its_refusal():
    """``split_experts``: true where every leaf of a bank is split on E
    (one period's dim 0), false for a column/row pair or a whole bank; a
    bank split on E in part of its leaves raises."""
    bank = dict.fromkeys(("w_gate", "w_up", "w_down"))
    assert TP.split_experts(bank, dict.fromkeys(bank, 0))
    assert not TP.split_experts(bank, {"w_gate": 2, "w_up": 2, "w_down": 1})
    assert not TP.split_experts(bank, dict.fromkeys(bank))
    with pytest.raises(ValueError, match="expert dim"):
        TP.split_experts(bank, {"w_gate": 0, "w_up": 0, "w_down": 1})


def test_train_step_layouts_with_ep_experts():
    """``make_train_step``: ZeRO-2 takes E-split parameters beside the
    reference's F-split accumulator (its step's parameter layout the
    E-split one); ZeRO-3 takes its accumulator in the parameters'
    layout only; a leaf split over "model" in one tree and whole in the
    other raises."""
    cfg = _tsmoke(MIXTRAL)
    params = M.abstract_params(cfg)
    m22 = _mesh((2, 2))
    ep2 = SH.params_shardings(params, m22, fsdp=False, ep_experts=True)
    acc = SH.params_shardings(params, m22, fsdp=True)
    step = M.make_train_step(cfg, O.adamw(LR), param_shardings=ep2,
                             grad_shardings=acc)
    assert [s.spec for s in O._leaves(step.param_shardings)] == \
        [s.spec for s in O._leaves(ep2)]
    ep3 = SH.params_shardings(params, m22, fsdp=True, ep_experts=True)
    with pytest.raises(ValueError, match="differently"):
        M.make_train_step(cfg, O.adamw(LR), param_shardings=ep3,
                          grad_shardings=acc)
    whole = SH.tree_map(lambda s: SH.NamedSharding(m22, SH.P(*[
        None if e == "model" else e for e in s.spec])), acc)
    with pytest.raises(ValueError, match="differently"):
        M.make_train_step(cfg, O.adamw(LR), param_shardings=ep2,
                          grad_shardings=whole)


def test_int8_banks_at_model_2_point_to_parked_work():
    """An int8 bank at model > 1 still raises; the message sends the
    reader to ROADMAP parked (c)4, where that work waits."""
    cfg = _tsmoke(MIXTRAL)
    p = {"router": {"w_gate": torch.zeros(cfg.d_model, 4)},
         "experts": {"w_up_scale": torch.zeros(4, cfg.d_model)}}
    with pytest.raises(NotImplementedError, match=r"parked \(c\)4"):
        MOE.dispatch_moe(p, torch.zeros(1, 2, cfg.d_model), top_k=2,
                         num_experts=4, capacity_factor=1.25,
                         model_mesh=_mesh((1, 2)))
    src = (ROOT / "src" / "repro_torch").rglob("*.py")
    assert not [q for q in src if "queued work (ROADMAP " in q.read_text()]
