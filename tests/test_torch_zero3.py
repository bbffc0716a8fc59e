"""PyTorch port, the ZeRO-3 layout (``params_shardings(fsdp=True)``):
``models.model.make_train_step(param_shardings=)``, ``make_prefill_step``
and ``make_serve_step`` on (2, 1) and (2, 2) ("data", "model") ``launch.
mesh.ProcessMesh``es of gloo ranks on the CPU, each data-split leaf
gathered over the data group at use and its gradient reduce-scattered
back. Float32 smoke configs, ``impl="ref"``, the reference's weights
(``params.from_jax``), two steps of 8 x 16 tokens, AdamW at lr 1e-4 with
weight decay 0.01.

Against the reference's one-process steps at ``set_moe_dispatch_groups(
data)``, at ``tests/test_torch_tp.py``'s tolerances: loss and aux loss
atol = rtol = 1e-5; parameters after two updates atol = 5e-4, rtol =
1e-4; the float32 accumulator, assembled from every rank's shard,
atol = rtol = 1e-5; logits atol = rtol = 1e-4; greedy tokens, expert
loads and drops exactly; every ``pos`` of a decode cache exactly, its k
and v at 1e-4.

Against the port's own steps on the same mesh, bit for bit: the ZeRO-3
step against the ZeRO-2 step (``grad_shardings=``) from the same
weights: each step's loss, the step-1 accumulator and the parameters
after two steps (at data 2 the reduce-scatter sums two floats, in
either order the same); the ZeRO-3 prefill and decode steps against the
``fsdp=False`` ones (a gathered leaf is the replicated shard, so the
arithmetic is the same).

Cases: mixtral on (2, 1) and (2, 2) at one and two microbatches, remat
"none" and "full"; a clip of 0.05 on (2, 2); qwen3-32b (a dense FFN) and
command-r+ (tied embeddings) on (2, 2); mixtral with ``ep_experts`` on
(2, 2) (its banks split on E, gathered over data at use, each model rank
running its own whole experts, none gathered over model); the (2, 2)
prefill; ``forward`` of all twelve smoke configs on (2, 2), each rank on
its rows; the decode step on (2, 2) under the three cache layouts of the
reference's dry-run; the dry-run's ``build_step`` on a rank, whose
default-variant steps run the layout its shardings give. Layouts: each
rank's shard shapes equal ``params_shardings(fsdp=True)``'s before and
after the steps, μ and ν alike, resident parameter and optimizer bytes
equal the dry-run's reckoning; ``gather_from_data`` against its
definition, the float32 sum of bf16 gradients included. The ranks run in
a subprocess that spawns them (``launch.mesh.spawn_local``: a file
rendezvous, collectives bounded at 60 s, each spawn killed after 300 s),
so this process forks nothing. The refusals run in process. About 90 s
on one worker.
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
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import LogicalMesh, ProcessMesh
from repro_torch.models import model as M
from repro_torch.training import optimizer as O

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 660
LOSS_TOL, ACC_TOL, FWD_TOL = 1e-5, 1e-5, 1e-4
STEP_ATOL, STEP_RTOL = 5e-4, 1e-4
LR, CLIP_SMALL, STEPS = 1e-4, 0.05, 2
MIXTRAL, QWEN3, CMDR = "mixtral-8x7b", "qwen3-32b", "command-r-plus-104b"
# name: (arch, (data, model), microbatches, remat, clip norm, ep_experts)
CASES = {
    **{f"mixtral-{d}x{m}-mb{mb}-{remat}": (MIXTRAL, (d, m), mb, remat, 1.0,
                                           False)
       for d, m in ((2, 1), (2, 2)) for mb in (1, 2)
       for remat in ("none", "full")},
    "mixtral-2x2-clip": (MIXTRAL, (2, 2), 2, "full", CLIP_SMALL, False),
    "qwen3-2x2": (QWEN3, (2, 2), 1, "full", 1.0, False),
    "command-r-2x2": (CMDR, (2, 2), 2, "full", 1.0, False),
    "mixtral-2x2-ep": (MIXTRAL, (2, 2), 2, "full", 1.0, True),
}
# the decode cases on (2, 2): ``cache_shardings`` keywords; B rows,
# slots, a prefill then per-row decode steps
LAYOUTS = {"default": {}, "seq_over_dp": {"seq_over_dp": True},
           "cache_heads_model": {"heads_model": True}}
DEC_B, DEC_SLOTS, DEC_PREFILL, DEC_STEPS = 4, 64, 30, 6


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
import json, pickle, sys, time
import numpy as np
import torch
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import InputShape
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_process_mesh, spawn_local
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.params import from_jax
from repro_torch.training import optimizer as O
from repro_torch.training.optimizer import _leaves

OUT = sys.argv[1]
CASES = json.loads(sys.argv[2])
LAYOUTS = json.loads(sys.argv[3])
LR, STEPS = float(sys.argv[4]), int(sys.argv[5])
DEC_B, DEC_SLOTS, DEC_PREFILL, DEC_STEPS = json.loads(sys.argv[6])


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


def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def arrays(tree):
    return [t.detach().numpy().copy() for t in _leaves(tree)]


def run_steps(step, p, state, with_acc):
    """STEPS steps, step 1 in its two halves (its accumulator kept)."""
    out = {"metrics": []}
    for i, b in enumerate(batches()):
        if i == 0:
            m, g = step.grads(p, b)
            if with_acc:
                out["acc"] = arrays(g)
            p, state = step.apply(p, g, state)
        else:
            p, state, m = step(p, state, b)
        out["metrics"].append({k: v.numpy().tolist() for k, v in m.items()})
    return out, p, state


def train_case(mesh, arch, mb, remat, clip, epx):
    cfg, params = setup(arch)
    ps = SH.params_shardings(params, mesh, fsdp=True, ep_experts=epx)
    opt = O.adamw(LR, weight_decay=0.01, clip_norm=clip)
    step = M.make_train_step(cfg, opt, microbatches=mb, remat=remat,
                             param_shardings=ps)
    p = SH.shard_tree(params, ps, copy=True)
    state = opt.init(p)
    before = shapes(p) == shapes(SH.shard_tree(params, ps))
    mesh.host_ms.clear()
    z3, p, state = run_steps(step, p, state, True)
    collectives = sorted(mesh.host_ms)
    want = shapes(SH.shard_tree(params, ps))
    # the dry-run's reckoning of this step on this mesh
    _, args, shardings = D.build_step(
        cfg, InputShape("z3", 16, 8, "train"),
        {"microbatches": mb, "ep_experts": epx}, mesh=mesh)
    sh = shardings(mesh)
    # ZeRO-2 on the same mesh from the same weights, its parameters cut
    # to this rank's data blocks
    gs = SH.params_shardings(params, mesh, fsdp=True, ep_experts=epx)
    z2_step = M.make_train_step(cfg, opt, microbatches=mb, remat=remat,
                                grad_shardings=gs)
    z2, q, _ = run_steps(z2_step, SH.shard_tree(
        params, z2_step.param_shardings, copy=True),
        opt.init(SH.shard_tree(params, gs)), True)
    q = SH.shard_tree(q, SH.without_axes(gs, ("model",)))
    return dict(
        metrics=z3["metrics"], acc=z3["acc"], params=arrays(p),
        specs=[tuple(s.spec) for s in _leaves(step.param_shardings)],
        acc_specs=[tuple(s.spec) for s in _leaves(ps)],
        shapes_before=before, shapes_after=shapes(p) == want,
        moments=shapes(state["mu"]) == shapes(state["nu"]) == want,
        resident=(nbytes(p), nbytes(state["mu"]) + nbytes(state["nu"])
                  + nbytes(state["step"])),
        reckoned=(SH.shard_nbytes(args[0], sh[0]),
                  SH.shard_nbytes(args[1], sh[1])),
        collectives=collectives,
        z2=dict(metrics=z2["metrics"], acc=z2["acc"], params=arrays(q)))


def local_rows(mesh, batch):
    dp, r = mesh.shape["data"], mesh.index("data")
    b = next(iter(batch.values())).shape[0]
    return {k: v.narrow(0, r * (b // dp), b // dp) for k, v in batch.items()}


def forwards(mesh):
    out = {}
    data = np.load(f"{OUT}/forward.npz")
    for arch in list_archs():
        cfg, params = setup(arch)
        batch = {k.split("/", 1)[1]: torch.from_numpy(v)
                 for k, v in data.items() if k.startswith(arch + "/")}
        ps = SH.params_shardings(params, mesh, fsdp=True)
        with torch.no_grad():
            logits, m = T.forward(cfg, SH.shard_tree(params, ps, copy=True),
                                  local_rows(mesh, batch), data_mesh=mesh,
                                  param_shardings=ps)
            if logits.shape[-1] != cfg.padded_vocab:
                logits = TP.gather_over(logits, mesh, 2, "model")
            logits = TP.gather_over(logits, mesh, 0, "data")
        out[arch] = dict(logits=logits.numpy().copy(),
                         metrics={k: v.numpy().tolist()
                                  for k, v in m.items()})
    return out


def prefill(mesh):
    cfg, params = setup("mixtral-8x7b")
    batch = {"tokens": torch.from_numpy(np.load(f"{OUT}/prefill.npy"))}
    out = {}
    for fsdp in (True, False):
        ps = SH.params_shardings(params, mesh, fsdp=fsdp)
        step = M.make_prefill_step(cfg, param_shardings=ps)
        mesh.host_ms.clear()
        with torch.no_grad():
            logits, m = step(SH.shard_tree(params, ps, copy=True), batch)
        out[fsdp] = dict(logits=logits.numpy().copy(),
                         metrics={k: v.numpy().tolist()
                                  for k, v in m.items()},
                         collectives=sorted(mesh.host_ms))
    # the dry-run's default-variant prefill step on this rank's shards
    step, _, shardings = D.build_step(
        cfg, InputShape("p", batch["tokens"].shape[1],
                        batch["tokens"].shape[0], "prefill"), mesh=mesh)
    with torch.no_grad():
        logits, _ = step(SH.shard_tree(params, shardings(mesh)[0],
                                       copy=True), batch)
    out["dry_run"] = logits.numpy().copy()
    return out


def decode_plan():
    data = np.load(f"{OUT}/decode.npz")
    yield {"tokens": torch.from_numpy(data["prompt"])}, 0
    for i in range(DEC_STEPS):
        yield ({"tokens": torch.from_numpy(data["steps"][:, i:i + 1])},
               torch.from_numpy(data["lens"] + i))


def decode(mesh, layout, fsdp=True, step=None):
    cfg, params = setup("mixtral-8x7b")
    cache = T.init_cache(cfg, params, DEC_B, DEC_SLOTS)
    cs = SH.cache_shardings(cache, mesh, **layout)
    ps = SH.params_shardings(params, mesh, fsdp=fsdp)
    if step is None:
        step = M.make_serve_step(cfg, param_shardings=ps, cache_shardings=cs)
    p, held = SH.shard_tree(params, ps, copy=True), \
        SH.shard_tree(cache, cs, copy=True)
    steps = []
    with torch.no_grad():
        for batch, cl in decode_plan():
            logits, held = step(p, batch, held, cl)
            steps.append({"logits": logits.numpy().copy(),
                          **{k: step.metrics[k].numpy().copy()
                             for k in ("expert_load", "dropped")}})
    return {"steps": steps,
            "cache": [{k: t.numpy().copy() for k, t in c["attn"].items()}
                      for c in held],
            "specs": [{k: tuple(s.spec) for k, s in c["attn"].items()}
                      for c in cs],
            "param_bytes": nbytes(p)}


def dry_run_train(mesh):
    """The dry-run's default-variant train step on this rank's shards of
    its own layout: step 1's loss."""
    cfg, params = setup("mixtral-8x7b")
    step, _, shardings = D.build_step(
        cfg, InputShape("t", 16, 8, "train"), {"microbatches": 2},
        mesh=mesh)
    p = SH.shard_tree(params, shardings(mesh)[0], copy=True)
    _, _, m = step(p, O.adamw(1e-4).init(p), batches()[0])
    return float(m["loss"]), [tuple(s.spec)
                              for s in _leaves(step.param_shardings)], \
        [tuple(s.spec) for s in _leaves(shardings(mesh)[0])]


def operators(mesh):
    """gather_from_data on dim 1 of a (3, 2) shard: forward, backward
    without a sink (the sum returned, in the leaf's dtype) and with one
    (the float32 sum added into it); bf16 gradients whose float32 sum a
    bf16 rounding would lose."""
    r = mesh.index("data")
    out = {"rank": r}
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.arange(6.).reshape(3, 2) + 10 * r).to(dtype)
        g = (torch.arange(1., 5.).expand(3, 4)
             * (1.0 if r == 0 else 2.0 ** -9)).to(dtype)
        live = x.clone().requires_grad_()
        y = TP.gather_from_data(live, mesh, 1)
        y.backward(g)
        sink = torch.full((3, 2), 0.5)
        live2 = x.clone().requires_grad_()
        y2 = TP.gather_from_data(live2, mesh, 1, sink)
        got = torch.autograd.grad(y2, live2, g, allow_unused=True)[0]
        out[str(dtype)] = dict(y=y.detach().float().numpy().copy(),
                               grad=live.grad.float().numpy().copy(),
                               grad_dtype=str(live.grad.dtype),
                               sink=sink.numpy().copy(),
                               sunk_grad_none=got is None)
    out["collectives"] = sorted(mesh.host_ms)
    return out


def world(rank, shape):
    torch.set_num_threads(1)
    mesh = make_process_mesh(*shape, device="cpu")
    out = {"coords": mesh.coords}
    T.set_moe_dispatch_groups(shape[0])
    try:
        for name, (arch, mshape, mb, remat, clip, epx) in CASES.items():
            if tuple(mshape) == shape:
                out[name] = train_case(mesh, arch, mb, remat, clip, epx)
        if shape == (2, 1):
            out["operators"] = operators(mesh)
        else:
            out["forward"] = forwards(mesh)
            out["prefill"] = prefill(mesh)
            out["dry_run_train"] = dry_run_train(mesh)
            for name, layout in LAYOUTS.items():
                out[f"decode-{name}"] = {fsdp: decode(mesh, layout, fsdp)
                                         for fsdp in (True, False)}
            cfg, _ = setup("mixtral-8x7b")
            step, _, _ = D.build_step(
                cfg, InputShape("d", DEC_SLOTS, DEC_B, "decode"), mesh=mesh)
            out["decode-dry-run"] = decode(mesh, {}, step=step)
    finally:
        T.set_moe_dispatch_groups(1)
    return out


if __name__ == "__main__":
    t0 = time.perf_counter()
    res = {}
    for shape in ((2, 1), (2, 2)):
        res[shape] = spawn_local(world, shape[0] * shape[1], backend="gloo",
                                 args=(shape,), wall_s=300.0)
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


def _reference_decode(weights, prompt, steps, lens):
    """The reference's one-process decode steps at dispatch groups 2:
    each step's logits and metrics, and the final cache."""
    cfg = _jsmoke(MIXTRAL)
    step = jax.jit(partial(JT.decode_step, cfg))
    cache = JT.init_cache(cfg, weights, DEC_B, DEC_SLOTS)
    plan = [(prompt, jnp.asarray(0, jnp.int32))] + [
        (steps[:, i:i + 1], jnp.asarray(lens + i)) for i in range(DEC_STEPS)]
    out = []
    for tokens, cl in plan:
        logits, cache, m = step(weights, {"tokens": jnp.asarray(tokens)},
                                cache, cl)
        out.append({"logits": np.asarray(logits),
                    **{k: np.asarray(m[k]) for k in
                       ("expert_load", "dropped")}})
    return {"steps": out, "cache": [{k: np.asarray(v) for k, v in
                                     c["attn"].items()} for c in cache]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero3")
    init = jax.jit(JM.init_params, static_argnums=0)
    weights = {}
    for arch in list_archs():
        weights[arch] = init(_jsmoke(arch), jax.random.PRNGKey(1))
        np.savez(out / f"w-{arch}.npz",
                 **_flatten(jax.tree.map(np.asarray, weights[arch])))
    rng = np.random.default_rng(5)
    batches = [{k: rng.integers(0, 512, (8, 16), dtype=np.int32)
                for k in ("tokens", "labels")} for _ in range(STEPS)]
    np.savez(out / "batches.npz", **{f"{k}{i}": b[k] for i, b in
                                     enumerate(batches) for k in b})
    fwd = {arch: _forward_batch(_jsmoke(arch), rng) for arch in list_archs()}
    np.savez(out / "forward.npz", **{f"{a}/{k}": v for a, b in fwd.items()
                                     for k, v in b.items()})
    prefill_tokens = rng.integers(0, 512, (8, 16), dtype=np.int32)
    np.save(out / "prefill.npy", prefill_tokens)
    dec = {"prompt": rng.integers(0, 512, (DEC_B, DEC_PREFILL),
                                  dtype=np.int32),
           "steps": rng.integers(0, 512, (DEC_B, DEC_STEPS), dtype=np.int32),
           "lens": np.full(DEC_B, DEC_PREFILL, np.int32)}
    np.savez(out / "decode.npz", **dec)
    (out / "port.py").write_text(PORT_SCRIPT)
    proc = subprocess.Popen(
        [sys.executable, str(out / "port.py"), str(out), json.dumps(CASES),
         json.dumps(LAYOUTS), str(LR), str(STEPS),
         json.dumps([DEC_B, DEC_SLOTS, DEC_PREFILL, DEC_STEPS])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    ref, done = {}, {}
    try:
        for name, (arch, (dp, _), mb, _, clip, _) in CASES.items():
            if (arch, dp, mb, clip) in done:   # remat and layout change
                ref[name] = ref[done[arch, dp, mb, clip]]   # nothing
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
                             params=_flatten(jax.tree.map(np.asarray, p)))
        JT.set_moe_dispatch_groups(2)
        lg, m = jax.jit(JM.make_prefill_step(_jsmoke(MIXTRAL)))(
            weights[MIXTRAL], {"tokens": prefill_tokens})
        ref["prefill"] = dict(logits=np.asarray(lg), metrics={
            k: np.asarray(v) for k, v in m.items()})
        ref["forward"] = {}
        for arch in list_archs():
            lg, m = JT.forward(_jsmoke(arch), weights[arch],
                               {k: jnp.asarray(v)
                                for k, v in fwd[arch].items()})
            ref["forward"][arch] = dict(logits=np.asarray(lg), metrics={
                k: np.asarray(v) for k, v in m.items()})
        ref["decode"] = _reference_decode(weights[MIXTRAL], dec["prompt"],
                                          dec["steps"], dec["lens"])
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


def _assembled(ranks, name, key, specs_key, shape, sub=None):
    """Every leaf of rank results `key` (under `sub` where given),
    assembled from all ranks' shards under the specs `specs_key`."""
    mesh = _logical(shape)
    r0 = ranks[0][name]

    def part(r, i):
        got = r[name] if sub is None else r[name][sub]
        return torch.from_numpy(got[key][i])
    return [SH.assemble([part(r, i) for r in ranks],
                        SH.NamedSharding(mesh, SH.P(*spec))).numpy()
            for i, spec in enumerate(r0[specs_key])]


def _ranks(runs, case):
    return runs["port"][CASES[case][1]]


@pytest.mark.parametrize("case", list(CASES))
def test_zero3_step_matches_reference_step(runs, case):
    """Loss, aux loss, loads and drops of both steps on every rank; the
    parameters after two steps, assembled from every rank's (data,
    model) shard."""
    shape = CASES[case][1]
    ref, ranks = runs["ref"][case], _ranks(runs, case)
    for r in ranks:
        for want, got in zip(ref["metrics"], r[case]["metrics"]):
            for k in ("loss", "aux_loss"):
                np.testing.assert_allclose(got[k], want[k], atol=LOSS_TOL,
                                           rtol=LOSS_TOL, err_msg=k)
            for k in ("expert_load", "dropped"):
                if k in want:
                    np.testing.assert_array_equal(np.asarray(got[k]),
                                                  want[k], err_msg=k)
    got = _assembled(ranks, case, "params", "specs", shape)
    assert len(got) == len(ref["params"])
    for (k, want), g in zip(ref["params"].items(), got):
        np.testing.assert_allclose(g, want, atol=STEP_ATOL, rtol=STEP_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_zero3_accumulator_equals_reference_gradients(runs, case):
    """Step 1's float32 accumulator shards, assembled over data and
    model, against the reference's gradients: a data-split leaf's
    gradient summed twice (a scatter in the backward and again after it)
    would show here as a factor of 2, one left unsummed as a half."""
    shape = CASES[case][1]
    ref, ranks = runs["ref"][case], _ranks(runs, case)
    got = _assembled(ranks, case, "acc", "acc_specs", shape)
    assert len(got) == len(ref["grads"])
    for (k, want), g in zip(ref["grads"].items(), got):
        np.testing.assert_allclose(g, want, atol=ACC_TOL, rtol=ACC_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_zero3_equals_zero2_bit_for_bit(runs, case):
    """On the same mesh from the same weights, the ZeRO-3 step against
    the ZeRO-2 step: every step's metrics, the step-1 accumulator shards
    and this rank's data blocks of the parameters after two steps, bit
    for bit. At data 2 each reduce-scatter sums two floats, which gives
    one result in either order."""
    for r in _ranks(runs, case):
        c = r[case]
        assert c["metrics"] == c["z2"]["metrics"]
        assert len(c["acc"]) == len(c["z2"]["acc"])
        for a, b in zip(c["acc"], c["z2"]["acc"]):
            assert np.array_equal(a, b)
        for a, b in zip(c["params"], c["z2"]["params"]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_zero3_rank_layout_is_the_dry_runs(runs, case):
    """Each rank holds its (data, model) shards of ``params_shardings(
    fsdp=True)`` before and after the steps (μ and ν alike): no leaf is
    gathered back whole; its resident parameter and optimizer bytes
    equal the dry-run's reckoning of the same step on the same mesh; the
    step took the data group's gathers and scatters by their names."""
    for r in _ranks(runs, case):
        c = r[case]
        assert c["shapes_before"] and c["shapes_after"] and c["moments"]
        assert c["resident"] == c["reckoned"]
        assert {"all_gather/data/params", "reduce_scatter/data/grads"} <= \
            set(c["collectives"]), c["collectives"]
        assert "reduce_scatter/data" not in c["collectives"]
        assert any("data" in (e if isinstance(e, tuple) else (e,))
                   for spec in c["specs"] for e in spec if e)


def test_clip_is_global_under_zero3(runs):
    """At clip 0.05 the ZeRO-3 step matches the reference, whose
    gradient norm is far above the clip: the norm is summed over both
    axes of the shards."""
    g = runs["ref"]["mixtral-2x2-clip"]["grads"]
    total = sum(float(np.sum(v.astype(np.float64) ** 2)) for v in g.values())
    assert total > CLIP_SMALL ** 2 * 100
    for r in _ranks(runs, "mixtral-2x2-clip"):
        local = sum(float(np.sum(a.astype(np.float64) ** 2))
                    for a in r["mixtral-2x2-clip"]["acc"])
        assert local < 0.9 * total


@pytest.mark.parametrize("arch", list_archs())
def test_zero3_forward_matches_reference_forward(runs, arch):
    """``forward`` on this rank's (data, model) shards of the (2, 2)
    layout and its rows, the logits gathered over both axes, against
    the reference's ``forward`` at dispatch groups 2."""
    ref = runs["ref"]["forward"][arch]
    for r in runs["port"][(2, 2)]:
        got = r["forward"][arch]
        assert got["logits"].shape == ref["logits"].shape
        np.testing.assert_allclose(got["logits"], ref["logits"],
                                   atol=FWD_TOL, rtol=FWD_TOL)
        for k in ("expert_load", "dropped"):
            if k in ref["metrics"]:
                np.testing.assert_array_equal(np.asarray(got["metrics"][k]),
                                              ref["metrics"][k], err_msg=k)


def test_zero3_prefill_matches_reference_and_fsdp_false(runs):
    """The (2, 2) prefill on the ZeRO-3 layout: the reference's logits
    within 1e-4, its greedy tokens and loads exactly; the ``fsdp=False``
    prefill's logits and metrics bit for bit; the data gathers only on
    the ZeRO-3 layout; the dry-run's default-variant prefill on its own
    layout gives the same logits."""
    ref = runs["ref"]["prefill"]
    for r in runs["port"][(2, 2)]:
        z3, z2 = r["prefill"][True], r["prefill"][False]
        np.testing.assert_allclose(z3["logits"], ref["logits"],
                                   atol=FWD_TOL, rtol=FWD_TOL)
        assert np.array_equal(z3["logits"].argmax(-1),
                              ref["logits"].argmax(-1))
        for k in ("expert_load", "dropped"):
            np.testing.assert_array_equal(np.asarray(z3["metrics"][k]),
                                          ref["metrics"][k], err_msg=k)
        assert np.array_equal(z3["logits"], z2["logits"])
        assert z3["metrics"] == z2["metrics"]
        assert np.array_equal(r["prefill"]["dry_run"], z3["logits"])
        assert "all_gather/data/params" in z3["collectives"]
        assert "all_gather/data/params" not in z2["collectives"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_zero3_decode_matches_reference_and_fsdp_false(runs, layout):
    """The (2, 2) decode step under each cache layout on the ZeRO-3
    layout: a 30-token prefill then six per-row steps, every step's
    logits within 1e-4 of the reference's one-process ``decode_step``,
    greedy tokens, loads and drops exactly, the cache assembled from the
    ranks' shards (positions exactly, k and v at 1e-4); against the
    ``fsdp=False`` serve step on the same mesh, logits, metrics and
    cache shards bit for bit; the parameter bytes a rank about half of
    those of the ``fsdp=False`` layout (the norms, whose one dim
    "model" splits, stay whole over data)."""
    want = runs["ref"]["decode"]
    ranks = [r[f"decode-{layout}"] for r in runs["port"][(2, 2)]]
    for r in ranks:
        z3, z2 = r[True], r[False]
        assert len(z3["steps"]) == len(want["steps"])
        for i, (got, w) in enumerate(zip(z3["steps"], want["steps"])):
            np.testing.assert_allclose(got["logits"], w["logits"],
                                       atol=FWD_TOL, rtol=FWD_TOL,
                                       err_msg=f"step {i}")
            np.testing.assert_array_equal(got["logits"].argmax(-1),
                                          w["logits"].argmax(-1))
            for k in ("expert_load", "dropped"):
                np.testing.assert_array_equal(got[k], w[k],
                                              err_msg=f"{k} step {i}")
        for a, b in zip(z3["steps"], z2["steps"]):
            assert all(np.array_equal(a[k], b[k]) for k in a)
        for a, b in zip(z3["cache"], z2["cache"]):
            assert all(np.array_equal(a[k], b[k]) for k in a)
        assert z3["param_bytes"] < 0.55 * z2["param_bytes"]
    mesh = _logical((2, 2))
    for j, w in enumerate(want["cache"]):
        for k in ("k", "v", "pos"):
            got = SH.assemble(
                [torch.from_numpy(r[True]["cache"][j][k]) for r in ranks],
                SH.NamedSharding(mesh, SH.P(*ranks[0][True]["specs"][j][k])))
            if k == "pos":
                np.testing.assert_array_equal(got.numpy(), w[k])
            else:
                np.testing.assert_allclose(got.numpy(), w[k], atol=FWD_TOL,
                                           rtol=FWD_TOL)


def test_dry_run_steps_run_their_layout(runs):
    """``launch.dryrun.build_step`` on a rank of the (2, 2) mesh, default
    variant (``fsdp_params`` on): the train step is the ZeRO-3 step on
    the layout its shardings return (its step-1 loss on those shards is
    the ZeRO-3 case's, bit for bit), and so are the prefill (above) and
    the decode step (its logits and cache the ZeRO-3 decode's)."""
    for r in runs["port"][(2, 2)]:
        loss, step_specs, dry_specs = r["dry_run_train"]
        assert step_specs == dry_specs
        assert loss == r["mixtral-2x2-mb2-full"]["metrics"][0]["loss"]
        got, want = r["decode-dry-run"], r["decode-default"][True]
        for a, b in zip(got["steps"], want["steps"]):
            assert all(np.array_equal(a[k], b[k]) for k in a)
        for a, b in zip(got["cache"], want["cache"]):
            assert all(np.array_equal(a[k], b[k]) for k in a)


def test_gather_from_data_against_its_definition(runs):
    """Forward: the two data ranks' (3, 2) shards concatenated on dim 1
    in rank order. Backward without a sink: the gradient summed over the
    group, this rank's two columns, in the leaf's dtype. With a sink:
    the float32 sum added into it and no gradient for the leaf; in bf16
    the sums c (1 + 2^-9) of two bf16 gradients, which a bf16 rounding
    takes to c, land in the sink exactly."""
    ops = [r["operators"] for r in runs["port"][(2, 1)]]
    for o in ops:
        r = o["rank"]
        col = slice(2 * r, 2 * r + 2)
        for dtype in ("torch.float32", "torch.bfloat16"):
            got = o[dtype]
            np.testing.assert_array_equal(got["y"], np.concatenate(
                [np.arange(6.).reshape(3, 2) + 10 * q for q in (0, 1)], 1))
            total = np.tile(np.arange(1., 5.) * (1.0 + 2.0 ** -9), (3, 1))
            np.testing.assert_array_equal(got["sink"],
                                          0.5 + total[:, col])
            assert got["sunk_grad_none"]
            assert got["grad_dtype"] == dtype
            rounded = total[:, col] if dtype == "torch.float32" else \
                torch.from_numpy(total[:, col]).to(torch.bfloat16) \
                .float().numpy()
            np.testing.assert_array_equal(got["grad"], rounded)
        assert not np.array_equal(
            ops[0]["torch.bfloat16"]["grad"],
            ops[0]["torch.bfloat16"]["sink"] - 0.5)
        assert {"all_gather/data/params", "reduce_scatter/data/grads"} <= \
            set(o["collectives"])


# ------------------------------------------------------------ in process


def _meshes(shape):
    """One ``ProcessMesh`` for each rank of `shape`, no process group
    (layouts and refusals only)."""
    n = shape[0] * shape[1]
    return [ProcessMesh(shape=OrderedDict(data=shape[0], model=shape[1]),
                        rank=r, coords=(r // shape[1], r % shape[1]),
                        device=torch.device("cpu")) for r in range(n)]


def test_train_step_layouts_and_refusals():
    """``make_train_step(param_shardings=)``: with data axes its
    parameter layout keeps them (ZeRO-3); given with a ``grad_shardings``
    of another data layout it raises; without data axes it is the ZeRO-2
    step's layout; no ``NotImplementedError`` naming ZeRO-3 is left in
    the port's step builders."""
    cfg = get_config(MIXTRAL, smoke=True).with_(dtype="float32")
    params = M.abstract_params(cfg)
    m22 = _meshes((2, 2))[0]
    z3 = SH.params_shardings(params, m22, fsdp=True)
    step = M.make_train_step(cfg, O.adamw(LR), param_shardings=z3)
    assert [s.spec for s in O._leaves(step.param_shardings)] == \
        [s.spec for s in O._leaves(z3)]
    other = SH.tree_map(lambda s: SH.NamedSharding(m22, SH.P(*[
        e if e != "data" else None for e in s.spec])), z3)
    with pytest.raises(ValueError, match="differently"):
        M.make_train_step(cfg, O.adamw(LR), param_shardings=z3,
                          grad_shardings=other)
    z2 = SH.params_shardings(params, m22, fsdp=False)
    step = M.make_train_step(cfg, O.adamw(LR), param_shardings=z2,
                             grad_shardings=z3)
    assert [s.spec for s in O._leaves(step.param_shardings)] == \
        [s.spec for s in O._leaves(z2)]
    src = (ROOT / "src" / "repro_torch").rglob("*.py")
    assert not [p for p in src if "ZeRO-3) is queued" in p.read_text()]
