"""PyTorch port, the sharded decode step of recurrent and encoder-decoder
caches: ``models.model.make_serve_step(param_shardings=, cache_shardings=)``
for jamba-v0.1-52b (Mamba state and an attention cache, experts),
xlstm-125m (mLSTM and sLSTM state) and whisper-base (a self-attention
cache, cross-attention over the encoder output) on (1, 2) and (2, 2)
("data", "model") ``launch.mesh.ProcessMesh``es of gloo ranks on the CPU.
Float32 smoke configs, ``impl="ref"``, the reference's weights
(``params.from_jax``), the tokens of every step drawn from a numpy seed
(the same in both packages).

Each case runs one plan of steps, B = 4 rows, a 16-slot cache:
  * "prefill": 6 prompt tokens into the empty cache (an int length), two
    steps at a 0-d length, then three at per-row lengths with row 1
    inactive for two of them (its length stays, its token still runs:
    the recurrent state of every row advances, in both packages alike);
    whisper-base takes one length for the batch, so an int there, and
    its prompt step takes the frame embeddings (``enc_embeds``), the
    later steps the encoder output its rank computed (``enc_out``);
  * "tokens" (jamba-v0.1-52b): one token a step from the empty cache, at
    an int, then 0-d, then per-row lengths with an inactive row, ten
    steps, the attention's writes crossing from rank 0's slots into
    rank 1's.

Oracles. Every case against the port's one-process ``decode_step`` on
the same plan at ``set_moe_dispatch_groups(data)``. Against the
reference: xlstm-125m and whisper-base have no experts, so the
reference's ``forward`` over all the plan's tokens is exact, each step's
logits its logits at that position; jamba-v0.1-52b's "tokens" plan
against the reference's ``decode_step`` at ``set_moe_dispatch_groups(
data)`` (one token a step, where its mixer steps read their whole input).
The reference's ``decode_step`` is no oracle for whisper or for a
multi-token step into a recurrent cache (the reference's faults there,
ROADMAP queue 3), so jamba's "prefill" plan is held to the port's
one-process step alone, which ``tests/test_torch_hybrid.py`` holds to
the reference.

Tolerances: logits atol = rtol = 1e-4 (``tests/test_torch_tp_decode.py``:
float32 through two layers, sums in another order); greedy tokens,
expert loads, drops and every ``pos`` entry exactly; each state and
cache leaf assembled from the ranks' shards (``sharding.assemble``) at
atol = rtol = 1e-4 against one process. Each rank's resident parameter
and cache bytes and shapes equal the dry-run's ``build_step`` decode
shardings on the same mesh and variant. The control: a rank that writes
back the other model rank's slice of one split leaf (``Swapped``) must
leave one process's logits by more than 1e-2.

Cases: the three configs on (1, 2) under the default, ``seq_over_dp`` and
``cache_heads_model`` layouts (``fsdp=False``; at data 1 ZeRO-3 is the
same layout) and on (2, 2) under each layout with ``fsdp=False`` and
ZeRO-3 (``fsdp=True``) parameters. The ranks run in a subprocess that
spawns them (``launch.mesh.spawn_local``: a file rendezvous, collectives
bounded at 60 s, each spawn killed after 300 s), so this process forks
nothing. In process: where each layout puts every state leaf. About a
minute on one worker.
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
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import LogicalMesh, ProcessMesh
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.params import from_jax

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
FWD_TOL, CONTROL_MOVE = 1e-4, 1e-2
JAMBA, XLSTM, WHISPER = "jamba-v0.1-52b", "xlstm-125m", "whisper-base"
ARCHS = (JAMBA, XLSTM, WHISPER)
B, SLOTS, ENC_SEED = 4, 16, 11
LAYOUTS = {"default": {}, "seq-over-dp": {"seq_over_dp": True},
           "heads-model": {"heads_model": True}}


def _cases():
    """name: (arch, (data, model), layout, fsdp, plan); jamba's plans
    alternate over its cases, so each mesh and parameter layout runs
    both."""
    out, n = {}, 0
    for arch in ARCHS:
        for mesh, fsdps in (((1, 2), (False,)), ((2, 2), (False, True))):
            for fsdp in fsdps:
                for layout in LAYOUTS:
                    plan = "prefill"
                    if arch == JAMBA:
                        plan = ("tokens", "prefill")[n % 2]
                        n += 1
                    tag = "-zero3" if fsdp else ""
                    out[f"{arch}-{mesh[0]}x{mesh[1]}-{layout}{tag}"] = (
                        arch, mesh, layout, fsdp, plan)
    return out


CASES = _cases()
# the control's cases: a split state leaf (Mamba's d_inner, mLSTM's last
# dim over "model"), and whisper's K/V split on hd
CONTROLS = [f"{JAMBA}-1x2-default", f"{XLSTM}-1x2-default",
            f"{WHISPER}-1x2-heads-model"]
# how a step passes its cache length: an int, a 0-d tensor, a (B,) one
INT, SCALAR, ROWS = 0, 1, 2


def _plan(arch, kind):
    """[(tokens (B, S_new), cache length kind, lengths (B,), active (B,)
    or None)], from a seed."""
    rng = np.random.default_rng(len(kind) * 100 + len(arch))
    lens = np.zeros(B, np.int32)
    out = []

    def step(s, how, active=None):
        out.append((rng.integers(0, 512, (B, s)).astype(np.int32), how,
                    lens.copy(), active))
        lens[:] += s if active is None else s * active
    rows = INT if arch == WHISPER else ROWS
    if kind == "prefill":
        step(6, INT)
        for _ in range(2):
            step(1, SCALAR)
        for i in range(3):
            step(1, rows, np.arange(B) != 1 if rows == ROWS and i < 2
                 else None)
    else:
        step(1, INT)
        for _ in range(3):
            step(1, SCALAR)
        for i in range(6):
            step(1, ROWS, np.arange(B) != 1 if i in (2, 3) else None)
    return out


def _enc_embeds(cfg):
    rng = np.random.default_rng(ENC_SEED)
    return rng.standard_normal(
        (B, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32)


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


def _cache_leaves(cache) -> dict:
    """{(position, mixer, key...): leaf} of a cache tree."""
    out = {}
    for j, c in enumerate(cache):
        (mixer, sub), = c.items()
        for path, t in T._leaf_paths(sub):
            out[(j, mixer) + path] = t
    return out


PORT_SCRIPT = r'''
import json, pickle, sys, time
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_process_mesh, spawn_local
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.params import from_jax
from repro_torch.training.optimizer import _leaves

OUT = sys.argv[1]
CASES = json.loads(sys.argv[2])
CONTROLS = json.loads(sys.argv[3])
B, SLOTS = json.loads(sys.argv[4])
LAYOUTS = {"default": {}, "seq-over-dp": {"seq_over_dp": True},
           "heads-model": {"heads_model": True}}
INT, SCALAR = 0, 1


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


def steps(arch, plan, enc_embeds, enc_out):
    data = np.load(f"{OUT}/plan-{arch}-{plan}.npz")
    for i in range(int(data["n"])):
        how, lens = int(data[f"how{i}"]), data[f"lens{i}"]
        cl = int(lens[0]) if how == INT else torch.tensor(
            int(lens[0]), dtype=torch.int32) if how == SCALAR else \
            torch.from_numpy(lens)
        batch = {"tokens": torch.from_numpy(data[f"tokens{i}"])}
        if f"active{i}" in data:
            batch["active"] = torch.from_numpy(data[f"active{i}"])
        if enc_embeds is not None:
            batch.update({"enc_embeds": enc_embeds} if i == 0
                         else {"enc_out": enc_out})
        yield batch, cl


def shapes(tree):
    out = {}
    SH.tree_map_with_path(
        lambda path, t: out.__setitem__(path, tuple(t.shape)), tree)
    return out


def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


class Swapped:
    """The control: the first record with a split leaf writes back the
    other model rank's slice of it (its (lo, hi) moved by one slice,
    mod the whole dim); the gathers are untouched."""

    def __enter__(self):
        self.inner = inner = T._cache_shards

        def swap(splits):
            (dim, axes, lo, hi), *rest = splits
            w = hi - lo
            lo = (lo + w) % (w * 2)
            return ((dim, axes, lo, lo + w), *rest)

        def swapped(cache, cs, mesh):
            shards, moe = inner(cache, cs, mesh)
            for j, s in enumerate(shards):
                if isinstance(s, L.CacheShard) and s.gather_kv:
                    shards[j] = L.CacheShard(
                        s.mesh, s.smax, s.seq, s.lo, swap(s.gather_kv),
                        s.gather_pos)
                    break
                if isinstance(s, tuple) and s[0].splits:
                    shards[j] = (L.StateShard(s[0].mesh, swap(s[0].splits)),
                                 *s[1:])
                    break
            else:
                raise AssertionError("no split leaf to swap")
            return shards, moe
        T._cache_shards = swapped
        return self

    def __exit__(self, *exc):
        T._cache_shards = self.inner


def leaves_of(cache):
    out = {}
    for j, c in enumerate(cache):
        (mixer, sub), = c.items()
        for path, t in T._leaf_paths(sub):
            out["/".join(map(str, (j, mixer) + path))] = t
    return out


def run_plan(step, p, held, arch, plan, enc_embeds, enc_out):
    out = []
    with torch.no_grad():
        for batch, cl in steps(arch, plan, enc_embeds, enc_out):
            logits, held = step(p, batch, held, cl)
            m = step.metrics
            out.append({"logits": logits.numpy().copy(),
                        **{k: m[k].numpy().copy() for k in
                           ("expert_load", "dropped") if k in m}})
    return out, held


def run_case(mesh, name, arch, layout, fsdp, plan):
    cfg = get_config(arch, smoke=True).with_(dtype="float32", impl="ref")
    params = from_jax(unflatten(dict(np.load(f"{OUT}/w-{arch}.npz"))))
    enc_embeds = enc_out = None
    if cfg.encdec is not None:
        enc_embeds = torch.from_numpy(np.load(f"{OUT}/enc.npz")["enc"])
        with torch.no_grad():
            enc_out = T.run_encoder(cfg, params, enc_embeds)
    cache = T.init_cache(cfg, params, B, SLOTS)
    ps = SH.params_shardings(params, mesh, fsdp=fsdp)
    cs = SH.cache_shardings(cache, mesh, **LAYOUTS[layout])
    step = M.make_serve_step(cfg, param_shardings=ps, cache_shardings=cs)
    p = SH.shard_tree(params, ps, copy=True)
    held = SH.shard_tree(cache, cs, copy=True)
    variant = {"fsdp_params": fsdp,
               "seq_over_dp": layout == "seq-over-dp",
               "cache_heads_model": layout == "heads-model"}
    _, args, shardings = D.build_step(
        cfg, InputShape(name, SLOTS, B, "decode"), variant, mesh=mesh)
    dps, _, dcs, _ = shardings(mesh)
    dry = {"param_shapes": shapes(SH.shard_tree(args[0], dps)) == shapes(p),
           "cache_shapes": shapes(SH.shard_tree(args[2], dcs))
           == shapes(held),
           "param_bytes": (nbytes(p), SH.shard_nbytes(args[0], dps)),
           "cache_bytes": (nbytes(held), SH.shard_nbytes(args[2], dcs))}
    fresh = SH.shard_tree(cache, cs, copy=True) if name in CONTROLS \
        else None
    out, held = run_plan(step, p, held, arch, plan, enc_embeds, enc_out)
    rec = {"steps": out, "dry": dry,
           "cache": {k: t.numpy().copy() for k, t in leaves_of(held).items()},
           "specs": {k: tuple(s.spec) for k, s in leaves_of(cs).items()}}
    if fresh is not None:
        with Swapped():
            rec["control"], _ = run_plan(step, p, fresh, arch, plan,
                                         enc_embeds, enc_out)
    return rec


def world(rank, shape):
    torch.set_num_threads(1)
    mesh = make_process_mesh(*shape, device="cpu")
    return {name: run_case(mesh, name, arch, layout, fsdp, plan)
            for name, (arch, mshape, layout, fsdp, plan) in CASES.items()
            if tuple(mshape) == shape}


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


def _cache_len(how, lens, as_tensor):
    if how == INT:
        return int(lens[0])
    if how == SCALAR:
        return as_tensor(int(lens[0]))
    return as_tensor(lens)


def _one_process(params, arch, plan, dp, enc):
    """The port's one-process decode steps of `plan` at dispatch groups
    `dp`: each step's logits and metrics, and the final cache."""
    cfg = _tsmoke(arch)
    step = M.make_serve_step(cfg)
    cache = T.init_cache(cfg, params, B, SLOTS)
    enc_out = None
    if enc is not None:
        enc = torch.from_numpy(enc)
        with torch.no_grad():
            enc_out = T.run_encoder(cfg, params, enc)
    out = []
    T.set_moe_dispatch_groups(dp)
    try:
        with torch.no_grad():
            for i, (tokens, how, lens, active) in enumerate(plan):
                batch = {"tokens": torch.from_numpy(tokens)}
                if active is not None:
                    batch["active"] = torch.from_numpy(active)
                if enc is not None:
                    batch.update({"enc_embeds": enc} if i == 0
                                 else {"enc_out": enc_out})
                cl = _cache_len(how, lens, lambda v: torch.tensor(
                    v, dtype=torch.int32))
                logits, cache = step(params, batch, cache, cl)
                m = step.metrics
                out.append({"logits": logits.numpy().copy(),
                            **{k: m[k].numpy().copy() for k in
                               ("expert_load", "dropped") if k in m}})
    finally:
        T.set_moe_dispatch_groups(1)
    return {"steps": out, "cache": {k: t.numpy().copy() for k, t in
                                    _cache_leaves(cache).items()}}


def _reference_forward(weights, arch, plan, enc):
    """The reference's ``forward`` over every token of `plan`, cut into
    each step's positions."""
    seq = np.concatenate([t for t, *_ in plan], axis=1)
    batch = {"tokens": jnp.asarray(seq)}
    if enc is not None:
        batch["enc_embeds"] = jnp.asarray(enc)
    logits, _ = JT.forward(_jsmoke(arch), weights, batch)
    logits, out, at = np.asarray(logits), [], 0
    for tokens, *_ in plan:
        out.append({"logits": logits[:, at:at + tokens.shape[1]]})
        at += tokens.shape[1]
    return out


def _reference_decode(weights, arch, plan, dp):
    """The reference's one-process ``decode_step`` one token a step, at
    dispatch groups `dp`."""
    cfg = _jsmoke(arch)
    step = jax.jit(partial(JT.decode_step, cfg))
    cache = JT.init_cache(cfg, weights, B, SLOTS)
    out = []
    JT.set_moe_dispatch_groups(dp)
    try:
        for tokens, how, lens, active in plan:
            assert tokens.shape[1] == 1
            batch = {"tokens": jnp.asarray(tokens)}
            if active is not None:
                batch["active"] = jnp.asarray(active)
            cl = jnp.asarray(lens if how == ROWS else lens[0], jnp.int32)
            logits, cache, m = step(weights, batch, cache, cl)
            out.append({"logits": np.asarray(logits),
                        **{k: np.asarray(m[k]) for k in
                           ("expert_load", "dropped") if k in m}})
    finally:
        JT.set_moe_dispatch_groups(1)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_state")
    init = jax.jit(JM.init_params, static_argnums=0)
    weights, params = {}, {}
    for arch in ARCHS:
        weights[arch] = init(_jsmoke(arch), jax.random.PRNGKey(2))
        flat = _flatten(jax.tree.map(np.asarray, weights[arch]))
        np.savez(out / f"w-{arch}.npz", **flat)
        params[arch] = from_jax(jax.tree.map(np.asarray, weights[arch]))
    enc = _enc_embeds(_tsmoke(WHISPER))
    np.savez(out / "enc.npz", enc=enc)
    plans = {}
    for arch, _, _, _, kind in CASES.values():
        if (arch, kind) in plans:
            continue
        plans[arch, kind] = plan = _plan(arch, kind)
        arrays = {"n": np.asarray(len(plan))}
        for j, (tokens, how, lens, active) in enumerate(plan):
            arrays.update({f"tokens{j}": tokens, f"how{j}": np.asarray(how),
                           f"lens{j}": lens})
            if active is not None:
                arrays[f"active{j}"] = active
        np.savez(out / f"plan-{arch}-{kind}.npz", **arrays)
    (out / "port.py").write_text(PORT_SCRIPT)
    proc = subprocess.Popen(
        [sys.executable, str(out / "port.py"), str(out), json.dumps(CASES),
         json.dumps(CONTROLS), json.dumps([B, SLOTS])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    one, ref = {}, {}
    try:
        for arch, (dp, _), _, _, kind in CASES.values():
            # dispatch groups matter only where there are experts
            groups = dp if arch == JAMBA else 1
            e = enc if arch == WHISPER else None
            if (arch, kind, groups) not in one:
                one[arch, kind, groups] = _one_process(
                    params[arch], arch, plans[arch, kind], groups, e)
            if arch != JAMBA and (arch, kind) not in ref:
                ref[arch, kind] = _reference_forward(
                    weights[arch], arch, plans[arch, kind], e)
            if arch == JAMBA and kind == "tokens" and \
                    (arch, kind, dp) not in ref:
                ref[arch, kind, dp] = _reference_decode(
                    weights[arch], arch, plans[arch, kind], dp)
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


def _ranks(runs, name):
    return [r[name] for r in runs["port"][CASES[name][1]]]


def _one(runs, name):
    arch, (dp, _), _, _, kind = CASES[name]
    return runs["one"][arch, kind, dp if arch == JAMBA else 1]


def _ref(runs, name):
    arch, (dp, _), _, _, kind = CASES[name]
    return runs["ref"][(arch, kind) if arch != JAMBA else (arch, kind, dp)]


def _assert_steps(got_steps, want_steps, metrics=True):
    assert len(got_steps) == len(want_steps)
    for i, (got, w) in enumerate(zip(got_steps, want_steps)):
        assert got["logits"].shape == w["logits"].shape
        np.testing.assert_allclose(got["logits"], w["logits"], atol=FWD_TOL,
                                   rtol=FWD_TOL, err_msg=f"step {i}")
        np.testing.assert_array_equal(got["logits"].argmax(-1),
                                      w["logits"].argmax(-1))
        if metrics:
            assert set(got) == set(w)
            for k in ("expert_load", "dropped"):
                if k in w:
                    np.testing.assert_array_equal(got[k], w[k],
                                                  err_msg=f"{k} step {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_equals_one_process(runs, name):
    """Every step on every rank: the global logits within 1e-4 of the
    port's one-process step on the same plan, greedy tokens, expert
    loads and drops exactly."""
    want = _one(runs, name)["steps"]
    for r in _ranks(runs, name):
        _assert_steps(r["steps"], want)


REF_CASES = [n for n, c in CASES.items() if c[0] != JAMBA or
             c[4] == "tokens"]


@pytest.mark.parametrize("name", REF_CASES)
def test_sharded_step_matches_reference(runs, name):
    """Against the reference: xlstm-125m and whisper-base every step's
    logits within 1e-4 of the reference's ``forward`` at its positions;
    jamba-v0.1-52b one token a step against the reference's
    ``decode_step``, its expert loads and drops exactly."""
    want = _ref(runs, name)
    for r in _ranks(runs, name):
        _assert_steps(r["steps"], want, metrics=CASES[name][0] == JAMBA)


@pytest.mark.parametrize("name", list(CASES))
def test_assembled_state_equals_one_process(runs, name):
    """Every state and cache leaf assembled from the ranks' shards after
    the last step against the one-process cache: every ``pos`` exactly,
    the rest within 1e-4."""
    shape = CASES[name][1]
    mesh = LogicalMesh(OrderedDict(zip(("data", "model"), shape)),
                       ("data", "model"))
    ranks = _ranks(runs, name)
    want = _one(runs, name)["cache"]
    assert sorted("/".join(map(str, k)) for k in want) == \
        sorted(ranks[0]["cache"])
    for key, w in want.items():
        k = "/".join(map(str, key))
        got = SH.assemble([torch.from_numpy(r["cache"][k]) for r in ranks],
                          SH.NamedSharding(mesh, SH.P(*ranks[0]["specs"][k])))
        if key[-1] == "pos":
            np.testing.assert_array_equal(got.numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(got.numpy(), w, atol=FWD_TOL,
                                       rtol=FWD_TOL, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_layout_is_the_dry_runs(runs, name):
    """What each rank holds equals the dry-run's ``build_step`` decode
    shardings at the same variant on the same mesh, in the shape of
    every leaf and in bytes."""
    for r in _ranks(runs, name):
        d = r["dry"]
        assert d["param_shapes"] and d["cache_shapes"]
        assert d["param_bytes"][0] == d["param_bytes"][1]
        assert d["cache_bytes"][0] == d["cache_bytes"][1]


@pytest.mark.parametrize("name", CONTROLS)
def test_swapped_slice_control_fails(runs, name):
    """The control: writing back the other model rank's slice of one
    split leaf moves some later step's logits past 1e-2 of one process,
    where the step itself holds them at 1e-4."""
    want = _one(runs, name)["steps"]
    for r in _ranks(runs, name):
        moved = max(float(np.abs(g["logits"] - w["logits"]).max())
                    for g, w in zip(r["control"], want))
        assert moved > CONTROL_MOVE, moved


# ------------------------------------------------------------ in process

# where each layout puts each state leaf on (2, 2), from the reference's
# rules (distributed/sharding.py: cache_shardings): leaf key -> spec of the
# stacked leaf (period, batch, ...)
SPLITS = {
    "default": {
        (JAMBA, "mamba", "conv"): (None, "data", None, "model"),
        (JAMBA, "mamba", "ssm"): (None, "data", "model", None),
        (XLSTM, "mlstm", 0): (None, "data", None, None, "model"),
        (XLSTM, "mlstm", 1): (None, "data", None, "model"),
        (XLSTM, "mlstm", 2): (None, "data", "model"),
        (XLSTM, "slstm", 0): (None, "data", "model"),
        (XLSTM, "slstm", 2): (None, "data", "model"),
    },
    "seq-over-dp": {
        (JAMBA, "mamba", "conv"): (None, None, None, "model"),
        (JAMBA, "mamba", "ssm"): (None, None, "data", "model"),
        (XLSTM, "mlstm", 0): (None, None, "data", None, "model"),
        (XLSTM, "mlstm", 2): (None, None, "data"),
        (XLSTM, "slstm", 0): (None, None, "data"),
    },
    "heads-model": {
        (JAMBA, "mamba", "conv"): (None, "data", None, "model"),
        (JAMBA, "mamba", "ssm"): (None, "data", None, "model"),
        (XLSTM, "mlstm", 0): (None, "data", None, None, "model"),
        (XLSTM, "mlstm", 2): (None, "data", "model"),
        (XLSTM, "slstm", 3): (None, "data", "model"),
    },
}


def _stand_ins(shape):
    """One ``ProcessMesh`` for each rank of `shape`, no process group
    (layouts only)."""
    n = shape[0] * shape[1]
    return [ProcessMesh(shape=OrderedDict(data=shape[0], model=shape[1]),
                        rank=r, coords=(r // shape[1], r % shape[1]),
                        device=torch.device("cpu")) for r in range(n)]


@pytest.mark.parametrize("layout,key",
                         [(lay, k) for lay, ks in SPLITS.items()
                          for k in ks])
def test_state_leaf_splits_as_the_rules_say(layout, key):
    """The recurrent state leaves of the smoke configs (4 rows) on a
    (2, 2) mesh: the default layout puts "model" on Mamba's d_inner, on
    the last dim of mLSTM's C and n, on H of m and on D of the sLSTM
    leaves; ``seq_over_dp`` the data axes on dim 2 with the rows
    replicated; ``cache_heads_model`` rows over data and the last dim
    over "model". On every rank the step's record of the leaf
    (``transformer._cache_shards``) gathers every split but the rows at
    use, at that rank's slice, and the MoE metrics are summed over data
    exactly where the rows split."""
    arch, mixer, leaf = key
    cfg = _tsmoke(arch)
    cache = T.init_cache(cfg, M.abstract_params(cfg), B, SLOTS)
    want = SPLITS[layout][key]
    for mesh in _stand_ins((2, 2)):
        cs = SH.cache_shardings(cache, mesh, **LAYOUTS[layout])
        held = SH.shard_tree(cache, cs)
        shards, moe_mesh = T._cache_shards(held, cs, mesh)
        assert (moe_mesh is mesh) == (want[1] == "data")
        found = [j for j, c in enumerate(cs) if mixer in c]
        assert found
        for j in found:
            sh = SH.leaf_at(cs[j], (mixer, leaf))
            spec = sh.spec
            assert tuple(spec) == want
            at = [i for i, (path, _) in enumerate(T._leaf_paths(held[j][
                mixer])) if path == (leaf,)][0]
            ranges = SH.shard_ranges(sh, held[j][mixer][leaf].shape)
            assert shards[j][at].splits == tuple(
                (d - 1, *ranges[d]) for d in range(2, len(spec))
                if spec[d] is not None)
            assert shards[j][at].mesh is mesh
