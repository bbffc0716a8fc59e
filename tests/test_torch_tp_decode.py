"""PyTorch port, the sharded decode step: ``models.model.make_serve_step(
param_shardings=, cache_shardings=)`` on (1, 2) and (2, 2) ("data",
"model") ``launch.mesh.ProcessMesh``es of gloo ranks on the CPU, against
the reference's one-process ``decode_step`` at ``set_moe_dispatch_groups(
data)``: float32 smoke configs, ``impl="ref"``, the reference's weights
(``params.from_jax``), a prefill into the cache and then decode steps, the
tokens of every step drawn from a seed (the same in both packages).

Tolerances: logits atol = rtol = 1e-4 (``FWD_TOL`` of
``tests/test_torch_tp.py``: float32 through two layers, sums in another
order, the attention of a sequence split merged from the ranks' partial
softmax sums); greedy tokens, expert loads, drops and every ``pos`` entry
of the cache assembled from the ranks' shards (``sharding.assemble``)
exactly; its k and v atol = rtol = 1e-4 (projections of activations held
to that tolerance). ``merge_softmax`` of split plain decode attentions
against the unsplit call atol = rtol = 1e-5 (float32 softmax over at most
64 lanes, its sums in another order).

Cases on the ranks:
  * mixtral on (1, 2), a 128-slot cache (its sequence over "model": each
    rank attends its 64 slots, the results merged): a prefill, a 0-d
    length, a 58-token write that straddles the ranks, per-row lengths
    that wrap the ring from rank 1's slots into rank 0's;
  * mixtral on (1, 2), a 48-slot cache (hd over "model", pos on its
    sequence: the gather-at-use path), the same plan wrapping the ring;
  * mixtral on (1, 2), per-row lengths at different depths (a row
    inactive for three steps), a window of 24;
  * mixtral on (2, 2) under the default layout (rows over data, sequence
    over model), ``seq_over_dp`` (sequence over data, merged over it; hd
    over model, gathered) and ``cache_heads_model`` (rows over data, hd
    over model; pos on its sequence);
  * every config that ``require_paged_kv`` accepts on (1, 2), a prefill
    and three steps, one crossing from rank 0's slots into rank 1's.
Each rank's parameter and cache shards against the dry-run's
``build_step`` decode shardings on the same mesh, in shape and bytes. The
ranks run in a subprocess that spawns them (``launch.mesh.spawn_local``:
a file rendezvous, collectives bounded at 60 s, each spawn killed after
300 s), so this process forks nothing. In process: recurrent and
encoder-decoder configs build their sharded step (their runs are
``tests/test_torch_sharded_state.py``'s) and the dry-run builds their
decode steps on a rank; ``merge_softmax`` on a
stacked stand-in mesh (``tensor_parallel.StackedShards``), against the
unsplit call and against a plain mean of the splits, which must fail;
``attention(return_stats=True)``.
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
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import decode_attn as DA
from repro_torch.launch.mesh import LogicalMesh, ProcessMesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
FWD_TOL, MERGE_TOL = 1e-4, 1e-5
MIXTRAL = "mixtral-8x7b"
ATTN_ARCHS = [a for a in list_archs() if a not in
              ("jamba-v0.1-52b", "xlstm-125m", "whisper-base")]
# name: arch, (data, model), batch, cache slots, window, cache layout
# (``cache_shardings`` keywords), plan
CASES = {
    "s128": (MIXTRAL, (1, 2), 2, 128, 0, {}, "wrap"),
    "s48": (MIXTRAL, (1, 2), 2, 48, 0, {}, "wrap"),
    "rows-window": (MIXTRAL, (1, 2), 2, 128, 24, {}, "rows"),
    "2x2-default": (MIXTRAL, (2, 2), 4, 128, 0, {}, "wrap"),
    "2x2-seq-over-dp": (MIXTRAL, (2, 2), 4, 128, 0,
                        {"seq_over_dp": True}, "wrap"),
    "2x2-heads-model": (MIXTRAL, (2, 2), 4, 128, 0,
                        {"heads_model": True}, "wrap"),
    **{f"arch-{a}": (a, (1, 2), 2, 128, 0, {}, "short")
       for a in ATTN_ARCHS},
}
# how a step passes its cache length: an int, a 0-d tensor, a (B,) one
INT, SCALAR, ROWS = 0, 1, 2


def _plan(kind, b, smax, seed):
    """[(tokens (B, S_new), cache length kind, lengths (B,), active (B,)
    or None)] of a case, from a seed."""
    rng = np.random.default_rng(seed)

    def toks(s):
        return rng.integers(0, 512, (b, s)).astype(np.int32)
    lens = np.zeros(b, np.int32)
    out = []

    def step(s, how, active=None):
        out.append((toks(s), how, lens.copy(), active))
        lens[:] += s if active is None else s * active
    if kind == "short":      # 62 + 3: the third step writes slot 64
        step(62, INT)
        for _ in range(3):
            step(1, ROWS)
    elif kind == "wrap":     # straddles the halves, then wraps the ring
        step(smax // 2 - 4, INT)
        for _ in range(2):
            step(1, SCALAR)
        step(smax // 2 - 6, INT)
        for _ in range(12):
            step(1, ROWS)
    else:                    # rows at different depths, one inactive
        step(60, INT)
        for i in range(10):
            act = np.ones(b, bool)
            act[1] = not 2 <= i <= 4
            step(1, ROWS, act)
    return out


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
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_process_mesh, spawn_local
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.params import from_jax
from repro_torch.training.optimizer import _leaves

OUT = sys.argv[1]
CASES = json.loads(sys.argv[2])
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


def steps(name):
    data = np.load(f"{OUT}/plan-{name}.npz")
    for i in range(int(data["n"])):
        how, lens = int(data[f"how{i}"]), data[f"lens{i}"]
        cl = int(lens[0]) if how == INT else torch.tensor(
            int(lens[0]), dtype=torch.int32) if how == SCALAR else \
            torch.from_numpy(lens)
        batch = {"tokens": torch.from_numpy(data[f"tokens{i}"])}
        if f"active{i}" in data:
            batch["active"] = torch.from_numpy(data[f"active{i}"])
        yield batch, cl


def shapes(tree):
    out = {}
    SH.tree_map_with_path(
        lambda path, t: out.__setitem__(path, tuple(t.shape)), tree)
    return out


def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def run_case(mesh, name, arch, b, smax, window, layout):
    cfg = get_config(arch, smoke=True).with_(dtype="float32", impl="ref")
    params = from_jax(unflatten(dict(np.load(f"{OUT}/w-{arch}.npz"))))
    cache = T.init_cache(cfg, params, b, smax)
    ps = SH.params_shardings(params, mesh, fsdp=False)
    cs = SH.cache_shardings(cache, mesh, **layout)
    step = M.make_serve_step(cfg, window=window, param_shardings=ps,
                             cache_shardings=cs)
    p, held = SH.shard_tree(params, ps, copy=True), \
        SH.shard_tree(cache, cs, copy=True)
    variant = {"fsdp_params": False,
               "seq_over_dp": layout.get("seq_over_dp", False),
               "cache_heads_model": layout.get("heads_model", False)}
    _, args, shardings = D.build_step(
        cfg, InputShape(name, smax, b, "decode"), variant, mesh=mesh)
    dps, _, dcs, _ = shardings(mesh)
    dry = {"param_shapes": shapes(SH.shard_tree(args[0], dps)) == shapes(p),
           "cache_shapes": shapes(SH.shard_tree(args[2], dcs))
           == shapes(held),
           "param_bytes": (nbytes(p), SH.shard_nbytes(args[0], dps)),
           "cache_bytes": (nbytes(held), SH.shard_nbytes(args[2], dcs))}
    out = []
    mesh.host_ms.clear()
    with torch.no_grad():
        for batch, cl in steps(name):
            logits, held = step(p, batch, held, cl)
            m = step.metrics
            out.append({"logits": logits.numpy().copy(),
                        **{k: m[k].numpy().copy() for k in
                           ("expert_load", "dropped") if k in m}})
    return {"steps": out, "dry": dry, "collectives": sorted(mesh.host_ms),
            "cache": [{k: t.numpy().copy() for k, t in c["attn"].items()}
                      for c in held],
            "specs": [{k: tuple(s.spec) for k, s in c["attn"].items()}
                      for c in cs]}


def world(rank, shape):
    torch.set_num_threads(1)
    mesh = make_process_mesh(*shape, device="cpu")
    return {name: run_case(mesh, name, arch, b, smax, window, layout)
            for name, (arch, mshape, b, smax, window, layout, _)
            in CASES.items() if tuple(mshape) == shape}


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


def _reference(weights, arch, dp, b, smax, window, plan):
    """The reference's one-process decode steps of `plan` at dispatch
    groups `dp`: each step's logits and metrics, and the final cache."""
    cfg = _jsmoke(arch)
    step = jax.jit(partial(JT.decode_step, cfg, window=window))
    cache = JT.init_cache(cfg, weights, b, smax)
    JT.set_moe_dispatch_groups(dp)
    out = []
    try:
        for tokens, how, lens, active in plan:
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
    return {"steps": out, "cache": [{k: np.asarray(v) for k, v in
                                     c["attn"].items()} for c in cache]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_decode")
    init = jax.jit(JM.init_params, static_argnums=0)
    weights = {}
    for arch in sorted({c[0] for c in CASES.values()}):
        weights[arch] = init(_jsmoke(arch), jax.random.PRNGKey(1))
        np.savez(out / f"w-{arch}.npz",
                 **_flatten(jax.tree.map(np.asarray, weights[arch])))
    plans = {}
    for name, (_, _, b, smax, _, _, kind) in CASES.items():
        # one plan for one (kind, batch, slots): twins share an oracle
        plans[name] = _plan(kind, b, smax, seed=len(kind) * 1000 + smax + b)
        arrays = {"n": np.asarray(len(plans[name]))}
        for j, (tokens, how, lens, active) in enumerate(plans[name]):
            arrays.update({f"tokens{j}": tokens, f"how{j}": np.asarray(how),
                           f"lens{j}": lens})
            if active is not None:
                arrays[f"active{j}"] = active
        np.savez(out / f"plan-{name}.npz", **arrays)
    (out / "port.py").write_text(PORT_SCRIPT)
    proc = subprocess.Popen(
        [sys.executable, str(out / "port.py"), str(out), json.dumps(CASES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    ref = {}
    try:
        for name, (arch, (dp, _), b, smax, window, _, _) in CASES.items():
            twin = next((n for n in ref if CASES[n][:5] == CASES[name][:5]
                         and CASES[n][6] == CASES[name][6]), None)
            # the layout changes nothing in one process
            ref[name] = ref[twin] if twin else _reference(
                weights[arch], arch, dp, b, smax, window, plans[name])
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
    return {"ref": ref, "port": port}


def _ranks(runs, name):
    return [r[name] for r in runs["port"][CASES[name][1]]]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_matches_reference_decode(runs, name):
    """Every step on every rank: the global logits (B, S_new, V) within
    1e-4 of the reference's one-process step, the greedy tokens, expert
    loads and drops exactly."""
    want = runs["ref"][name]["steps"]
    for r in _ranks(runs, name):
        assert len(r["steps"]) == len(want)
        for i, (got, w) in enumerate(zip(r["steps"], want)):
            assert got["logits"].shape == w["logits"].shape
            np.testing.assert_allclose(got["logits"], w["logits"],
                                       atol=FWD_TOL, rtol=FWD_TOL,
                                       err_msg=f"step {i}")
            np.testing.assert_array_equal(got["logits"].argmax(-1),
                                          w["logits"].argmax(-1))
            assert set(got) == set(w)
            for k in ("expert_load", "dropped"):
                if k in w:
                    np.testing.assert_array_equal(got[k], w[k],
                                                  err_msg=f"{k} step {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_assembled_cache_equals_reference_cache(runs, name):
    """The cache assembled from every rank's shard after the last step
    (the ring wrapped, writes straddling the ranks) against the
    reference's: every ``pos`` exactly, k and v within 1e-4."""
    shape = CASES[name][1]
    mesh = LogicalMesh(OrderedDict(zip(("data", "model"), shape)),
                       ("data", "model"))
    ranks = _ranks(runs, name)
    for j, want in enumerate(runs["ref"][name]["cache"]):
        for k in ("k", "v", "pos"):
            got = SH.assemble(
                [torch.from_numpy(r["cache"][j][k]) for r in ranks],
                SH.NamedSharding(mesh, SH.P(*ranks[0]["specs"][j][k])))
            if k == "pos":
                np.testing.assert_array_equal(got.numpy(), want[k])
            else:
                np.testing.assert_allclose(got.numpy(), want[k],
                                           atol=FWD_TOL, rtol=FWD_TOL)


# where each case's cache lands, read from the layouts: (spec of k, of
# pos, the collectives that show the path)
PATHS = {
    "s128": ((None, None, "model", None, None), (None, None, "model"),
             {"all_reduce/model/softmax"}),
    "s48": ((None, None, None, None, "model"), (None, None, "model"),
            {"all_gather/model/cache"}),
    "2x2-default": ((None, "data", "model", None, None),
                    (None, "data", "model"),
                    {"all_reduce/model/softmax", "all_gather/data/logits"}),
    "2x2-seq-over-dp": ((None, None, "data", None, "model"),
                        (None, None, "data"),
                        {"all_reduce/data/softmax",
                         "all_gather/model/cache"}),
    "2x2-heads-model": ((None, "data", None, None, "model"),
                        (None, "data", "model"),
                        {"all_gather/model/cache",
                         "all_gather/data/logits"}),
}


@pytest.mark.parametrize("name", list(PATHS))
def test_layout_takes_its_path(runs, name):
    """Each layout puts the cache where the reference's rules put it, and
    the step takes the path that layout asks for: a sequence split
    merges by the softmax statistics over the axes that split it, any
    other split is gathered at use, rows split over data are gathered
    in the logits; the merge runs nowhere else."""
    k_spec, pos_spec, need = PATHS[name]
    for r in _ranks(runs, name):
        for spec in r["specs"]:
            assert spec["k"] == spec["v"] == k_spec
            assert spec["pos"] == pos_spec
        assert need <= set(r["collectives"]), r["collectives"]
        merges = {c for c in r["collectives"] if c.endswith("/softmax")}
        assert merges <= need


@pytest.mark.parametrize("name", list(CASES))
def test_rank_layout_is_the_dry_runs(runs, name):
    """What each rank holds equals the dry-run's ``build_step`` decode
    shardings at the same layout on the same mesh (``fsdp_params``
    off), in the shape of every leaf and in bytes."""
    for r in _ranks(runs, name):
        d = r["dry"]
        assert d["param_shapes"] and d["cache_shapes"]
        assert d["param_bytes"][0] == d["param_bytes"][1]
        assert d["cache_bytes"][0] == d["cache_bytes"][1]


# ------------------------------------------------------------ in process


def _meshes(shape):
    """One ``ProcessMesh`` for each rank of `shape`, no process group
    (layouts and refusals only)."""
    n = shape[0] * shape[1]
    return [ProcessMesh(shape=OrderedDict(data=shape[0], model=shape[1]),
                        rank=r, coords=(r // shape[1], r % shape[1]),
                        device=torch.device("cpu")) for r in range(n)]


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m",
                                  "whisper-base"])
def test_recurrent_and_encdec_build_on_a_mesh(arch):
    """A recurrent or encoder-decoder config builds its sharded decode
    step on a (1, 2) mesh, and the dry-run's ``build_step(mesh=
    ProcessMesh)`` builds the decode step of each of its decode shapes
    (at the full config, on the meta device) under every cache layout,
    ZeRO-3 and ``fsdp=False``: each rank's parameter and cache shards
    equal its shardings in shape and bytes. The sharded runs are
    ``tests/test_torch_sharded_state.py``'s."""
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import dryrun as D
    from repro_torch.training.optimizer import _leaves
    small = get_config(arch, smoke=True).with_(dtype="float32")
    params = M.abstract_params(small)
    meshes = _meshes((1, 2))
    cache = T.init_cache(small, params, 2, 16)
    M.make_serve_step(small, param_shardings=SH.params_shardings(
        params, meshes[0], fsdp=False), cache_shardings=SH.cache_shardings(
        cache, meshes[0]))
    cfg = get_config(arch)
    shapes = [s for s in INPUT_SHAPES.values() if s.kind == "decode"]
    assert {s.name for s in shapes} == {"decode_32k", "long_500k"}
    for shape in shapes:
        for variant in ({}, {"fsdp_params": False, "seq_over_dp": True},
                        {"cache_heads_model": True}):
            for mesh in _meshes((2, 2)):
                _, args, shardings = D.build_step(cfg, shape, variant,
                                                  mesh=mesh)
                ps, _, cs, _ = shardings(mesh)
                for tree, sh in ((args[0], ps), (args[2], cs)):
                    held = SH.shard_tree(tree, sh)
                    got, want = [], []
                    SH.tree_map_with_path(lambda path, t: got.append(
                        tuple(t.shape)), held)
                    SH.tree_map_with_path(lambda path, t: want.append(
                        SH.shard_shape(t.shape, SH.leaf_at(sh, path))), tree)
                    assert got == want
                    assert sum(t.numel() * t.element_size() for t in
                               _leaves(held)) == SH.shard_nbytes(tree, sh)


def _attn_case(b, g, kvh, hd, s, seed):
    rng = np.random.default_rng(seed)
    h = g * kvh
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kvh, hd))
                             .astype(np.float32)) for _ in range(2))
    pos = torch.from_numpy(rng.permutation(np.tile(np.arange(s), (b, 1)).T)
                           .T.astype(np.int32).copy())
    return q, k, v, pos


def _splits(q, k, v, pos, kv_len, q_pos, n, window):
    """Each of `n` equal slices of the slots attended alone, with its own
    local kv_len (as a rank holding slots [lo, hi) calls the kernel),
    stacked on a leading dim."""
    s = k.shape[1] // n
    parts = [DA.decode_attention_ref(
        q, k[:, i * s:(i + 1) * s].contiguous(),
        v[:, i * s:(i + 1) * s].contiguous(),
        pos[:, i * s:(i + 1) * s].contiguous(),
        torch.clamp(kv_len - i * s, 0, s).to(torch.int32), q_pos,
        window=window, return_stats=True) for i in range(n)]
    return [torch.stack(t) for t in zip(*parts)]


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 3), g=st.sampled_from([1, 2, 4]),
       kvh=st.integers(1, 2), hd=st.sampled_from([4, 8]),
       n=st.sampled_from([1, 2, 4]), per=st.integers(1, 16),
       window=st.sampled_from([0, 5]), data=st.data())
def test_merge_softmax_of_splits_equals_the_whole_call(b, g, kvh, hd, n,
                                                       per, window, data):
    """``merge_softmax`` of n splits of the plain decode attention (with
    statistics) equals the unsplit call, whatever splits are hidden: by
    kv_len, by position, by the window, or every split of a row."""
    s = n * per
    q, k, v, pos = _attn_case(b, g, kvh, hd, s,
                              data.draw(st.integers(0, 2 ** 16)))
    kv_len = torch.tensor(data.draw(st.lists(st.integers(0, s), min_size=b,
                                             max_size=b)), dtype=torch.int32)
    q_pos = torch.tensor(data.draw(st.lists(st.integers(-1, s), min_size=b,
                                            max_size=b)), dtype=torch.int32)
    want, wm, wl = DA.decode_attention_ref(q, k, v, pos, kv_len, q_pos,
                                           window=window, return_stats=True)
    out, m, l = _splits(q, k, v, pos, kv_len, q_pos, n, window)
    got = TP.merge_softmax(out, m, l, TP.StackedShards(n), "model")
    for row in got:
        torch.testing.assert_close(row, want, atol=MERGE_TOL,
                                   rtol=MERGE_TOL)
    torch.testing.assert_close(m.amax(0), wm)


def test_plain_mean_of_splits_fails():
    """The control: the splits' outputs averaged without their softmax
    statistics. Where one split of a row is hidden (kv_len inside the
    first), that is far from the whole call, which ``merge_softmax``
    matches."""
    q, k, v, pos = _attn_case(2, 4, 2, 8, 32, seed=3)
    pos = torch.arange(32, dtype=torch.int32).expand(2, 32).contiguous()
    kv_len = torch.tensor([10, 30], dtype=torch.int32)
    q_pos = torch.tensor([9, 29], dtype=torch.int32)
    want, _, _ = DA.decode_attention_ref(q, k, v, pos, kv_len, q_pos,
                                         return_stats=True)
    out, m, l = _splits(q, k, v, pos, kv_len, q_pos, 2, 0)
    assert m[1, 0].eq(L.NEG_INF).all()           # row 0: split 1 hidden
    assert l[1, 0].eq(16).all()
    torch.testing.assert_close(
        TP.merge_softmax(out, m, l, TP.StackedShards(2), "model")[0], want,
        atol=MERGE_TOL, rtol=MERGE_TOL)
    bad = out.mean(0)
    assert not torch.allclose(bad, want, atol=1e-2, rtol=1e-2)
    assert float((bad[0] - want[0]).abs().max()) > 0.1


def test_decode_attention_ref_stats_agree_with_its_output():
    """``decode_attention_ref(return_stats=True)``: the same output as
    without statistics; m the max of the scaled visible scores, l the
    sum of their exponentials; a row with no visible lane m = NEG_INF,
    l = S, the mean of v."""
    q, k, v, pos = _attn_case(3, 2, 2, 8, 12, seed=5)
    kv_len = torch.tensor([12, 0, 7], dtype=torch.int32)
    q_pos = torch.tensor([11, 5, 100], dtype=torch.int32)
    plain = DA.decode_attention_ref(q, k, v, pos, kv_len, q_pos)
    out, m, l = DA.decode_attention_ref(q, k, v, pos, kv_len, q_pos,
                                        return_stats=True)
    assert out.dtype == m.dtype == l.dtype == torch.float32
    torch.testing.assert_close(out, plain, atol=1e-6, rtol=1e-6)
    assert m[1].eq(L.NEG_INF).all() and l[1].eq(12).all()
    torch.testing.assert_close(out[1], v[1].mean(0).repeat_interleave(2, 0))
    kk = k[0].repeat_interleave(2, 1)                       # (S, H, hd)
    scores = torch.einsum("hd,shd->hs", q[0], kk) / np.sqrt(8)
    torch.testing.assert_close(m[0], scores.amax(-1))
    torch.testing.assert_close(
        l[0], torch.exp(scores - scores.amax(-1, keepdim=True)).sum(-1))


def test_attention_stats_add_to_what_it_returned():
    """``attention(return_stats=True)`` returns the output it returns
    without them, bit for bit, and its (m, l) (B, Sq, H): the max of the
    scaled scores and the sum of their exponentials, over chunks."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((2, 3, 4, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 20, 2, 8))
                             .astype(np.float32)) for _ in range(2))
    kv_pos = torch.arange(20, dtype=torch.int32).expand(2, 20)
    q_pos = torch.tensor([[5, 6, 7], [17, 18, 19]], dtype=torch.int32)
    kw = dict(causal=True, window=6, kv_len=torch.tensor([20, 19]),
              chunk=8)
    plain = L.attention(q, k, v, q_pos, kv_pos, **kw)
    out, m, l = L.attention(q, k, v, q_pos, kv_pos, return_stats=True, **kw)
    assert torch.equal(out, plain)
    assert m.shape == l.shape == (2, 3, 4)
    kk = k.repeat_interleave(2, 2)
    scores = torch.einsum("bqhd,bshd->bqhs", q, kk) / np.sqrt(8)
    slot = torch.arange(20)
    vis = (slot[None, None] <= q_pos[..., None]) \
        & (slot[None, None] > q_pos[..., None] - 6) \
        & (slot[None, None] < kw["kv_len"][:, None, None])
    scores = torch.where(vis[:, :, None], scores, L.NEG_INF)
    torch.testing.assert_close(m, scores.amax(-1))
    torch.testing.assert_close(
        l, torch.exp(scores - scores.amax(-1, keepdim=True)).sum(-1))
