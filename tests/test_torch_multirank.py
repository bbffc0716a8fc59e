"""PyTorch port, multi-rank EP: the EP slot plane, the expert runtime and
the serving engine over a (data, ep, tp) ``launch.mesh.ServingMesh`` of
gloo ranks on the CPU, against three oracles on the reference's float32
weights (the mixtral smoke config at the drop-free capacity factor):

  (a) the reference's engine at (1, 1, 1), in this process;
  (b) the reference at ep=4, in a subprocess with 8 forced host devices
      and meshes built with Auto axes (``jax.make_mesh``'s default
      Explicit axes under jax 0.9 make the reference's own
      ``make_serving_mesh`` meshes refuse its sharding constraints);
  (c) the port at (1, 1, 1).

The ranks run in child processes: one subprocess runs a script that
computes (c) and then spawns the worlds in turn
(``launch.mesh.spawn_local``, gloo, a file rendezvous, collectives
bounded at 60 s), so this process forks nothing; (b) and the launcher at
``--ep 4 --host-devices 4`` run beside it, each subprocess under its own
timeout. The scripts write JSON and npz files for the tests to read.
Each contract is one test function. About 40 s on one worker.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.control import ControlPlane as JControlPlane
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.scheduler import GenRequest as JGenRequest
from repro_torch.launch.mesh import ServingMesh, check_mesh, make_serving_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240

# shared by both scripts: the smoke config, the trace and the overflow
# layer's inputs (numpy, seeded), so every oracle sees the same data
COMMON = r'''
import dataclasses, json, math, sys, time, warnings
import numpy as np

N_REQ, PLEN, MAX_NEW, SLOTS, MAX_LEN = 3, 8, 4, 3, 32
PAGED = dict(kv="paged", kv_block=5, prefill_chunk=3, prefix_cache=True)


def smoke(get_config, **over):
    cfg = get_config("mixtral-8x7b", smoke=True).with_(dtype="float32",
                                                        **over)
    return cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def trace(cls, vocab):
    rng = np.random.default_rng(7)
    return [cls(rid=i, arrival=0.05 * i,
                prompt=rng.integers(0, vocab, size=PLEN, dtype=np.int32),
                max_new_tokens=MAX_NEW) for i in range(N_REQ)]


def overflow_inputs(replicated=False):
    """A skewed router sends expert 0 more than its capacity: cap =
    ceil(0.5 * 2 * 32 / 4) = 8. `replicated`: positive tokens and a
    stronger skew send every token to expert 0, whose three replicas of
    cap = ceil(0.6875 * 2 * 32 / 4) = 11 rows hold 32 tokens only when
    the replicas take 11, 11 and 10 of them."""
    e, d, f = 4, 16, 32
    rng = np.random.default_rng(1)
    rw = (rng.standard_normal((d, e)) * 0.2).astype(np.float32)
    rw[:, 0] += 3.0 if replicated else 1.0
    w = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                      ("w_down", (e, f, d)))}
    x = rng.standard_normal((8, 4, d)).astype(np.float32)
    if replicated:
        return np.abs(x), rw, w, dict(E=e, TOPK=2, CF=0.6875)
    return x, rw, w, dict(E=e, TOPK=2, CF=0.5)


def replicated_tables(e=4):
    """Expert 0 in three slots on ranks 0, 1 and 2 (of 4 x 2 slots), the
    others in one each: a plan whose replica choice matters."""
    return {"expert_slots": np.array([[0, 2, 4], [1, 0, 0], [3, 0, 0],
                                      [5, 0, 0]], np.int32),
            "nrep": np.array([3, 1, 1, 1], np.int32),
            "slot_expert": np.array([0, 1, 0, 2, 0, 3, e, e], np.int32)}


def churn_plans(static_plan, scale_layer, place_layer, e):
    plans = [static_plan(e, 8)]
    rng = np.random.default_rng(3)
    for _ in range(3):   # replicas move between devices
        loads = rng.integers(1, 100, size=e).astype(np.float64)
        plans.append(place_layer(loads, scale_layer(
            loads, max_total_replicas=12), 8, prev=plans[-1]))
    return plans


def stats_of(rt, clock, pools):
    """The runtime's meters, GB-s settled at clock + 1, and the analytic
    pool's counts and GB-s."""
    st = rt.stats
    out = dict(counts=list(st.counts()), transfers=st.transfers,
               bytes_moved=st.bytes_moved, rank_bytes=dict(st.rank_bytes),
               eligible=st.overlap_eligible_copies,
               exposed=st.exposed_copies, hidden=st.overlap_hidden_s,
               row_bytes=float(rt.coeffs.expert_bytes))
    end = clock + 1.0
    out["pool_counts"] = [sum(getattr(p.stats, k) for p in pools)
                          for k in ("cold_starts", "warm_starts",
                                    "prewarmed")]
    out["pool_gbs"] = sum(p.finalize(end).instance_seconds_gb
                          for p in pools)
    out["gbs"] = rt.finalize(end).instance_seconds_gb
    return out
'''

# the reference at ep=4 on Auto meshes: oracle (b)
REF_SCRIPT = COMMON + r'''
import functools, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.control import ControlPlane
from repro.core.plan import static_plan
from repro.distributed import ep as EP
from repro.models import model as M
from repro.models.moe import dispatch_moe
from repro.serving.engine import ServingEngine
from repro.serving.expert_runtime import ExpertRuntime
from repro.serving.scheduler import GenRequest

out_dir = sys.argv[1]


def mesh(shape):
    return jax.make_mesh(shape, ("data", "ep", "tp"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3,
                         devices=jax.devices()[:math.prod(shape)])


mesh1, mesh4 = mesh((1, 1, 1)), mesh((1, 4, 1))
cfg = smoke(get_config, impl="ref")
params = M.init_params(cfg, jax.random.PRNGKey(0))
reqs = trace(GenRequest, cfg.vocab_size)
eng = ServingEngine(cfg, params, max_len=MAX_LEN, expert_runtime="on",
                    mesh=mesh4)
ctl = ControlPlane(cfg, "moeless", num_devices=8, max_replicas_per_device=2)
res = eng.serve(reqs, num_slots=SLOTS, control=ctl)
out = {"tokens": {str(r.rid): list(map(int, r.tokens)) for r in reqs},
       "iterations": res.iterations, "clock": res.clock_s,
       "stats": stats_of(res.runtime, res.clock_s, ctl.bal.pools.values())}

with warnings.catch_warnings(record=True) as wlog:
    warnings.simplefilter("always")
    rt = ExpertRuntime(cfg, params, num_devices=5, slots_per_device=2,
                       mesh=mesh4, keep_alive=1e9)
rt.bootstrap()
j0 = rt.moe_positions[0]
out["pad"] = dict(
    warned=any("masked slot" in str(w.message) for w in wlog),
    total=rt.total_slots, phys=rt.phys_slots, pad=rt.pad_slots,
    bank_slots=int(next(iter(rt.banks[j0].values())).shape[1]),
    slots_per_rank=rt.slots_per_rank,
    tables_max=int(rt.table_slots.max()))

def layer(mesh_, sd, x, rw, w, tables, k):
    """One jitted moe_ep_layer call (eager shard_map tracing is slow)."""
    fn = jax.jit(functools.partial(
        EP.moe_ep_layer, mesh=mesh_, num_experts=k["E"], top_k=k["TOPK"],
        slots_per_device=sd, capacity_factor=k["CF"]))
    with mesh_:
        sw = EP.materialise_slots(w, tables["slot_expert"], mesh_)
        return fn(jnp.asarray(x), jnp.asarray(rw), sw,
                  {n: jnp.asarray(tables[n])
                   for n in ("expert_slots", "nrep")})


x, rw, w, k = overflow_inputs()
tables = EP.plan_to_tables(static_plan(k["E"], 4), ep=4, slots_per_device=2,
                           num_devices=4)
jw = {n: jnp.asarray(v) for n, v in w.items()}
y, m = layer(mesh4, 2, x, rw, jw, tables, k)
_, md = jax.jit(functools.partial(
    dispatch_moe, top_k=k["TOPK"], num_experts=k["E"],
    capacity_factor=k["CF"]))(
        {"router": {"w_gate": jnp.asarray(rw)}, "experts": jw},
        jnp.asarray(x).reshape(1, -1, x.shape[-1]))
out["overflow"] = dict(loads=np.asarray(m["expert_load"]).tolist(),
                       dropped=float(m["dropped"]),
                       dispatch_dropped=float(md["dropped"]))
np.save(f"{out_dir}/ref_overflow_y.npy", np.asarray(y))
rep = replicated_tables(k["E"])
x, rw, w, k = overflow_inputs(replicated=True)
for name, mesh_, sd in (("ep1", mesh1, 8), ("ep4", mesh4, 2)):
    y, m = layer(mesh_, sd, x, rw, jw, rep, k)
    out[f"replicated_{name}"] = dict(dropped=float(m["dropped"]))
    np.save(f"{out_dir}/ref_replicated_y_{name}.npy", np.asarray(y))
with open(f"{out_dir}/ref.json", "w") as fh:
    json.dump(out, fh)
'''

# the port: oracle (c) in the parent, then the worlds in turn
PORT_SCRIPT = COMMON + r'''
import torch
from repro_torch.configs import ServingSpec, get_config
from repro_torch.core.control import (MOELESS_EXEC_TIME, ControlPlane,
                                      PlanEvent)
from repro_torch.core.placer import place_layer
from repro_torch.core.plan import static_plan
from repro_torch.core.scaler import scale_layer
from repro_torch.distributed import ep as EP
from repro_torch.launch.mesh import make_serving_mesh, spawn_local
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.expert_runtime import ExpertRuntime
from repro_torch.serving.scheduler import GenRequest

# argv reaches the spawned ranks too
OUT = sys.argv[1]
WEIGHTS = f"{OUT}/weights.npz"


def load(slot_dtype="fp32"):
    cfg = smoke(get_config)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, slot_dtype=slot_dtype))
    flat = np.load(WEIGHTS)
    tree = {}
    for key in flat.files:
        node, parts = tree, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]

    def fix(t):   # integer keys were list indices
        if isinstance(t, dict):
            t = {k: fix(v) for k, v in t.items()}
            if t and all(k.isdigit() for k in t):
                return [t[str(i)] for i in range(len(t))]
        return t
    return cfg, from_jax(fix(tree))


def serve(mesh, spec=None, slot_dtype="fp32"):
    cfg, params = load(slot_dtype)
    reqs = trace(GenRequest, cfg.vocab_size)
    eng = ServingEngine(cfg, params, max_len=MAX_LEN, expert_runtime="on",
                        mesh=mesh, serving=spec)
    ctl = ControlPlane(cfg, "moeless", num_devices=8,
                       max_replicas_per_device=2)
    res = eng.serve(reqs, num_slots=SLOTS, control=ctl)
    out = {"tokens": {str(r.rid): list(map(int, r.tokens)) for r in reqs},
           "iterations": res.iterations, "clock": res.clock_s,
           "local_bytes": res.runtime.local_bytes}
    out["stats"] = stats_of(res.runtime, res.clock_s, ctl.bal.pools.values())
    return out


def overflow(mesh, tables=None):
    x, rw, w, k = overflow_inputs(replicated=tables is not None)
    if tables is None:
        tables = EP.plan_to_tables(static_plan(k["E"], 4), ep=4,
                                   slots_per_device=2, num_devices=4)
    ep = 1 if mesh is None else mesh.shape["ep"]
    sw = EP.materialise_slots({n: torch.from_numpy(v) for n, v in w.items()},
                              tables["slot_expert"], mesh=mesh)
    y, m = EP.moe_ep_layer(torch.from_numpy(x), torch.from_numpy(rw), sw,
                           tables, num_experts=k["E"], top_k=k["TOPK"],
                           slots_per_device=8 // ep,
                           capacity_factor=k["CF"], mesh=mesh)
    return y.numpy(), m["expert_load"].tolist(), float(m["dropped"])


def runtimes(mesh, cfg, params):
    """An unchanged plan on every rank; double- against single-buffered
    banks after plan churn; the slot-geometry padding."""
    out = {}
    rt = ExpertRuntime(cfg, params, num_devices=8, slots_per_device=2,
                       mesh=mesh, keep_alive=1e9)
    plan = static_plan(cfg.moe.num_experts, 8)
    ev = [PlanEvent(plan=plan, served=plan, lead_time=math.inf,
                    exec_time=MOELESS_EXEC_TIME)
          for _ in range(rt.n_layers)]
    r1 = rt.apply(0.0, ev)
    b1 = rt.local_bytes
    r2 = rt.apply(1.0, ev)
    out["unchanged"] = dict(
        first_transfers=r1.transfers, first_bytes=r1.bytes_moved,
        first_rank_bytes=dict(r1.rank_bytes), first_local=b1,
        second_transfers=r2.transfers,
        second_rank_bytes=dict(r2.rank_bytes),
        second_local=rt.local_bytes - b1)
    dbl = ExpertRuntime(cfg, params, num_devices=8, slots_per_device=2,
                        mesh=mesh, keep_alive=1e9)
    one = ExpertRuntime(cfg, params, num_devices=8, slots_per_device=2,
                        mesh=mesh, keep_alive=1e9, double_buffer=False)
    for i, p in enumerate(churn_plans(static_plan, scale_layer, place_layer,
                                      cfg.moe.num_experts)):
        ev = [PlanEvent(plan=p, served=p, lead_time=math.inf,
                        exec_time=MOELESS_EXEC_TIME)
              for _ in range(dbl.n_layers)]
        dbl.apply(float(i), ev)
        one.apply(float(i), ev)
    out["double_equal"] = all(
        torch.equal(a[k], b[k])
        for a, b in zip(dbl.ep_state(), one.ep_state()) if a is not None
        for k in a)
    out["bank_shape"] = list(dbl.banks[dbl.moe_positions[0]]["w_up"].shape)
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        pad = ExpertRuntime(cfg, params, num_devices=5, slots_per_device=2,
                            mesh=mesh, keep_alive=1e9)
    pad.bootstrap()
    j0 = pad.moe_positions[0]
    out["pad"] = dict(
        warned=any("masked slot" in str(w.message) for w in wlog),
        total=pad.total_slots, phys=pad.phys_slots, pad=pad.pad_slots,
        local_slots=int(pad.banks[j0]["w_up"].shape[1]),
        slots_per_rank=pad.slots_per_rank,
        tables_max=int(pad.table_slots.max()))
    return out


def world(rank, degrees, what):
    torch.set_num_threads(1)
    import torch.distributed as dist
    data, ep, tp = degrees
    mesh = make_serving_mesh(ep=ep, tp=tp, data=data, device="cpu")
    out = {"coords": list(mesh.coords), "shard": mesh.shard,
           "groups": {n: dist.get_process_group_ranks(g)
                      for n, g in mesh.groups.items()}}
    if "diverge" in what:
        cfg, params = load()
        reqs = trace(GenRequest, cfg.vocab_size)
        if rank == 1:
            reqs[0].prompt = reqs[0].prompt[::-1].copy()
        eng = ServingEngine(cfg, params, max_len=MAX_LEN,
                            expert_runtime="on", mesh=mesh)
        t0 = time.perf_counter()
        try:
            eng.start(num_slots=SLOTS, requests=reqs, control=ControlPlane(
                cfg, "moeless", num_devices=8, max_replicas_per_device=2))
            out["diverge"] = "started"
        except RuntimeError as e:
            out["diverge"] = str(e)
        out["diverge_s"] = time.perf_counter() - t0
        return out
    if "serve" in what:
        out["serve"] = serve(mesh)
    if "int8" in what:
        out["int8"] = serve(mesh, slot_dtype="int8")
    if "paged" in what:
        out["paged"] = serve(mesh, ServingSpec(**PAGED))
    if "runtime" in what:
        cfg, params = load()
        out.update(runtimes(mesh, cfg, params))
    if "overflow" in what:
        y, loads, dropped = overflow(mesh)
        out["overflow"] = dict(loads=loads, dropped=dropped)
        yr, _, dr = overflow(mesh, replicated_tables())
        out["replicated"] = dict(dropped=dr)
        if rank == 0:
            np.save(f"{OUT}/port_overflow_y_ep{ep}.npy", y)
            np.save(f"{OUT}/port_replicated_y_ep{ep}.npy", yr)
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    res = {"single": serve(None), "single_int8": serve(None,
                                                         slot_dtype="int8")}
    y1, l1, d1 = overflow(None)
    np.save(f"{OUT}/port_overflow_y_ep1.npy", y1)
    res["single_overflow"] = dict(loads=l1, dropped=d1)
    yr, _, dr = overflow(None, replicated_tables())
    np.save(f"{OUT}/port_replicated_y_ep1.npy", yr)
    res["single_replicated"] = dict(dropped=dr)
    for name, degrees, what in (
            ("ep4", (1, 4, 1), ("serve", "paged", "runtime", "overflow")),
            ("ep4_tp2", (1, 4, 2), ("serve",)),
            ("data2_ep2", (2, 2, 1), ("serve",)),
            ("int8_ep2_tp2", (1, 2, 2), ("int8",)),
            ("diverge", (1, 2, 1), ("diverge",))):
        t1 = time.perf_counter()
        res[name] = spawn_local(world, math.prod(degrees), backend="gloo",
                                args=(degrees, what), wall_s=180.0)
        res[name + "_s"] = time.perf_counter() - t1
    res["total_s"] = time.perf_counter() - t0
    with open(f"{OUT}/port.json", "w") as fh:
        json.dump(res, fh)
'''


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


def _popen(script: pathlib.Path, out: pathlib.Path, **env):
    return subprocess.Popen(
        [sys.executable, str(script), str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1", **env})


def _wait(proc, what: str) -> str:
    try:
        log, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        log, _ = proc.communicate()
        raise AssertionError(f"{what} ran past {TIMEOUT_S} s:\n{log[-4000:]}")
    assert proc.returncode == 0, f"{what} failed:\n{log[-6000:]}"
    return log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("multirank")
    jcfg = jget_config("mixtral-8x7b", smoke=True).with_(dtype="float32",
                                                         impl="ref")
    jcfg = jcfg.with_(moe=dataclasses.replace(
        jcfg.moe, capacity_factor=float(jcfg.moe.num_experts)))
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    np.savez(out / "weights.npz", **_flatten(jax.tree.map(np.asarray, jp)))
    (out / "ref.py").write_text(REF_SCRIPT)
    (out / "port.py").write_text(PORT_SCRIPT)
    ref = _popen(out / "ref.py", out)
    port = _popen(out / "port.py", out)
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--expert-runtime", "on", "--ep", "4", "--host-devices", "4",
         "--requests", "4", "--prompt-len", "8", "--gen", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    try:
        # oracle (a): the reference's engine at (1, 1, 1), in process
        mesh1 = jax.make_mesh((1, 1, 1), ("data", "ep", "tp"),
                              axis_types=(jax.sharding.AxisType.Auto,) * 3)
        jreqs = _trace(jcfg.vocab_size)
        jeng = JServingEngine(jcfg, jp, max_len=32, expert_runtime="on",
                              mesh=mesh1)
        jres = jeng.serve(jreqs, num_slots=3, control=JControlPlane(
            jcfg, "moeless", num_devices=8, max_replicas_per_device=2))
        a = {"tokens": {str(r.rid): list(map(int, r.tokens)) for r in jreqs},
             "iterations": jres.iterations}
    finally:
        _wait(ref, "the reference at ep=4")
        _wait(port, "the port's worlds")
        cli_log = _wait(cli, "the launcher at --ep 4 --host-devices 4")
    return {"a": a, "b": json.loads((out / "ref.json").read_text()),
            "port": json.loads((out / "port.json").read_text()),
            "cli": cli_log,
            "dir": out}


def _trace(vocab):
    rng = np.random.default_rng(7)
    return [JGenRequest(rid=i, arrival=0.05 * i,
                        prompt=rng.integers(0, vocab, size=8, dtype=np.int32),
                        max_new_tokens=4) for i in range(3)]


def _same_on_every_rank(ranks, key):
    vals = [r[key] for r in ranks]
    assert all(v == vals[0] for v in vals), key
    return vals[0]


# ------------------------------------------------------------ the mesh


def test_make_serving_mesh_refuses_what_the_world_cannot_hold():
    mesh = make_serving_mesh(device="cpu")     # no process group: one rank
    assert isinstance(mesh, ServingMesh) and mesh.degrees == (1, 1, 1)
    assert mesh.groups == {} and mesh.shard == 0 and check_mesh(mesh) == \
        (1, 1, 1)
    for kw in (dict(devices=4, ep=4), dict(ep=2), dict(tp=2),
               dict(data=2, ep=1)):
        with pytest.raises(ValueError, match="host-devices"):
            make_serving_mesh(device="cpu", **kw)
    with pytest.raises(ValueError, match="ServingMesh"):
        check_mesh((1, 4, 1))


def test_mesh_ranks_row_major_with_ep_tp_shard_groups(runs):
    """Rank (d*ep + e)*tp + t has coordinates (d, e, t), its token shard
    is d*ep + e, and its groups are the reference's mesh axes."""
    for name, (dd, ee, tt) in (("ep4_tp2", (1, 4, 2)),
                               ("data2_ep2", (2, 2, 1))):
        for rank, r in enumerate(runs["port"][name]):
            d, e, t = r["coords"]
            assert rank == (d * ee + e) * tt + t
            assert r["shard"] == d * ee + e
            g = r["groups"]
            assert g.get("ep", [rank]) == [(d * ee + i) * tt + t
                                            for i in range(ee)]
            assert g.get("tp", [rank]) == [(d * ee + e) * tt + i
                                            for i in range(tt)]
            assert g.get("shard", [rank]) == [s * tt + t
                                               for s in range(dd * ee)]


# ------------------------------------------------------------ the engine


@pytest.mark.parametrize("world", ["ep4", "ep4_tp2", "data2_ep2"])
def test_engine_tokens_equal_reference_single(runs, world):
    """Greedy tokens and iterations at (1,4,1), (1,4,2) and (2,2,1) equal
    the reference's (1,1,1), on every rank."""
    a = runs["a"]
    assert runs["port"]["single"]["tokens"] == a["tokens"]
    for r in runs["port"][world]:
        assert r["serve"]["tokens"] == a["tokens"]
        assert r["serve"]["iterations"] == a["iterations"]


def test_paged_chunked_prefix_tokens_ep4_equal_reference_single(runs):
    for r in runs["port"]["ep4"]:
        assert r["paged"]["tokens"] == runs["a"]["tokens"]


def test_runtime_meters_ep4_equal_reference_ep4_and_pool(runs):
    """Counts, transfers, bytes, per-rank bytes, overlap meters and GB-s
    at (1,4,1): the same on every rank, equal to the reference's at
    ep=4 exactly, and to the analytic pool."""
    ranks = [r["serve"] for r in runs["port"]["ep4"]]
    st = _same_on_every_rank(ranks, "stats")
    b = runs["b"]["stats"]
    for k in ("counts", "transfers", "bytes_moved", "rank_bytes",
              "eligible", "exposed", "hidden", "gbs", "pool_counts",
              "pool_gbs"):
        assert st[k] == b[k], k
    assert st["counts"] == st["pool_counts"]
    assert st["gbs"] == pytest.approx(st["pool_gbs"], rel=1e-9)
    assert st["bytes_moved"] == st["transfers"] * st["row_bytes"]
    assert sorted(st["rank_bytes"]) == [f"rank{i}" for i in range(4)]
    assert math.isclose(sum(st["rank_bytes"].values()), st["bytes_moved"])
    assert st["eligible"] > 0 and st["exposed"] > 0 and st["hidden"] > 0
    assert st["eligible"] + st["exposed"] == st["transfers"]
    # the one-rank session moved the same bytes, all on rank0
    single = runs["port"]["single"]["stats"]
    assert single["bytes_moved"] == st["bytes_moved"]
    assert single["rank_bytes"] == {"rank0": st["bytes_moved"]}


@pytest.mark.parametrize("world,tp", [("ep4", 1), ("ep4_tp2", 2)])
def test_each_rank_writes_its_rank_bytes_share(runs, world, tp):
    """The bytes a rank wrote into its own banks, times tp, are its ep
    index's ``rank_bytes`` share."""
    for r in runs["port"][world]:
        e = r["coords"][1]
        st = r["serve"]["stats"]
        assert r["serve"]["local_bytes"] * tp == st["rank_bytes"][f"rank{e}"]


def test_unchanged_plan_moves_zero_bytes_on_every_rank(runs):
    for r in runs["port"]["ep4"]:
        u = r["unchanged"]
        assert u["first_transfers"] > 0
        assert math.isclose(sum(u["first_rank_bytes"].values()),
                            u["first_bytes"])
        assert u["first_local"] == \
            u["first_rank_bytes"][f"rank{r['coords'][1]}"]
        assert u["second_transfers"] == 0 and u["second_local"] == 0
        assert all(v == 0.0 for v in u["second_rank_bytes"].values())


def test_slot_geometry_padding_matches_reference(runs):
    """num_devices=5 x 2 slots over ep=4: 10 slots padded to 12 (2 masked
    pad slots, warned), 3 a rank, tables never point at a pad slot."""
    b = runs["b"]["pad"]
    assert (b["total"], b["phys"], b["pad"], b["bank_slots"]) == \
        (10, 12, 2, 12)
    for r in runs["port"]["ep4"]:
        p = r["pad"]
        assert p["warned"] and b["warned"]
        assert (p["total"], p["phys"], p["pad"]) == \
            (b["total"], b["phys"], b["pad"])
        assert p["slots_per_rank"] == b["slots_per_rank"] == 3
        assert p["local_slots"] * 4 == b["bank_slots"]
        assert p["tables_max"] == b["tables_max"] < p["total"]


def test_double_buffered_banks_equal_single_buffered_per_rank(runs):
    for r in runs["port"]["ep4"]:
        assert r["double_equal"]
        assert r["bank_shape"][1] == 4          # 16 slots over 4 ranks


# ------------------------------------------------------------ overflow


def test_forced_overflow_loads_and_drops_equal_reference_ep4(runs):
    b = runs["b"]["overflow"]
    single = runs["port"]["single_overflow"]
    assert single["dropped"] > 0
    for r in runs["port"]["ep4"]:
        assert r["overflow"]["dropped"] == b["dropped"] == single["dropped"]
        assert r["overflow"]["loads"] == b["loads"] == single["loads"]


def test_forced_overflow_output_ep4_bitwise_equal_ep1(runs):
    """The port's ep=4 layer output equals its ep=1 output bit for bit,
    and is within 1e-6 of the reference's at ep=4."""
    d = runs["dir"]
    y4 = np.load(d / "port_overflow_y_ep4.npy")
    y1 = np.load(d / "port_overflow_y_ep1.npy")
    yb = np.load(d / "ref_overflow_y.npy")
    assert np.array_equal(y4, y1)
    np.testing.assert_allclose(y4, yb, atol=1e-6, rtol=0)


def test_forced_overflow_drops_equal_dispatch_moe(runs):
    b = runs["b"]["overflow"]
    for r in runs["port"]["ep4"]:
        assert r["overflow"]["dropped"] == b["dispatch_dropped"]


def test_replica_choice_is_mesh_invariant_fixing_the_reference(runs):
    """With several replicas of an overflowing expert, the port picks a
    token's replica by its global index: ep=4 keeps, drops and outputs
    what ep=1 does, bit for bit, and ep=1 equals the reference's ep=1.
    The reference picks by the index within the shard, so its ep=4
    drops differ from its own ep=1 (pinned here)."""
    d, p, b = runs["dir"], runs["port"], runs["b"]
    y1 = np.load(d / "port_replicated_y_ep1.npy")
    np.testing.assert_allclose(y1, np.load(d / "ref_replicated_y_ep1.npy"),
                               atol=1e-6, rtol=0)
    assert p["single_replicated"]["dropped"] == \
        b["replicated_ep1"]["dropped"] > 0
    assert np.array_equal(np.load(d / "port_replicated_y_ep4.npy"), y1)
    for r in p["ep4"]:
        assert r["replicated"]["dropped"] == \
            p["single_replicated"]["dropped"]
    assert b["replicated_ep4"]["dropped"] != b["replicated_ep1"]["dropped"]


# ------------------------------------------------------------ int8, guards


def test_int8_banks_tp2_tokens_equal_port_single(runs):
    """int8 banks at (1,2,2), F split over tp with the D-length scales
    whole: greedy tokens equal the port's (1,1,1) at int8."""
    want = runs["port"]["single_int8"]["tokens"]
    for r in runs["port"]["int8_ep2_tp2"]:
        assert r["int8"]["tokens"] == want


def test_diverging_world_raises_at_start(runs):
    """Ranks given different request lists all raise at ``start`` (the
    session digest), at once rather than at a collective's timeout."""
    for r in runs["port"]["diverge"]:
        assert "ranks [1]" in r["diverge"], r["diverge"]
        assert r["diverge_s"] < 30


def test_launcher_serves_over_four_host_ranks(runs):
    out = runs["cli"]
    assert "serving mesh: data=1 ep=4 tp=1 over 4 devices" in out, out
    assert "served 4 requests x 4 tokens" in out
    assert out.count("served 4 requests") == 1     # rank 0 prints alone
    assert "'rank3'" in out
