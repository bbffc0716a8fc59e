"""PyTorch port, ``launch/ep_shardmap_serving.py`` against the reference's
``examples/ep_shardmap_serving.py`` loop on the same inputs (the port's
``make_inputs``, float32, on the CPU):

* the port's (data 2, ep 2, tp 2) world of 8 gloo ranks, through
  ``main(["--device", "cpu"])`` in a subprocess, against the reference's
  loop on 8 forced host devices in another subprocess, run side by side.
  The reference's mesh is built with Auto axes (``jax.make_mesh``'s
  default Explicit axes under jax 0.9 make its ``materialise_slots``
  refuse the sharding constraint, so the script fails as shipped), and
  its layer is jitted (the script calls it eagerly). Each iteration's
  loads, rank loads, replicas and slots updated are equal exactly, and
  ``y`` within atol = rtol = 1e-5 (tp partial sums added in another
  order); every rank returns rank 0's ``y`` bit for bit and writes its
  4 slots at the first iteration, nothing after;
* a skewed ``loads_override`` at (1, 1, 1), in this process, against the
  reference's functions on a one-device Auto mesh: the plan changes
  once and then stays, the slots updated, loads and replicas are equal,
  ``y`` within 1e-5, and the bytes written equal the changed slots
  (counted from each slot's fingerprint) times a slot's bytes.
"""
import functools
import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.placer import place_layer as jplace_layer
from repro.core.plan import static_plan as jstatic_plan
from repro.core.scaler import scale_layer as jscale_layer
from repro.distributed import ep as JEP
from repro_torch.launch import ep_shardmap_serving as S

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
TOL = 1e-5
ITERS = 4
# the skewed case: expert 0 far above the others, so scale_layer gives it
# replicas and the plan moves once
SKEW = [400.0, 40.0, 30.0, 30.0]
SKEW_ITERS, SKEW_SPD = 4, 8
SKEW_OVERRIDE = [None, SKEW, SKEW, None]

# the reference's loop on 8 forced host devices, inputs from an npz
REF_SCRIPT = r'''
import functools, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.core.placer import place_layer
from repro.core.plan import static_plan
from repro.core.scaler import scale_layer
from repro.distributed import ep as EP

out_dir = sys.argv[1]
f = np.load(f"{out_dir}/inputs.npz")
E, D, F, TOPK = 4, 64, 128, 2
mesh = jax.make_mesh((2, 2, 2), ("data", "ep", "tp"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
rw = jnp.asarray(f["rw"])
weights = {k: jnp.asarray(f[k]) for k in ("w_gate", "w_up", "w_down")}
layer = jax.jit(functools.partial(
    EP.moe_ep_layer, mesh=mesh, num_experts=E, top_k=TOPK,
    slots_per_device=4, capacity_factor=2.0))
plan = static_plan(E, 2)
padded = EP.pad_expert_bank(weights)
slot_w = prev_se = None
rows = []
with mesh:
    for it in range(4):
        x = jnp.asarray(f[f"x{it}"])
        tables = EP.plan_to_tables(plan, ep=2, slots_per_device=4)
        slot_w = EP.materialise_slots(
            weights, tables["slot_expert"], mesh, padded=padded,
            prev=slot_w, prev_slot_expert=prev_se)
        changed = "all" if prev_se is None else int(
            (np.asarray(prev_se) != np.asarray(tables["slot_expert"])).sum())
        prev_se = tables["slot_expert"]
        y, m = layer(x, rw, slot_w, {k: jnp.asarray(tables[k])
                                     for k in ("expert_slots", "nrep")})
        loads = np.asarray(m["expert_load"], np.float64)
        rank_load = plan.per_device_load(loads)
        rows.append(dict(loads=loads.tolist(), rank_loads=rank_load.tolist(),
                         replicas=plan.replicas.tolist(), changed=changed,
                         dropped=float(m["dropped"])))
        np.save(f"{out_dir}/ref_y{it}.npy", np.asarray(y))
        reps = scale_layer(loads, cv_threshold=0.2, max_total_replicas=8)
        plan = place_layer(loads, reps, 2, prev=plan)
with open(f"{out_dir}/ref.json", "w") as fh:
    json.dump(rows, fh)
'''

# the port's world through main, every rank's records pickled (the ranks
# are spawned: they import this script again)
PORT_SCRIPT = r'''
import pickle, sys
from repro_torch.launch import ep_shardmap_serving as S
if __name__ == "__main__":
    ranks = S.main(["--device", "cpu"])
    with open(sys.argv[1] + "/port.pkl", "wb") as fh:
        pickle.dump(ranks, fh)
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("ep_shardmap")
    rw, w, xs = S.make_inputs(iters=ITERS)
    np.savez(out / "inputs.npz", rw=rw.numpy(),
             **{k: v.numpy() for k, v in w.items()},
             **{f"x{i}": x.numpy() for i, x in enumerate(xs)})
    procs = {}
    for name, script in (("ref", REF_SCRIPT), ("port", PORT_SCRIPT)):
        (out / f"{name}.py").write_text(script)
        procs[name] = subprocess.Popen(
            [sys.executable, str(out / f"{name}.py"), str(out)], cwd=ROOT,
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    logs = {}
    try:
        for name, p in procs.items():
            logs[name] = p.communicate(timeout=TIMEOUT_S)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for name, p in procs.items():
        assert p.returncode == 0, f"{name}:\n{logs[name][-4000:]}"
    with open(out / "ref.json") as fh:
        ref = json.load(fh)
    ref_y = [np.load(out / f"ref_y{i}.npy") for i in range(ITERS)]
    with open(out / "port.pkl", "rb") as fh:
        ranks = pickle.load(fh)
    return ref, ref_y, ranks, logs["port"]


def test_world_matches_reference_loop(worlds):
    ref, ref_y, ranks, _ = worlds
    assert len(ranks) == 8 and all(len(r) == ITERS for r in ranks)
    for it, (want, got) in enumerate(zip(ref, ranks[0])):
        assert got.loads == want["loads"], it
        assert got.rank_loads == want["rank_loads"], it
        assert got.replicas == want["replicas"], it
        assert got.slots_updated == want["changed"], it
        assert got.dropped == want["dropped"], it
        np.testing.assert_allclose(got.y.numpy(), ref_y[it], atol=TOL,
                                   rtol=TOL)


def test_every_rank_agrees_and_writes_its_slots(worlds):
    _, _, ranks, _ = worlds
    # a rank's 4 slots of its F half: w_gate, w_up (64 x 64) and w_down
    slot_bytes = 3 * 64 * 64 * 4
    for r in ranks:
        for it, (a, b) in enumerate(zip(r, ranks[0])):
            assert torch.equal(a.y, b.y), it
            assert (a.loads, a.replicas) == (b.loads, b.replicas)
        assert [i.bytes_written for i in r] == [4 * slot_bytes, 0, 0, 0]
    # the two tp halves of a slot hold different columns of one expert
    assert ranks[0][0].slot_sums != ranks[1][0].slot_sums


def test_main_prints_the_reference_lines(worlds):
    ref, _, _, log = worlds
    lines = [l for l in log.splitlines()
             if l.startswith(("iter ", "replica plan", "serving mesh"))]
    assert lines[0] == ("serving mesh: data=2 ep=2 tp=2 over 8 local ranks "
                        "on cpu")
    assert len(lines) == ITERS + 2
    for it, row in enumerate(ref):
        want = (f"iter {it}: expert loads="
                f"{np.asarray(row['loads']).astype(int)} rank loads="
                f"{np.asarray(row['rank_loads']).round(0)} replicas="
                f"{row['replicas']} slots updated={row['changed']}")
        assert lines[1 + it] == want
    assert lines[-1] == ("replica plan adapted between iterations with no "
                         "recompilation")


def _ref_skewed():
    """The reference's functions at (1, 1, 1) on the port's inputs, with
    the same override as the port's run."""
    rw, w, xs = S.make_inputs(iters=SKEW_ITERS)
    mesh = jax.make_mesh((1, 1, 1), ("data", "ep", "tp"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3,
                         devices=jax.devices()[:1])
    weights = {k: jnp.asarray(v.numpy()) for k, v in w.items()}
    layer = jax.jit(functools.partial(
        JEP.moe_ep_layer, mesh=mesh, num_experts=4, top_k=2,
        slots_per_device=SKEW_SPD, capacity_factor=2.0))
    plan = jstatic_plan(4, 1)
    padded = JEP.pad_expert_bank(weights)
    slot_w = prev_se = None
    rows = []
    with mesh:
        for it in range(SKEW_ITERS):
            tables = JEP.plan_to_tables(plan, ep=1,
                                        slots_per_device=SKEW_SPD)
            slot_w = JEP.materialise_slots(
                weights, tables["slot_expert"], mesh, padded=padded,
                prev=slot_w, prev_slot_expert=prev_se)
            changed = "all" if prev_se is None else int(
                (np.asarray(prev_se) != tables["slot_expert"]).sum())
            prev_se = tables["slot_expert"]
            y, m = layer(jnp.asarray(xs[it].numpy()), jnp.asarray(rw.numpy()),
                         slot_w, {k: jnp.asarray(tables[k])
                                  for k in ("expert_slots", "nrep")})
            loads = np.asarray(m["expert_load"], np.float64)
            rows.append(dict(loads=loads.tolist(),
                             replicas=plan.replicas.tolist(),
                             changed=changed, y=np.asarray(y)))
            src = loads if SKEW_OVERRIDE[it] is None else \
                np.asarray(SKEW_OVERRIDE[it])
            plan = jplace_layer(src, jscale_layer(
                src, cv_threshold=0.2, max_total_replicas=8), 1, prev=plan)
    return rows


def test_skewed_override_changes_slots_like_reference():
    torch.set_num_threads(1)
    got = S.run(None, ep=1, slots_per_device=SKEW_SPD, iters=SKEW_ITERS,
                device="cpu", loads_override=SKEW_OVERRIDE,
                log=lambda _: None)
    want = _ref_skewed()
    assert [g.slots_updated for g in got] == [w["changed"] for w in want]
    changed = [g.slots_updated for g in got]
    assert changed[0] == "all" and changed[1] == 0 and changed[2] > 0 \
        and changed[3] == 0, changed
    assert got[2].replicas != got[1].replicas == [1, 1, 1, 1]
    assert got[3].replicas == got[2].replicas
    for it, (g, w) in enumerate(zip(got, want)):
        assert g.loads == w["loads"], it
        assert g.replicas == w["replicas"], it
        np.testing.assert_allclose(g.y.numpy(), w["y"], atol=TOL, rtol=TOL)
    slot_bytes = 3 * 64 * 128 * 4
    assert got[0].bytes_written == SKEW_SPD * slot_bytes
    for prev, cur in zip(got, got[1:]):
        moved = sum(any(prev.slot_sums[k][s] != cur.slot_sums[k][s]
                        for k in cur.slot_sums) for s in range(SKEW_SPD))
        assert cur.bytes_written == moved * slot_bytes
    assert got[2].bytes_written > 0 and got[3].bytes_written == 0


def test_override_none_keeps_the_measured_loads():
    base = S.run(None, ep=2, iters=2, device="cpu", log=lambda _: None)
    same = S.run(None, ep=2, iters=2, device="cpu",
                 loads_override=[None, None], log=lambda _: None)
    for a, b in zip(base, same):
        assert a.loads == b.loads and torch.equal(a.y, b.y)
    # one process holds the 2-rank plan's 8 slots
    assert base[0].bytes_written == 8 * 3 * 64 * 128 * 4


def test_main_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.main([])
