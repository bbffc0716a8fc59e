"""The EP data plane of the PyTorch port over a (data=2, ep=2, tp=2) mesh
of local ranks, the counterpart of ``examples/ep_shardmap_serving.py``:
run ``distributed.ep.moe_ep_layer`` for a few iterations, re-plan the
replicas between iterations from the measured loads (``scale_layer``,
``place_layer(prev=)``), and re-materialise only the slots whose
resident expert changed (the expert bank is padded once).

  PYTHONPATH=src python -m repro_torch.launch.ep_shardmap_serving --device cpu

spawns 8 gloo ranks on the CPU; without ``--device cpu`` the 8 ranks
share the CUDA card and move tensors through shared staging buffers
(``launch/transport.py``). Rank 0 prints the reference's lines. The
weights come from a seeded ``torch.Generator`` with the reference's
scales, so the printed loads differ from the reference script's; the
tests hold ``run`` to the reference's loop on the same inputs.

At the reference's sizes the router's bias (+0.5 on expert 0's column,
a random sign per token) leaves the loads near uniform, so the plan
never changes. ``run(loads_override=)`` re-plans from given loads
instead, to exercise the changed-slot path.
"""
from __future__ import annotations

import argparse
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import IMPLS

DEGREES = (2, 2, 2)          # (data, ep, tp)
BATCH, SEQ = 4, 32


class Iteration(NamedTuple):
    """One iteration on this rank: the expert loads, dropped tokens,
    per-EP-rank loads and replicas of the plan it ran, the slots whose
    resident expert changed ("all" at the first), the bytes this rank
    wrote into its slot banks, each local slot's sum per bank leaf
    (float32 sums, a fingerprint of what the slot holds), and the layer's
    output (the whole batch, on the host)."""
    loads: list
    dropped: float
    rank_loads: list
    replicas: list
    slots_updated: object
    bytes_written: int
    slot_sums: dict
    y: torch.Tensor


def make_inputs(*, num_experts: int = 4, d_model: int = 64,
                d_ff: int = 128, iters: int = 4, dtype=torch.float32,
                seed: int = 0, device="cpu"):
    """The example's weights and inputs drawn from one seeded
    ``torch.Generator`` on `device`, in this order: the router (D, E) x
    0.2 with +0.5 on expert 0's column, ``w_gate``, ``w_up`` (E, D, F)
    and ``w_down`` (E, F, D) x 0.1, then each iteration's (4, 32, D)
    input. Returns (router, weights, inputs) in `dtype`."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale) \
            .to(dtype)

    e, d, f = num_experts, d_model, d_ff
    rw = torch.randn((d, e), generator=g, device=device) * 0.2
    rw[:, 0] += 0.5
    weights = {"w_gate": randn(e, d, f, scale=0.1),
               "w_up": randn(e, d, f, scale=0.1),
               "w_down": randn(e, f, d, scale=0.1)}
    xs = [randn(BATCH, SEQ, d) for _ in range(iters)]
    return rw.to(dtype), weights, xs


def run(mesh, *, num_experts: int = 4, d_model: int = 64, d_ff: int = 128,
        top_k: int = 2, slots_per_device: int = 4,
        max_total_replicas: int = 8, iters: int = 4,
        capacity_factor: float = 2.0, dtype=torch.float32, seed: int = 0,
        impl: str = "auto", ep: int = 2, device=None, loads_override=None,
        log=print) -> list[Iteration]:
    """The example's loop on this rank of `mesh` (a ``ServingMesh``; None:
    one process holding all ep x slots_per_device slots of an `ep`-rank
    plan, on `device`, default the CUDA card). The plan starts at
    ``static_plan(E, ep)``; after each iteration the next plan is scaled
    at CV 0.2 to at most `max_total_replicas` and placed on ep ranks with
    ``prev=``, from the measured loads or, where ``loads_override[it]``
    is not None, from those. Returns each iteration's record."""
    from repro_torch.core.placer import place_layer
    from repro_torch.core.plan import static_plan
    from repro_torch.core.scaler import scale_layer
    from repro_torch.distributed import ep as EP
    if mesh is not None:
        ep, device = mesh.shape["ep"], mesh.device
    elif device is None:
        device = "cuda"
    e = num_experts
    rw, weights, xs = make_inputs(num_experts=e, d_model=d_model, d_ff=d_ff,
                                  iters=iters, dtype=dtype, seed=seed,
                                  device=device)
    # one process runs the whole slot bank of the ep-rank plan
    spd = slots_per_device if mesh is not None else ep * slots_per_device
    plan = static_plan(e, ep)
    # pad the expert bank ONCE; per-iteration materialisation then only
    # copies slots whose resident expert changed (function locality —
    # an unchanged plan moves zero weights)
    padded = EP.pad_expert_bank(weights)
    del weights
    slot_w = prev_se = None
    lo = 0 if mesh is None else mesh.coords[1] * slots_per_device
    out = []
    for it in range(iters):
        tables = EP.plan_to_tables(plan, ep=ep,
                                   slots_per_device=slots_per_device)
        se = tables["slot_expert"]
        slot_w = EP.materialise_slots(None, se, padded=padded, prev=slot_w,
                                      prev_slot_expert=prev_se, mesh=mesh)
        slot_bytes = sum(w[0].numel() * w.element_size()
                         for w in slot_w.values())
        if prev_se is None:
            changed, written = "all", spd * slot_bytes
        else:
            changed = int((prev_se != se).sum())
            written = int((prev_se[lo:lo + spd] != se[lo:lo + spd]).sum()) \
                * slot_bytes
        prev_se = se
        y, m = EP.moe_ep_layer(
            xs[it], rw, slot_w, tables, num_experts=e, top_k=top_k,
            slots_per_device=spd, capacity_factor=capacity_factor,
            impl=impl, mesh=mesh)
        loads = m["expert_load"].cpu().numpy().astype(np.float64)
        # per-EP-rank load under the current plan
        rank_load = plan.per_device_load(loads)
        log(f"iter {it}: expert loads={loads.astype(int)} "
            f"rank loads={rank_load.round(0)} "
            f"replicas={plan.replicas.tolist()} "
            f"slots updated={changed}")
        out.append(Iteration(
            loads.tolist(), float(m["dropped"]), rank_load.tolist(),
            plan.replicas.tolist(), changed, written,
            {k: w.flatten(1).sum(1, dtype=torch.float32).cpu().tolist()
             for k, w in slot_w.items()}, y.cpu()))
        # MoEless control plane: next iteration's plan from this one's
        # loads (predictor distance handled upstream)
        src = loads if loads_override is None or \
            loads_override[it] is None else \
            np.asarray(loads_override[it], np.float64)
        reps = scale_layer(src, cv_threshold=0.2,
                           max_total_replicas=max_total_replicas)
        plan = place_layer(src, reps, ep, prev=plan)
    log("replica plan adapted between iterations with no recompilation")
    return out


def _rank(rank: int, device: str, impl: str) -> list[Iteration]:
    """One rank of ``main``'s world: the mesh, then ``run`` (rank 0
    logs)."""
    from repro_torch.launch.mesh import make_serving_mesh
    data, ep, tp = DEGREES
    if device == "cpu":
        torch.set_num_threads(1)
    mesh = make_serving_mesh(data=data, ep=ep, tp=tp, device=device,
                             transport="shared" if device.startswith("cuda")
                             else "auto")
    return run(mesh, impl=impl,
               log=print if rank == 0 else (lambda _: None))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the ranks' torch device (default: the CUDA card, "
                         "which the 8 ranks share; raises where none is "
                         "present)")
    ap.add_argument("--impl", default="auto", choices=IMPLS,
                    help="kernel backend of the expert FFN; auto = the "
                         "CUDA kernels on the card, the plain versions "
                         "on the CPU")
    args = ap.parse_args(argv)
    from repro_torch.launch import ep_shardmap_serving as me
    from repro_torch.launch.mesh import spawn_local
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is present; pass --device "
                               "cpu to run on the CPU")
        from repro_torch.kernels import build as KB
        KB.build()     # once here, not once a rank
    n = int(np.prod(DEGREES))
    print(f"serving mesh: data={DEGREES[0]} ep={DEGREES[1]} "
          f"tp={DEGREES[2]} over {n} local ranks on {args.device}",
          flush=True)
    return spawn_local(me._rank, n, backend="gloo",
                       args=(args.device, args.impl), wall_s=600.0)


if __name__ == "__main__":
    main()
