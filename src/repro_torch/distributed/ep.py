"""Expert parallelism with serverless replica slots — the serving data
plane that executes the MoEless replica plans (paper §2.2/§3.2): expert
*function instances* (slots) hold expert weights, the plan is applied as
slot tables re-programmed between iterations, tokens are routed to slots
round-robin over an expert's replicas (paper step 4), processed by the
grouped FFN kernels in the capacity layout, and combined.

The plane runs on a (data, ep, tp) ``launch.mesh.ServingMesh``: one
process a rank, ``torch.distributed`` collectives where the reference's
shard_map body has its all-gathers, all-to-alls and psums, and the same
global-rank arithmetic (``prek``, ``before``, ``prelk``, the trash row,
``recv_cnt`` -> group sizes), so keep/drop does not depend on the mesh.
The layer receives the batch replicated on every rank (the non-expert
layers run replicated), computes its own shard's rows and returns the
whole batch. Without a mesh (or on a (1, 1, 1) one) every collective is
an identity and no process group is needed.

The table helpers (``ep_factorisation``, ``device_rank``,
``plan_to_tables``, ``uniform_tables``) are numpy, valid for any ``ep``.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.launch.mesh import check_degrees, check_mesh  # noqa: F401

_WKEYS = ("w_gate", "w_gate_scale", "w_up", "w_up_scale", "w_down",
          "w_down_scale")


def ep_factorisation(num_experts: int, model_degree: int) -> tuple[int, int]:
    ep = math.gcd(num_experts, model_degree)
    return ep, model_degree // ep


# ------------------------------------------------------------ slot tables


def device_rank(g: int, *, num_devices: int, ep: int) -> int:
    """EP rank owning logical control-plane device `g`: contiguous blocks
    of num_devices // ep logical devices map to one rank, so a plan's
    locality structure survives the projection. Requires
    ep | num_devices (``ep_factorisation`` always satisfies it)."""
    if num_devices % ep:
        raise ValueError(
            f"device_rank: num_devices={num_devices} is not a multiple "
            f"of ep={ep}; no block mapping of logical devices onto mesh "
            f"ranks exists")
    return (g % num_devices) // (num_devices // ep)


def plan_to_tables(plan, *, ep: int, slots_per_device: int,
                   num_devices: int | None = None):
    """LayerPlan -> routing tables (numpy int32, all shapes static).

    `num_devices` maps the plan's LOGICAL devices onto the `ep` ranks
    with ``device_rank`` (block mapping); without it the `g % ep` fold is
    used (right only when the plan already places on ranks). A replica
    planned onto a full rank SPILLS to the ring-nearest rank with a free
    slot, with a warning; only a plan with more replicas than
    ep * slots_per_device is an error.

    Returns dict:
      expert_slots (E, R_max): global slot id of each replica (-1 pad)
      nrep         (E,)
      slot_expert  (ep*slots_per_device,): expert in each slot (E =>
                   empty). Rank of slot s = s // slots_per_device.
    """
    e_count = plan.num_experts
    if plan.total_replicas > ep * slots_per_device:
        raise ValueError(
            f"plan places {plan.total_replicas} replicas but the slot "
            f"tables hold only {ep} ranks x {slots_per_device} slots")
    r_max = int(plan.replicas.max())
    expert_slots = -np.ones((e_count, r_max), np.int32)
    slot_expert = np.full(ep * slots_per_device, e_count, np.int32)
    used = np.zeros(ep, np.int32)
    spilled = 0
    for e in range(e_count):
        for r, g in enumerate(plan.placement[e]):
            if num_devices is not None:
                g = device_rank(int(g), num_devices=num_devices, ep=ep)
            else:
                g = g % ep
            if used[g] >= slots_per_device:
                g = min((int(gg) for gg in range(ep)
                         if used[gg] < slots_per_device),
                        key=lambda gg: min((gg - g) % ep, (g - gg) % ep))
                spilled += 1
            s = g * slots_per_device + used[g]
            used[g] += 1
            expert_slots[e, r] = s
            slot_expert[s] = e
    if spilled:
        warnings.warn(
            f"plan_to_tables: {spilled} replica(s) overflowed their rank "
            f"(cap {slots_per_device}/rank) and spilled to neighbours",
            RuntimeWarning, stacklevel=2)
    return {"expert_slots": expert_slots,
            "nrep": plan.replicas.astype(np.int32),
            "slot_expert": slot_expert}


def uniform_tables(num_experts: int, *, ep: int, slots_per_device: int):
    """Static EP (Megatron baseline): expert e in slot 0 of rank e % ep,
    filling ranks round-robin."""
    from repro_torch.core.plan import static_plan
    return plan_to_tables(static_plan(num_experts, ep), ep=ep,
                          slots_per_device=slots_per_device)


def pad_expert_bank(expert_weights):
    """Expert bank with one zero row appended (the empty-slot expert id E
    indexes it). Pad once and reuse across iterations."""
    return {k: torch.cat([w, torch.zeros_like(w[:1])], dim=0)
            for k, w in expert_weights.items()}


def tp_slice(k: str, w, mesh, lead: int = 1):
    """This rank's share of slot-bank leaf `k` under tp: the F axis of
    ``w_gate``/``w_up`` (last), ``w_down`` (after the `lead` bank axes)
    and ``w_down_scale`` (last) is split over 'tp'; the D-length scales
    of ``w_gate``/``w_up`` stay whole, as the reference shards them
    (``src/repro/distributed/ep.py:156 _slot_spec``)."""
    tp = 1 if mesh is None else mesh.shape["tp"]
    if tp == 1 or k in ("w_gate_scale", "w_up_scale"):
        return w
    axis = lead if k == "w_down" else w.dim() - 1
    n = w.shape[axis]
    if n % tp:
        raise ValueError(f"{k}: width {n} does not split over tp={tp}")
    i = mesh.coords[2]
    return w.narrow(axis, i * (n // tp), n // tp).contiguous()


def materialise_slots(expert_weights, slot_expert, *, padded=None,
                      prev=None, prev_slot_expert=None, mesh=None):
    """Fill this rank's slot weight banks from the expert bank: dict of
    (S_total / ep, ...) tensors, local slot m holding expert
    ``slot_expert[r * S_total / ep + m]`` of its rank r's block (E =>
    the zero row), only this rank's F slice under tp (``tp_slice``).
    `padded` is an optional bank from ``pad_expert_bank``. When `prev`
    (the previous banks) and `prev_slot_expert` are given, only slots
    whose resident expert CHANGED are written, in place — warm slots are
    never re-copied, so an unchanged plan moves zero bytes."""
    if padded is None:
        padded = pad_expert_bank(expert_weights)
    padded = {k: tp_slice(k, w, mesh) for k, w in padded.items()}
    slot_expert = np.asarray(slot_expert)
    ep = 1 if mesh is None else mesh.shape["ep"]
    spr = slot_expert.shape[0] // ep
    lo = 0 if mesh is None else mesh.coords[1] * spr
    slot_expert = slot_expert[lo:lo + spr]
    if prev is not None and prev_slot_expert is not None:
        prev_local = np.asarray(prev_slot_expert)[lo:lo + spr]
        changed = np.flatnonzero(slot_expert != prev_local)
        if changed.size == 0:
            return prev
        for k, w in padded.items():
            idx = torch.as_tensor(changed, device=w.device)
            src = torch.as_tensor(slot_expert[changed], device=w.device)
            prev[k].index_copy_(0, idx, w.index_select(0, src))
        return prev
    return {k: w.index_select(0, torch.as_tensor(slot_expert,
                                                 device=w.device))
            for k, w in padded.items()}


# ------------------------------------------------------------ the layer


def _gather(mesh, x, group):
    return x[None] if mesh is None else mesh.all_gather(x, group)


def _a2a(mesh, x):
    return x if mesh is None else mesh.all_to_all(x, "ep")


def _reduce(mesh, x, group):
    return x if mesh is None else mesh.all_reduce(x, group)


def _topk(logits, k):
    """Softmax weights over the top-k and their indices; ties lower index
    first, as ``jax.lax.top_k``."""
    w, i = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(w[..., :k], dim=-1), i[..., :k]


def _bincount(v, length):
    """Counts of each value in [0, length) of `v` (whose values lie
    there). Not ``torch.bincount``: on the card it reads the maximum of
    `v` back to the host to size its output, a device sync per call."""
    return torch.zeros(length, dtype=torch.int64, device=v.device) \
        .index_add_(0, v, torch.ones_like(v))


def moe_ep_layer(x, router_w, slot_w, tables, *, num_experts: int,
                 top_k: int, slots_per_device: int,
                 capacity_factor: float, act: str = "swiglu",
                 impl: str = "auto", token_mask=None, pad_rows: int = 0,
                 mesh=None):
    """x: (B, S, D), the whole batch on every rank of `mesh` (a
    ``launch.mesh.ServingMesh``; None: one process); B must be a multiple
    of data*ep, and this rank's shard owns rows [me*b, (me+1)*b), b =
    B / (data*ep). slot_w: this rank's slot banks (``w_gate``/``w_up``
    (S, D, F), ``w_down`` (S, F, D), or int8 with ``*_scale`` companions, which
    select the dequantizing kernels); tables: ``expert_slots`` (E, R) and
    ``nrep`` (E,). `token_mask` (B, S) excludes tokens (inactive
    continuous-batching slots) from the expert-load and dropped metrics;
    compute is unaffected. `pad_rows` marks the LAST pad_rows rows of the
    batch as padding artifacts: they are excluded from the capacity
    formula and made unroutable.

    Capacity / drop semantics are those of ``models.moe.dispatch_moe``
    (one dispatch group): every replica slot gets the per-expert
    capacity ``ceil(capacity_factor * top_k * T / E)`` from the logical
    token count T = (B - pad_rows) * S, and each assignment's priority
    within its slot is its GShard rank (all k=0 assignments in token
    order, then k=1, ...). Overflow is counted, not silently zeroed.
    `capacity_factor` has no default on purpose.

    Returns (y, metrics): y the whole (B, S, D) batch on every rank (the
    shards' rows all-gathered), metrics in the ``dispatch_moe`` shape:
    ``expert_load`` (E,) and ``dropped`` summed over the shards, and
    ``aux_loss`` (0)."""
    from repro_torch.kernels import ops as KOPS
    if act != "swiglu":
        # the reference's slot plane takes `act` and never reads it
        raise NotImplementedError(
            f"act={act!r}: the slot banks hold SwiGLU experts — the "
            "reference has the same limit "
            "(src/repro/serving/expert_runtime.py:169)")
    n_data, ep, _ = check_mesh(mesh)
    n_shards = n_data * ep
    sd_ = slots_per_device
    n_slots = ep * sd_
    if x.shape[0] % n_shards:
        raise ValueError(
            f"moe_ep_layer: batch {x.shape[0]} is not a multiple of "
            f"data*ep = {n_shards}")
    if not 0 <= pad_rows < x.shape[0]:
        raise ValueError(f"pad_rows={pad_rows} outside [0, B={x.shape[0]})")
    logical_t = (x.shape[0] - pad_rows) * x.shape[1]
    KOPS.resolve_impl(impl)   # fail fast on unknown backends
    dev = x.device
    if token_mask is None:
        token_mask = torch.ones(x.shape[:2], dtype=torch.int32, device=dev)
    bank = {k: slot_w[k] for k in _WKEYS if k in slot_w}
    quantized = "w_up_scale" in bank
    expert_slots = torch.as_tensor(tables["expert_slots"], device=dev).long()
    nrep = torch.as_tensor(tables["nrep"], device=dev).long()
    me = 0 if mesh is None else mesh.shard   # index in ('data', 'ep') order
    shape, b = x.shape, x.shape[0] // n_shards
    s, d = shape[1], shape[2]
    x = x[me * b:(me + 1) * b]
    token_mask = token_mask[me * b:(me + 1) * b]
    t = b * s
    xf = x.reshape(t, d)
    top_w, top_i = _topk((xf @ router_w).float(), top_k)

    # replica choice: round robin over the expert's replicas (step 4) by
    # the GLOBAL token index (me*t + i), so a token takes the same replica
    # on every mesh (the reference counts tokens within the shard, so
    # with several replicas of an expert its keep/drop depends on the
    # mesh under capacity pressure); a zero-replica expert routes to
    # slot 0, masked out below and counted as dropped
    ar_t = torch.arange(t, device=dev)
    ar_k = torch.arange(top_k, device=dev)
    nrep_t = nrep[top_i]                                    # (t, k)
    r_idx = torch.remainder(me * t + ar_t[:, None] + ar_k,
                            nrep_t.clamp(min=1))
    slot = expert_slots[top_i, r_idx]                       # (t, k)
    routable = (nrep_t > 0) & (slot >= 0)
    if pad_rows:
        # padding rows (the LAST pad_rows of the global batch) never
        # consume capacity; this shard owns global rows [me*b, (me+1)*b)
        real_row = me * b + torch.arange(b, device=dev) \
            < b * n_shards - pad_rows
        routable = routable & real_row.repeat_interleave(s)[:, None]
    slot = torch.where(routable, slot, torch.zeros_like(slot))

    cap = max(1, math.ceil(capacity_factor * top_k * logical_t
                           / num_experts))

    # GShard priority: flatten k-major; unroutable assignments sort last
    fslot = slot.T.reshape(-1)                              # (k*t,)
    skey = torch.where(routable.T.reshape(-1), fslot,
                       torch.full_like(fslot, n_slots))
    ftok = ar_t.repeat(top_k)
    forder = torch.argsort(skey, stable=True)
    ssl = skey[forder]
    stok = ftok[forder]
    sw = top_w.T.reshape(-1)[forder]
    counts = _bincount(ssl, n_slots + 1)[:n_slots]
    starts = torch.cat([torch.zeros(1, dtype=counts.dtype, device=dev),
                        torch.cumsum(counts, 0)[:-1]])
    mclip = ssl.clamp(0, n_slots - 1)
    pos = torch.arange(t * top_k, device=dev) - starts[mclip]

    # global GShard rank: prior-k totals everywhere + same-k counts of
    # earlier shards + local position within (k, slot); the per-(k, slot)
    # count tables are all-gathered over ('data', 'ep'), in shard order
    cnt_km = torch.stack([
        _bincount(torch.where(rt, sl, torch.full_like(sl, n_slots)),
                  n_slots + 1)[:n_slots]
        for sl, rt in zip(slot.T, routable.T)])             # (k, S)
    allc = _gather(mesh, cnt_km, "shard")                   # (sh, k, S)
    tot = allc.sum(0)
    prek = torch.cumsum(tot, 0) - tot
    before = (allc * (torch.arange(n_shards, device=dev)[:, None, None]
                      < me)).sum(0)
    prelk = torch.cumsum(cnt_km, 0) - cnt_km
    sk = ar_k.repeat_interleave(t)[forder]
    gpos = pos + (prek + before - prelk)[sk, mclip]
    keep = (gpos < cap) & (ssl < n_slots)

    # send buffers: destination rank = slot // sd_, rows [m*cap, (m+1)*cap)
    # of a rank's block belong to its local slot m; every dropped or
    # unroutable assignment writes the one trash row, sliced off below
    dst = (ssl // sd_).clamp(0, ep - 1)
    lpos = torch.where(keep, (ssl % sd_) * cap + pos.clamp(0, cap - 1),
                       torch.full_like(pos, sd_ * cap))
    send = torch.zeros((ep, sd_ * cap + 1, d), dtype=x.dtype, device=dev)
    send[dst, lpos] = torch.where(keep[:, None], xf[stok],
                                  torch.zeros((), dtype=x.dtype, device=dev))
    recv = _a2a(mesh, send[:, :sd_ * cap])     # the scatter all-to-all

    # local grouped FFN over this rank's slots; the kept per-slot counts
    # (all-to-all'd) mark each slot's occupied extent for the kernels
    buf = recv.reshape(ep, sd_, cap, d).transpose(0, 1) \
        .reshape(sd_, ep * cap, d)
    kc = _bincount(torch.where(keep, ssl, torch.full_like(ssl, n_slots)),
                   n_slots + 1)[:n_slots].reshape(ep, sd_)
    recv_cnt = _a2a(mesh, kc)                  # (src, sd_)
    src = torch.arange(ep, device=dev)[:, None]
    gs = torch.where(recv_cnt > 0, src * cap + recv_cnt,
                     torch.zeros_like(recv_cnt)).amax(dim=0).to(torch.int32)
    if quantized:
        # at most t*k assignments: no more slots than that have rows
        out = KOPS.expert_ffn_quant_impl(
            buf, bank["w_gate"], bank["w_gate_scale"], bank["w_up"],
            bank["w_up_scale"], bank["w_down"], bank["w_down_scale"], gs,
            impl, max_active=min(sd_, t * top_k))
    else:
        out = KOPS.expert_ffn_impl(buf, bank["w_gate"], bank["w_up"],
                                   bank["w_down"], gs, impl)
    # F is split over 'tp': sum the partial products in float32
    out = _reduce(mesh, out.float(), "tp")
    y = out.reshape(sd_, ep, cap, d).transpose(0, 1) \
        .reshape(ep, sd_ * cap, d)
    back = _a2a(mesh, y.to(x.dtype))           # the gather all-to-all

    # weighted combine at the source
    contrib = back[dst, lpos.clamp(0, sd_ * cap - 1)].float()
    contrib = contrib * torch.where(keep, sw, torch.zeros_like(sw))[:, None]
    comb = torch.zeros((t, d), dtype=torch.float32, device=dev) \
        .index_add_(0, stok, contrib)

    mask_flat = token_mask.reshape(-1).to(torch.int32)      # (t,)
    loads = torch.zeros(num_experts, dtype=torch.int32, device=dev) \
        .index_add_(0, top_i.reshape(-1),
                    mask_flat.repeat_interleave(top_k))
    # dropped = routed assignments of ACTIVE tokens that were not kept
    active = mask_flat[stok]
    dropped = (top_k * mask_flat.sum() - (keep * active).sum()).float()
    loads = _reduce(mesh, loads, "shard")
    dropped = _reduce(mesh, dropped, "shard")
    y = _gather(mesh, comb.reshape(b, s, d).to(x.dtype), "shard")
    return y.reshape(shape), {
        "expert_load": loads, "dropped": dropped,
        "aux_loss": torch.zeros((), dtype=torch.float32, device=dev)}


# ----------------------------------------------- serving hot-path hookup


@dataclass(frozen=True)
class EPContext:
    """Static context for running MoE sublayers through the EP slot data
    plane in the decode step: only the slot tables/weights in the
    per-layer ``ep_state`` change between iterations. `mesh` is the
    plane's ``launch.mesh.ServingMesh`` (None: one process); `pad_rows`
    are trailing batch rows that are padding artifacts (the engine pads
    batches to a multiple of data*ep; they are capacity-neutral)."""
    slots_per_device: int          # PHYSICAL slots per EP rank
    capacity_factor: float
    pad_rows: int = 0
    mesh: object = None

    def __post_init__(self):
        check_mesh(self.mesh)


def moe_ep_ffn(moe_params, h, state, ctx: EPContext, cfg,
               token_mask=None):
    """One MoE sublayer through ``moe_ep_layer`` with the runtime's live
    slot tables/weights — the replacement for ``models.moe.dispatch_moe``
    when the expert runtime is on. `state`: {'expert_slots' (E, R_cap),
    'nrep' (E,), the slot bank leaves} for THIS layer (one period), from
    ``serving.expert_runtime.ExpertRuntime.ep_state``."""
    slot_w = {k: state[k] for k in _WKEYS if k in state}
    tables = {"expert_slots": state["expert_slots"], "nrep": state["nrep"]}
    return moe_ep_layer(
        h, moe_params["router"]["w_gate"], slot_w, tables,
        num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
        slots_per_device=ctx.slots_per_device,
        capacity_factor=ctx.capacity_factor, act=cfg.act, impl=cfg.impl,
        token_mask=token_mask, pad_rows=ctx.pad_rows, mesh=ctx.mesh)
