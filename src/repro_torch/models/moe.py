"""Mixture-of-Experts layer: GShard-style grouped capacity dispatch.

``dispatch_moe`` routes tokens to experts with a per-expert capacity,
runs the grouped expert FFN (SwiGLU or gelu) over the capacity layout
through the ``impl`` kernel backend (``kernels.ops``), and combines. The
router also emits the per-expert token-load histogram that feeds the
MoEless control plane (paper §4).

Under a data-parallel training step (``dispatch_moe(data_mesh=)``), each
rank dispatches its own dispatch groups of the microbatch, and the
metrics are the whole microbatch's, as the reference's are over all its
tokens:
the expert loads, the drops and the aux loss's f (top-1 shares) are
summed over the data group, and its p (mean router probabilities) by a
differentiable sum, since E * sum(f * p) is not linear in a rank's
tokens.

Under tensor parallelism (``dispatch_moe(model_mesh=)``) the expert bank
is this rank's F-slices, the reference's layout on a mesh with model >
1: w_gate and w_up split on their output F, w_down on its input F. The
rank runs the gate/up product on its F-columns and the down product on
its F-rows, which gives a partial (E, C, D) sum, summed over the model
group in float32 and rounded once to the model's dtype before the
combine (``experts_ffn(mesh=)``): where the one-process path rounds the
expert outputs. Summed after the combine, on (g, t, D), the bytes would
be fewer, but the outputs would round at another point: at mixtral's
widths in bf16 the (1, 2) loss then sat 1.0e-4 off the one-process
loss on an H100 (``chip_smoke.py`` phase 13's cell). The sum over F is
taken in two parts added across ranks, in another order than the
one-process product's. The
dispatch input passes ``copy_to_model``, whose backward sums its
partial gradients. Routing, capacities, loads, drops and the aux loss
are computed alike on every model rank from the replicated activations
and the gathered router; they are not summed over "model".

Under the expert-parallel layout (``params_shardings(ep_experts=True)``:
``dispatch_moe(model_mesh=)`` given a bank of fewer than `num_experts`
experts) the bank is this rank's E/model whole experts. Routing and the
dispatch buffer are computed as above, alike on every model rank; the
rank takes its experts' rows of
the buffer (and of the group sizes), runs the kernels on them with no
mesh, and the (E/model, N, D) outputs are all-gathered over the model
group in group-rank order (``tensor_parallel.gather_experts``) before
the combine, which then runs as in one process. Every expert's rows are
computed whole, as one process computes them, and only concatenated:
nothing is summed across ranks, so the layer gives the one-process
layer's values wherever the kernels compute an expert's rows alike at E
and at E/model experts. The buffer's backward sums the ranks' gradients,
each zero outside its experts' rows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as TP


def router_topk(logits, top_k: int):
    """Returns (weights (T,k) softmax-normalised over the selected experts,
    indices (T,k), full softmax probs (T,E)). Ties resolve lower index
    first, as ``jax.lax.top_k`` does (a stable descending sort;
    ``torch.topk`` promises no order among equals)."""
    lg = logits.float()
    probs = torch.softmax(lg, dim=-1)
    top_w, top_i = torch.sort(lg, dim=-1, descending=True, stable=True)
    top_w = torch.softmax(top_w[..., :top_k], dim=-1)
    return top_w, top_i[..., :top_k], probs


def expert_loads(top_i, num_experts: int, token_mask=None):
    """Token count per expert — the paper's W_{l,e} (§3.3). `token_mask`
    (T,) excludes tokens (e.g. inactive continuous-batching slots)."""
    oh = F.one_hot(top_i.long(), num_experts).to(torch.int32)   # (T,k,E)
    if token_mask is not None:
        oh = oh * token_mask.reshape(-1, 1, 1).to(torch.int32)
    return oh.sum(dim=(0, 1), dtype=torch.int32)


def _data_parallel_metrics(mesh, probs, top_i, load, dropped,
                           num_experts: int):
    """(expert_load, aux_loss, dropped) over the data group: one sum of
    the top-1 counts, the loads and the drops, one differentiable sum of
    the router probabilities."""
    t = probs.shape[0] * mesh.shape["data"]
    sel = F.one_hot(top_i[..., 0].long(), num_experts).float().sum(dim=0)
    packed = mesh.all_reduce(torch.cat(
        [sel, load.float(), torch.as_tensor(dropped, dtype=torch.float32,
                                            device=sel.device).reshape(1)]),
        "data")
    p = mesh.all_reduce_autograd(probs.sum(dim=0), "data")
    aux = num_experts * torch.sum((packed[:num_experts] / t) * (p / t))
    return (packed[num_experts:2 * num_experts].to(torch.int32), aux,
            packed[-1])


def load_balance_loss(probs, top_i, num_experts: int):
    """Switch-Transformer auxiliary loss: E * sum_e f_e * p_e."""
    sel = F.one_hot(top_i[..., 0].long(), num_experts).float()
    f = sel.mean(dim=0)
    p = probs.mean(dim=0)
    return num_experts * torch.sum(f * p)


def experts_ffn(p, x, act: str, *, group_sizes=None, impl: str = "ref",
                mesh=None):
    """x: (E, N, D) -> (E, N, D), grouped per-expert FFN through the
    kernels.ops backend selector: SwiGLU (the fused gate/up kernel, then
    the down-projection ``gmm``) or gelu (``gmm`` up, gelu in the tanh
    approximation, ``gmm`` down). `group_sizes` (E,) int32 marks rows
    beyond it as padding (outputs zeroed; the kernels also skip whole row
    tiles there). None => all rows active. `p` is a bank in the model's
    dtype, or an int8 bank with per-row float32 ``*_scale`` companions
    (``kernels.quant`` layout), which runs the dequantizing kernels.

    With `mesh` (model > 1) `p` is this rank's F-slices of a bank in the
    model's dtype, and the down product's partial is summed over the
    model group in float32, then rounded once to x's dtype. The kernels
    write the partial in x's dtype; the plain path takes it in float32
    (exact products, float32 sums), so that the whole sum rounds once,
    as the one-process product's does."""
    from repro_torch.kernels import ops as OPS
    if group_sizes is None:
        group_sizes = torch.full((x.shape[0],), x.shape[1],
                                 dtype=torch.int32, device=x.device)
    if mesh is not None:
        if OPS.use_kernel(impl, x):
            part = experts_ffn(p, x, act, group_sizes=group_sizes,
                               impl=impl)
        else:
            if act == "swiglu":
                h = F.silu(torch.bmm(x, p["w_gate"])) \
                    * torch.bmm(x, p["w_up"])
            else:
                h = F.gelu(torch.bmm(x, p["w_up"]), approximate="tanh")
            part = torch.bmm(h.float(), p["w_down"].float())
            rows = torch.arange(x.shape[1], device=x.device)[None] \
                < group_sizes[:, None]
            part = torch.where(rows[..., None], part, 0.0)
        return TP.reduce_partial(part, mesh, x.dtype)
    if "w_up_scale" in p:
        # the dequantizing kernels return x's dtype, their plain
        # versions float32 (as the reference's oracle)
        if act == "swiglu":
            y = OPS.expert_ffn_quant_impl(
                x, p["w_gate"], p["w_gate_scale"], p["w_up"],
                p["w_up_scale"], p["w_down"], p["w_down_scale"],
                group_sizes, impl)
        else:
            h = F.gelu(OPS.gmm_quant_impl(x, p["w_up"], p["w_up_scale"],
                                          group_sizes, impl),
                       approximate="tanh")
            y = OPS.gmm_quant_impl(h, p["w_down"], p["w_down_scale"],
                                   group_sizes, impl)
        return y.to(x.dtype)
    if act == "swiglu":
        return OPS.expert_ffn_impl(x, p["w_gate"], p["w_up"], p["w_down"],
                                   group_sizes, impl)
    h = F.gelu(OPS.gmm_impl(x, p["w_up"], group_sizes, impl),
               approximate="tanh")
    return OPS.gmm_impl(h, p["w_down"], group_sizes, impl)


def dispatch_moe(p, x, *, top_k: int, num_experts: int,
                 capacity_factor: float, act: str = "swiglu",
                 groups: int = 1, token_mask=None, impl: str = "ref",
                 data_mesh=None, model_mesh=None):
    """Grouped capacity dispatch (GShard).

    x: (B, S, D). Tokens are flattened and split into `groups` dispatch
    groups; capacity C = ceil(cf * k * Tg / E) per group, with priority
    to lower k-slots first (all k=0 assignments before any k=1), then
    token order. `token_mask` (B, S) marks tokens whose routing is
    EXCLUDED from the expert-load and dropped metrics (inactive
    continuous-batching slots) — compute is unaffected: inactive slots
    still occupy capacity. Returns (y, metrics) with the expert-load
    histogram, the dropped-assignment count, the aux loss and the router
    logits. With `data_mesh` (a ``launch.mesh.ProcessMesh``) `x` is this
    rank's share of a data-parallel microbatch, and the expert loads,
    the drops and the aux loss are the whole microbatch's; with
    `model_mesh` the expert bank is a column/row pair over its model
    group or, where it holds fewer than `num_experts` experts, this
    rank's whole experts (module docstring).
    """
    if model_mesh is not None and "w_up_scale" in p["experts"]:
        raise NotImplementedError(
            "int8 expert banks at model > 1 wait in ROADMAP parked (c)4")
    b, s, d = x.shape
    t = b * s
    groups = max(1, min(groups, t))
    while t % groups:
        groups -= 1
    tg = t // groups
    cap = max(1, math.ceil(capacity_factor * top_k * tg / num_experts))
    xg = x.reshape(groups, tg, d)

    logits = torch.einsum("gtd,de->gte", xg, p["router"]["w_gate"])
    top_w, top_i, probs = router_topk(logits.reshape(t, num_experts), top_k)
    top_w = top_w.reshape(groups, tg, top_k)
    top_i = top_i.reshape(groups, tg, top_k)

    # position-in-expert with priority to lower k-slots (GShard order)
    sel = F.one_hot(top_i.long(), num_experts).float()        # (g,t,k,e)
    sel_flat = sel.permute(0, 2, 1, 3).reshape(groups, top_k * tg,
                                               num_experts)
    pos = torch.cumsum(sel_flat, dim=1) - 1.0
    pos = pos.reshape(groups, top_k, tg, num_experts).permute(0, 2, 1, 3)
    keep = (pos < cap) & (sel > 0)
    pos = torch.clamp(pos, 0, cap - 1).long()

    disp = F.one_hot(pos, cap).to(x.dtype) \
        * keep[..., None].to(x.dtype)                         # (g,t,k,e,c)
    disp_te = disp.sum(dim=2)                                 # (g,t,e,c)
    # combine weights are cast to x.dtype before the combine, as in the
    # reference (in bf16 that rounding matters)
    comb = (disp * top_w[..., None, None].to(x.dtype)).sum(dim=2)

    expert_in = torch.einsum("gtec,gtd->egcd", disp_te, xg)
    if model_mesh is not None:
        expert_in = TP.copy_to_model(expert_in, model_mesh)
    # capacity-layout group sizes for the kernels: with one dispatch
    # group the kept rows of every expert form a contiguous prefix
    # (GShard cumsum positions), so the kernels can skip/mask the tail;
    # with several groups the prefixes interleave, so all rows stay
    # active (unused rows are zero vectors -> FFN output is zero)
    if groups == 1:
        gs = keep.sum(dim=(1, 2))[0].to(torch.int32)            # (E,)
    else:
        gs = torch.full((num_experts,), groups * cap, dtype=torch.int32,
                        device=x.device)
    expert_in = expert_in.reshape(num_experts, groups * cap, d)
    n = p["experts"]["w_down"].shape[0]
    if model_mesh is not None and n != num_experts:
        # this rank's experts: rows [r E/m, (r+1) E/m) of the buffer
        lo = model_mesh.index("model") * n
        expert_out = TP.gather_experts(experts_ffn(
            p["experts"], expert_in[lo:lo + n], act,
            group_sizes=gs[lo:lo + n], impl=impl), model_mesh)
    else:
        expert_out = experts_ffn(p["experts"], expert_in, act,
                                 group_sizes=gs, impl=impl, mesh=model_mesh)
    expert_out = expert_out.reshape(num_experts, groups, cap, d)
    y = torch.einsum("gtec,egcd->gtd", comb, expert_out)

    # dropped = routed assignments of ACTIVE tokens that overflowed
    # capacity; inactive slots occupy capacity but are not counted
    kept_per_tok = keep.float().sum(dim=(2, 3))                # (g, tg)
    if token_mask is None:
        dropped = float(top_k * t) - kept_per_tok.sum()
    else:
        am = token_mask.reshape(groups, tg).float()
        dropped = top_k * am.sum() - (kept_per_tok * am).sum()
    load = expert_loads(top_i.reshape(t, top_k), num_experts,
                        None if token_mask is None else token_mask.reshape(t))
    if data_mesh is None or data_mesh.shape["data"] == 1:
        aux = load_balance_loss(probs, top_i.reshape(t, top_k), num_experts)
    else:
        load, aux, dropped = _data_parallel_metrics(
            data_mesh, probs, top_i.reshape(t, top_k), load, dropped,
            num_experts)
    metrics = {
        "expert_load": load,
        "aux_loss": aux,
        "dropped": dropped,
        "router_logits": logits.reshape(t, num_experts),
    }
    return y.reshape(b, s, d), metrics
