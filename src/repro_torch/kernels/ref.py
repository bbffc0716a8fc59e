"""Plain PyTorch oracles for the expert kernels (the CPU path, and what
the CUDA kernels are held against on the card)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _row_mask(y, group_sizes):
    c = y.shape[1]
    mask = torch.arange(c, device=y.device)[None, :] \
        < group_sizes.to(y.device)[:, None]
    return torch.where(mask[..., None], y, torch.zeros((), dtype=y.dtype,
                                                       device=y.device))


def expert_ffn_ref(x, w_gate, w_up, w_down, group_sizes=None):
    """Capacity-layout expert FFN (the MoE hot spot).

    x: (E, C, D); w_gate/w_up: (E, D, F); w_down: (E, F, D).
    group_sizes: (E,) — rows >= group_sizes[e] are padding and must not
    contribute (outputs zeroed there). Returns (E, C, D).
    """
    h = F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up)
    y = torch.bmm(h, w_down)
    if group_sizes is not None:
        y = _row_mask(y, group_sizes)
    return y


def gmm_ref(x, w, group_sizes=None):
    """Batched per-expert matmul: (E, C, D) @ (E, D, F) -> (E, C, F),
    rows beyond group_sizes[e] zeroed."""
    y = torch.bmm(x, w)
    if group_sizes is not None:
        y = _row_mask(y, group_sizes)
    return y


def _deq(q, scale):
    """(..., R, C) int8 + (..., R) float32 -> float32 (kept local so this
    module stays a one-file oracle; the storage format lives in
    ``kernels.quant``)."""
    return q.float() * scale[..., None]


def _active_slots(group_sizes, e):
    """Experts (slots) with at least one row, on the host."""
    if group_sizes is None:
        return list(range(e))
    return [i for i, g in enumerate(group_sizes.tolist()) if g > 0]


def _rows(group_sizes, i, c):
    return c if group_sizes is None else min(int(group_sizes[i]), c)


def gmm_ref_quant(x, wq, scale, group_sizes=None):
    """Dequantizing grouped matmul oracle: (E, C, D) @ deq(E, D, F) ->
    (E, C, F) in float32, rows beyond group_sizes[e] zeroed. `scale`
    (E, D) sits on the contraction axis. One expert at a time, and only
    experts with rows: a slot bank is never dequantized as a whole (at
    mixtral-8x7b's widths one float32 expert matrix is 235 MB)."""
    e, c, _ = x.shape
    y = torch.zeros((e, c, wq.shape[2]), dtype=torch.float32,
                    device=x.device)
    for i in _active_slots(group_sizes, e):
        g = _rows(group_sizes, i, c)
        y[i, :g] = x[i, :g].float() @ _deq(wq[i], scale[i])
    return y


def expert_ffn_ref_quant(x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s,
                         group_sizes=None):
    """Dequantizing capacity-layout expert FFN oracle (int8 bank +
    float32 per-row scales, ``kernels.quant`` layout): float32 throughout
    (as the reference's oracle, whose x is promoted by the float32
    weights), one active expert at a time. Returns (E, C, D) float32."""
    e, c, d = x.shape
    y = torch.zeros((e, c, wd_q.shape[2]), dtype=torch.float32,
                    device=x.device)
    for i in _active_slots(group_sizes, e):
        g = _rows(group_sizes, i, c)
        xe = x[i, :g].float()
        h = F.silu(xe @ _deq(wg_q[i], wg_s[i])) * (xe @ _deq(wu_q[i],
                                                             wu_s[i]))
        y[i, :g] = h @ _deq(wd_q[i], wd_s[i])
    return y


def topk_gating_ref(logits, top_k: int):
    """Router: softmax-over-topk weights + indices (ties: lower index
    first, as ``jax.lax.top_k``)."""
    w, i = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(w[..., :top_k], dim=-1), i[..., :top_k]
