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


def topk_gating_ref(logits, top_k: int):
    """Router: softmax-over-topk weights + indices (ties: lower index
    first, as ``jax.lax.top_k``)."""
    w, i = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(w[..., :top_k], dim=-1), i[..., :top_k]
