"""The yardstick: NVIDIA's published H100 SXM peaks, and the operations
and bytes each kernel family's work needs, computed from what the
engine handed its controller (the routed loads of every MoE layer) and
from the harness's own request records, never from a kernel's launch
arguments, so that a kernel that is fused or replaced later is read
against the same work."""
from __future__ import annotations

import json
from pathlib import Path

HBM_BYTES_S = 3.35e12            # H100 SXM, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
FAMILIES = Path(__file__).resolve().parent.parent / "families"


def family(name: str) -> list[str]:
    """The kernel names (substrings of the device events' names) that
    make up one family (``perfbench/families/<name>.json``)."""
    return json.loads((FAMILIES / f"{name}.json").read_text())["kernels"]


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: the larger of bytes over the
    HBM rate and operations over the dense peak."""
    return max(nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype])


# ------------------------------------------------------------- one launch


def gmm_bytes_flops(experts: int, rows_per_expert: list, capacity: int,
                    d: int, f: int, fused: bool, elem: int = 2):
    """Bytes and operations one ``fused_gate_up`` (fused) or ``gmm``
    launch's data needs, counted as the kernel table of ``PERF.md``
    counts them: x rows inside their groups, the weights of experts
    with rows (two matrices fused), every output element of the
    (E, C, F) layout, the group sizes."""
    rows = sum(rows_per_expert)
    live = sum(1 for r in rows_per_expert if r > 0)
    n_w = 2 if fused else 1
    nbytes = (rows * d + n_w * live * d * f + experts * capacity * f) \
        * elem + 4 * experts
    return nbytes, 2.0 * n_w * rows * d * f


# ------------------------------------------------------------ a family


def expert_bytes(d: int, f: int, fmt: str) -> float:
    """One SwiGLU expert as served: bf16, or int8 values with their
    float32 row scales (2 D + F)."""
    if fmt == "int8":
        return 3.0 * d * f + 4.0 * (2 * d + f)
    return 3.0 * d * f * 2


def expert_ffn(loads, d: int, f: int, fmt: str):
    """(bytes, operations) of one MoE layer's expert FFN: each expert
    that received rows read once, the rows' activations in and out,
    2 x 3 x D x F operations a routed row."""
    rows = float(sum(loads))
    live = sum(1 for x in loads if x > 0)
    return live * expert_bytes(d, f, fmt) + rows * d * 2 * 2, \
        6.0 * rows * d * f


def decode_attn(contexts, heads: int, kv_heads: int, head_dim: int):
    """(bytes, operations) of one layer's decode attention over rows
    whose live lengths are `contexts` (keys each attends, itself
    included): K and V at those lengths, q and out, bf16."""
    keys = float(sum(contexts))
    n = len(contexts)
    nbytes = 2 * keys * kv_heads * head_dim * 2 + 2 * n * heads * head_dim * 2
    return nbytes, 4.0 * keys * heads * head_dim


# -------------------------------------------------------- model FLOPs


def token_flops(cfg) -> float:
    """Operations of one token through one layer outside the experts'
    FFN and the attention's context: the q/k/v/o projections and the
    router."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    proj = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    return 2.0 * (proj + d * cfg.moe.num_experts)


def context_flops(cfg, keys: float) -> float:
    """Operations of attention's scores and weighted sum over `keys`
    (query, key) pairs in one layer."""
    return 4.0 * keys * cfg.num_heads * cfg.resolved_head_dim


def head_flops(cfg) -> float:
    """The LM head for one position whose logits are used."""
    return 2.0 * cfg.d_model * cfg.vocab_size
