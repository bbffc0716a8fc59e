"""Backend selection for the serving hot spots — the single dispatch
point of the ``impl`` knob that ``configs.base.ModelConfig.impl``
threads through the model and the serving engine:

    auto -> the CUDA kernel for CUDA tensors, the plain version for CPU
            tensors
    cuda -> the CUDA kernel; CPU tensors raise
    ref  -> the plain PyTorch version on any device

The reference package's values (``pallas``, ``pallas_interpret``) are
rejected. A call that would launch a kernel under grad mode on an input
that requires grad raises ``NotImplementedError`` (no kernel has a
backward); ``auto`` on CPU tensors is the plain path, which has one.
"""
from __future__ import annotations

from repro_torch.kernels import (IMPLS, decode_attn, moe_gmm, ref,
                                 refuse_autograd)


def resolve_impl(impl: str = "auto") -> str:
    """Validate the backend knob (device-independent)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    return impl


def use_kernel(impl: str, x) -> bool:
    """Whether `impl` runs the CUDA kernel on tensor `x`'s device."""
    impl = resolve_impl(impl)
    if impl == "ref":
        return False
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {x.device}")
    return x.is_cuda


def _use_kernel(name: str, impl: str, x, *tensors) -> bool:
    """``use_kernel`` for kernel `name`. At impl='cuda' it first refuses
    `x` and `tensors` if they require grad, before the device check, so
    CPU tensors show the refusal too; on CUDA tensors the kernel's
    wrapper refuses them where it launches."""
    if resolve_impl(impl) == "cuda":
        refuse_autograd(name, x, *tensors)
    return use_kernel(impl, x)


def expert_ffn_impl(x, w_gate, w_up, w_down, group_sizes, impl: str):
    """Capacity-layout SwiGLU expert FFN: (E, C, D) -> (E, C, D), the
    fused gate/up kernel then the grouped down-projection kernel."""
    if not _use_kernel("fused_gate_up", impl, x, w_gate, w_up, w_down):
        return ref.expert_ffn_ref(x, w_gate, w_up, w_down, group_sizes)
    x = x.contiguous()
    h = moe_gmm.fused_gate_up(x, w_gate, w_up, group_sizes)
    return moe_gmm.gmm(h, w_down, group_sizes)


def expert_ffn_quant_impl(x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s,
                          group_sizes, impl: str, max_active: int = 0):
    """The SwiGLU expert FFN over an int8 slot bank + per-row float32
    scales (``kernels.quant`` layout), dequantized inside the kernels:
    (E, C, D) -> (E, C, D). The kernels return x's dtype, the plain
    version float32 (as the reference's oracle). `max_active` (0:
    unknown) bounds how many experts have rows (the kernels size their
    work split by it)."""
    if not _use_kernel("fused_gate_up_quant", impl, x, wg_q, wg_s,
                      wu_q, wu_s, wd_q, wd_s):
        return ref.expert_ffn_ref_quant(x, wg_q, wg_s, wu_q, wu_s, wd_q,
                                        wd_s, group_sizes)
    x = x.contiguous()
    h = moe_gmm.fused_gate_up_quant(x, wg_q, wg_s, wu_q, wu_s, group_sizes,
                                    max_active)
    return moe_gmm.gmm_quant(h, wd_q, wd_s, group_sizes, max_active)


def gmm_impl(x, w, group_sizes, impl: str):
    """Grouped matmul (E, C, D) x (E, D, F) -> (E, C, F)."""
    if not _use_kernel("gmm", impl, x, w):
        return ref.gmm_ref(x, w, group_sizes)
    return moe_gmm.gmm(x.contiguous(), w, group_sizes)


def gmm_quant_impl(x, wq, scale, group_sizes, impl: str):
    """Dequantizing grouped matmul: (E, C, D) x int8 (E, D, F) with
    per-row scales (E, D) -> (E, C, F)."""
    if not _use_kernel("gmm_quant", impl, x, wq, scale):
        return ref.gmm_ref_quant(x, wq, scale, group_sizes)
    return moe_gmm.gmm_quant(x.contiguous(), wq, scale, group_sizes)


def decode_attention_impl(q, k, v, kv_pos, kv_len, q_pos, *, window: int,
                          impl: str, return_stats: bool = False):
    """Single-token decode attention against a ring-buffered KV cache:
    q (B, H, hd); k/v (B, S, KV, hd); kv_pos (B, S); kv_len/q_pos (B,).
    Returns (B, H, hd), or with `return_stats` (float32 out, m, l) of
    ``kernels.decode_attn``."""
    if not _use_kernel("decode_attention", impl, q, k, v):
        return decode_attn.decode_attention_ref(
            q, k, v, kv_pos, kv_len, q_pos, window=window,
            return_stats=return_stats)
    return decode_attn.decode_attention(q.contiguous(), k, v, kv_pos,
                                        kv_len, q_pos, window=window,
                                        return_stats=return_stats)


def decode_attention_paged_impl(q, k, v, kv_pos, block_tables, kv_len,
                                q_pos, *, window: int, impl: str):
    """Single-token decode attention against the paged GLOBAL block pool
    through per-row block tables: q (B, H, hd); k/v (NB, blk, KV, hd);
    kv_pos (NB, blk); block_tables (B, nbs) int32; kv_len/q_pos (B,).
    Returns (B, H, hd)."""
    if not _use_kernel("decode_attention_paged", impl, q, k, v):
        return decode_attn.decode_attention_paged_ref(
            q, k, v, kv_pos, block_tables, kv_len, q_pos, window=window)
    return decode_attn.decode_attention_paged(
        q.contiguous(), k, v, kv_pos, block_tables, kv_len, q_pos,
        window=window)
