"""Hand-written CUDA kernels for the serving hot spots, their plain
PyTorch versions, and the ``impl`` backend knob.

This module stays light (no build, no CUDA) so CLI flag definitions can
name the backends; resolution and dispatch live in
``repro_torch.kernels.ops``:

    auto -> the CUDA kernel for CUDA tensors, the plain version for CPU
            tensors
    cuda -> the CUDA kernel; CPU tensors raise
    ref  -> the plain PyTorch version on any device
"""
IMPLS = ("auto", "cuda", "ref")


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset (each wrapper
    adds one where it launches its kernel, nowhere else)."""
    from repro_torch.kernels import decode_attn, moe_gmm
    return {**moe_gmm.LAUNCHES, **decode_attn.LAUNCHES}


def reset_launch_counts() -> None:
    """Zero every wrapper's launches, and the int8 kernels' launches by
    path (``moe_gmm.QUANT_PATH_LAUNCHES``)."""
    from repro_torch.kernels import decode_attn, moe_gmm
    for counts in (moe_gmm.LAUNCHES, decode_attn.LAUNCHES,
                   *moe_gmm.QUANT_PATH_LAUNCHES.values()):
        for name in counts:
            counts[name] = 0
