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
import threading

IMPLS = ("auto", "cuda", "ref")


class LaunchCounts(dict):
    """Launches by name, bumped from any thread: the gateway steps each
    replica on a thread of its own, and ``+= 1`` on a dict entry is a
    read-modify-write that two threads can interleave and lose a count.
    ``bump`` and ``reset_launch_counts`` hold one lock; reads are plain
    dict reads."""
    _lock = threading.Lock()

    def bump(self, name: str) -> None:
        with self._lock:
            self[name] += 1


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset (each wrapper
    adds one where it launches its kernel, nowhere else)."""
    from repro_torch.kernels import decode_attn, moe_gmm
    return {**moe_gmm.LAUNCHES, **decode_attn.LAUNCHES}


def reset_launch_counts() -> None:
    """Zero every wrapper's launches, and the int8 kernels' launches by
    path (``moe_gmm.QUANT_PATH_LAUNCHES``)."""
    from repro_torch.kernels import decode_attn, moe_gmm
    with LaunchCounts._lock:
        for counts in (moe_gmm.LAUNCHES, decode_attn.LAUNCHES,
                       *moe_gmm.QUANT_PATH_LAUNCHES.values()):
            for name in counts:
                counts[name] = 0
