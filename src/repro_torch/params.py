"""Bridge from the reference package's parameters to the port's tensors.

The reference builds its parameter pytree with JAX; a caller that has
both packages converts it to numpy first (``jax.tree.map(np.asarray,
params)``) and hands the numpy tree here — this module itself never
imports JAX. The structure is kept as it is: dicts stay dicts, the
per-pattern ``layers`` list stays a list, and every layer leaf keeps its
stacked leading ``num_periods`` axis.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device):
    a = np.array(a, copy=True)     # np.asarray of a JAX array is read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: reinterpret bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_jax(tree, device="cpu"):
    """Numpy parameter tree (converted from the reference's pytree) ->
    the same tree of torch tensors on `device`."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax(v, device) for v in tree)
    return _leaf(tree, device)
