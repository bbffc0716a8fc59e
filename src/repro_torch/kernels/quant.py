"""Int8 expert-weight quantization for serverless slot banks.

Format (the ``cfg.moe.slot_dtype = "int8"`` storage layout, the same as
the reference package's ``kernels/quant.py``):

  * symmetric, per-expert-ROW scales — for a bank leaf of shape
    (..., R, C) every row r (the contraction index of the grouped
    matmul) gets one float32 scale ``s = max(|w[..., r, :]|) / 127``
    (1.0 for an all-zero row) and is stored as ``round(w / s)`` in int8,
    clipped to [-127, 127]; ``w ≈ q.float() * s[..., None]``.
  * a quantized bank dict carries each original key ``k`` as the int8
    values plus ``k + "_scale"`` as the (…, R) float32 scale vector —
    w_gate / w_up (E, D, F) scale over D, w_down (E, F, D) over F, so
    the scale always sits on the matmul contraction axis and the
    dequantizing kernels (``csrc/moe_gmm_q.cu``) apply it inside their
    tile loop, never building a float bank in device memory.

The arithmetic is the reference's, in float32: ``amax / 127``, then
``round(w / s)`` with round-half-to-even (``torch.round``, as
``jnp.round``), then the clip — so values and scales equal the
reference's bit for bit, for float32 and bfloat16 inputs.

Byte footprint per SwiGLU expert: ``3*D*F`` int8 values plus
``(2*D + F)`` float32 scales — ``core.costmodel.param_bytes``.
"""
from __future__ import annotations

import torch

SCALE_SUFFIX = "_scale"


def is_quantized(bank: dict) -> bool:
    """True when `bank` carries int8 values + per-row scale vectors."""
    return any(k.endswith(SCALE_SUFFIX) for k in bank)


def quantize_rows(w):
    """(..., R, C) float -> (int8 values (..., R, C), float32 scales
    (..., R)). Symmetric per row: s_r = max(|w[..., r, :]|)/127 (1.0 for
    all-zero rows, so padding rows stay exactly zero), q = round(w / s)
    in [-127, 127]."""
    w = w.float()
    amax = w.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(w / scale[..., None])
    return q.clamp_(-127, 127).to(torch.int8), scale


def dequantize_rows(q, scale):
    """Inverse of ``quantize_rows`` (up to int8 rounding)."""
    return q.float() * scale[..., None]


def quantize_expert_bank(bank: dict) -> dict:
    """Quantize every leaf of an expert weight bank: each key ``k``
    (..., R, C) becomes int8 values under ``k`` plus float32 per-row
    scales under ``k + '_scale'``. A bank that already carries scale keys
    is returned unchanged."""
    if is_quantized(bank):
        return bank
    out = {}
    for k, w in bank.items():
        q, s = quantize_rows(w)
        out[k] = q
        out[k + SCALE_SUFFIX] = s
    return out


def dequantize_expert_bank(bank: dict) -> dict:
    """Quantized bank dict -> plain float32 bank (scale keys folded in)."""
    if not is_quantized(bank):
        return bank
    return {k: dequantize_rows(w, bank[k + SCALE_SUFFIX])
            for k, w in bank.items() if not k.endswith(SCALE_SUFFIX)}


def weight_keys(bank: dict) -> list:
    """The value keys of a (possibly quantized) bank, scale keys
    excluded, in a stable order."""
    return sorted(k for k in bank if not k.endswith(SCALE_SUFFIX))
