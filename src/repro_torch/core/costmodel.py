"""Latency / cost model — paper §3.3, with coefficients derived from TPU
v5e roofline constants instead of A6000 measurements (DESIGN.md §2).

  T_layer = max_{e,r} (alpha * W_{l,e,r}) + 2 * max_g (beta * W_g) + T_misc
  C       = sum over iterations/layers of  T_layer * memory_in_use

alpha — seconds per routed token of expert FFN compute,
beta  — seconds per token of all-to-all scatter (= gather) traffic.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.plan import LayerPlan


@dataclass(frozen=True)
class Hardware:
    """TPU v5e chip (per system-prompt constants)."""
    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bw: float = 819e9               # bytes/s
    ici_bw: float = 50e9                # bytes/s per link
    bytes_per_elem: int = 2             # bf16
    hbm_bytes: float = 16e9             # v5e HBM capacity
    # serverless lifecycle (DESIGN.md: replica materialisation over ICI)
    instance_startup_s: float = 5e-3    # program/slot activation
    price_per_gb_s: float = 1.0         # normalised $ per GB-second


V5E = Hardware()

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def param_bytes(cfg) -> float:
    """M_e — bytes of ONE expert replica as actually stored in a slot
    bank, derived from the config (never hardcoded to a dtype):

      slot_dtype 'fp32' — native parameter dtype (``cfg.dtype``):
                          n_mats * d * f * itemsize
      slot_dtype 'int8' — int8 values + one fp32 scale per expert row
                          (reference repro/kernels/quant.py): n_mats * d * f bytes
                          plus 4 bytes per contraction row (w_gate/w_up
                          scale over D, w_down over F)

    This is THE byte base shared by the analytic side (cold-start
    latency, GB-s residency billing, ``derive_coeffs``), the executing
    ``ExpertRuntime``'s per-slot transfer metering, and the footprint
    table (benchmarks/table2_footprints.py) — deriving it in one place
    is what keeps the runtime-vs-analytic meters exactly equal."""
    d = cfg.d_model
    f = cfg.moe.d_ff if cfg.is_moe else cfg.d_ff
    n_mats = 3 if cfg.act == "swiglu" else 2
    slot_dtype = getattr(cfg.moe, "slot_dtype", "fp32") if cfg.is_moe \
        else "fp32"
    if slot_dtype == "int8":
        # scale rows: D per up-projection matrix (w_gate/w_up), F for
        # the down projection
        scale_rows = (n_mats - 1) * d + f
        return float(n_mats * d * f + scale_rows * 4)
    if slot_dtype != "fp32":
        raise ValueError(f"unknown slot_dtype {slot_dtype!r}; expected "
                         "one of ('fp32', 'int8')")
    return float(n_mats * d * f * _DTYPE_BYTES.get(cfg.dtype, 2))


@dataclass(frozen=True)
class LayerCostCoeffs:
    alpha: float       # s / token of expert compute
    beta: float        # s / token of one all-to-all round
    t_misc: float      # non-MoE per-layer time (attention etc.)
    expert_bytes: float  # M_e — memory footprint of one expert replica


def derive_coeffs(cfg, hw: Hardware = V5E, *, batch_tokens: int = 4096
                  ) -> LayerCostCoeffs:
    """Derive the paper's alpha/beta/M_e from a model config + chip specs.

    Expert FFN: 3 matmuls (swiglu) => 6*d*f FLOP per routed token, but at
    serving batch sizes the expert is memory-bandwidth bound when its
    weight bytes exceed arithmetic reuse — take max(compute, hbm) time.
    ``expert_bytes`` comes from ``param_bytes(cfg)``: it honours the
    model dtype AND the slot-bank storage format (``cfg.moe.slot_dtype``)
    so quantized slot banks bill their real, smaller footprint.
    """
    d = cfg.d_model
    f = cfg.moe.d_ff if cfg.is_moe else cfg.d_ff
    n_mats = 3 if cfg.act == "swiglu" else 2
    expert_bytes = param_bytes(cfg)
    flops_per_tok = 2 * n_mats * d * f
    alpha_compute = flops_per_tok / hw.peak_flops
    # per-token share of streaming the expert weights once per iteration,
    # amortised over the tokens it processes in a typical batch
    alpha_mem = expert_bytes / hw.hbm_bw / max(batch_tokens, 1)
    alpha = max(alpha_compute, alpha_mem)
    beta = d * hw.bytes_per_elem / hw.ici_bw
    # non-MoE time: attention qkvo (~4*d*d*2 flops/token) + norms, roughly
    t_misc_per_tok = (8 * d * d) / hw.peak_flops
    t_misc = t_misc_per_tok * batch_tokens / 8   # spread over DP devices
    return LayerCostCoeffs(alpha=alpha, beta=beta, t_misc=t_misc,
                           expert_bytes=float(expert_bytes))


def layer_forward_time(plan: LayerPlan, loads: np.ndarray,
                       coeffs: LayerCostCoeffs) -> float:
    """T for one MoE layer under a plan (paper §3.3).

    Divergence from the paper's literal formula (documented in DESIGN.md
    §2): the expert-compute straggler term uses the per-DEVICE aggregated
    load max_g(alpha * W_g) instead of max_{e,r}(alpha * W_{l,e,r}) —
    co-located replicas execute sequentially on one chip, so the device
    is the true straggler unit. On single-replica-per-device plans the two
    coincide; the paper's measured alpha absorbs this on their testbed.
    """
    w_g = plan.per_device_load(loads)
    t_expert = coeffs.alpha * (w_g.max() if w_g.size else 0.0)
    t_comm = 2.0 * coeffs.beta * (w_g.max() if w_g.size else 0.0)
    return t_expert + t_comm + coeffs.t_misc


def oracle_forward_time(loads: np.ndarray, num_devices: int,
                        coeffs: LayerCostCoeffs) -> float:
    """Perfect (lossy) balance: every device gets exactly W/G tokens."""
    w = float(np.sum(loads)) / num_devices
    return coeffs.alpha * w + 2.0 * coeffs.beta * w + coeffs.t_misc


def iteration_cost(forward_time: float, resident_bytes: float,
                   hw: Hardware = V5E) -> float:
    """C contribution of one (iteration, layer): time x GB in use."""
    return forward_time * (resident_bytes / 1e9) * hw.price_per_gb_s


def kv_bytes_per_block(cfg, block: int) -> int:
    """Bytes ONE paged-KV pool block occupies across the whole cache
    tree: every attention sublayer stores k + v ``(block, kv_heads,
    head_dim)`` tiles in the model dtype plus an int32 position lane.
    Must equal ``serving.kv.PagedKVCache.block_bytes`` exactly — the
    tests cross-check the analytic form against the live pytree."""
    from repro_torch.models.transformer import layer_pattern
    pattern = layer_pattern(cfg)
    periods = cfg.num_layers // len(pattern)
    n_attn = periods * sum(s.mixer == "attn" for s in pattern)
    itemsize = _DTYPE_BYTES.get(cfg.dtype, 2)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return n_attn * block * (2 * kvh * hd * itemsize + 4)


def misc_memory_bytes(cfg) -> float:
    """M_misc — non-expert memory (attention + router + KV, rough per
    model), billed identically for every strategy."""
    d = cfg.d_model
    return cfg.num_layers * 4 * d * d * 2 + cfg.vocab_size * d * 4
