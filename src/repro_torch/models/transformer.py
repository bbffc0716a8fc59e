"""Model assembly: stacked-parameter decoder run as a Python loop over
layer *periods* (the reference scans them with ``lax.scan``).

A "period" is the smallest repeating pattern of sublayers (1 for the
uniform MoE decoders ported so far). Parameters of sublayer j are
stacked over num_periods, exactly as the reference stores them, so the
reference's weights convert leaf for leaf (``repro_torch.params``).

Entry points:
  init_params(cfg, seed, device)             -> params
  init_cache(cfg, params, batch, max_len)    -> cache
  init_paged_cache(cfg, params, num_blocks, block)
                                             -> paged cache
  decode_step(cfg, params, batch, cache, cache_len)
                                             -> (logits, cache, metrics)
  sample_tokens(logits, temperature, top_k, top_p, seed, step)
                                             -> next tokens (B,)
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import prng


@dataclass(frozen=True)
class SubLayer:
    mixer: str          # attn (mamba | mlstm | slstm: later slices)
    ffn: str            # dense | moe | none


def layer_pattern(cfg) -> list[SubLayer]:
    """The repeating sublayer pattern (one period) for a config."""
    if cfg.family in ("ssm", "hybrid") or cfg.ssm is not None \
            or cfg.encdec is not None:
        raise NotImplementedError(
            f"{cfg.name}: recurrent, hybrid and encoder-decoder stacks "
            "arrive with the model-family slice of the PyTorch port")
    if cfg.is_moe and cfg.moe.every_n_layers > 1:
        pm = cfg.moe.every_n_layers
        return [SubLayer("attn", "moe" if (i % pm == pm - 1) else "dense")
                for i in range(pm)]
    ffn = "moe" if cfg.is_moe else "dense"
    return [SubLayer("attn", ffn)]


# ---------------------------------------------------------------- init


def _normal(gen, shape, dtype, device, scale):
    t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return t.mul_(scale)


def _init_sublayer(gen, cfg, sub: SubLayer, periods: int, dtype, device):
    """One pattern position's parameters, stacked over `periods`, with
    the reference's distributions and scales (transformer.py,
    layers.py, moe.py init functions)."""
    d = cfg.d_model
    p = {"norm1": {"scale": torch.ones((periods, d), dtype=dtype,
                                       device=device)}}
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    sd = 1.0 / math.sqrt(d)
    p["attn"] = {
        "wq": _normal(gen, (periods, d, h * hd), dtype, device, sd),
        "wk": _normal(gen, (periods, d, kvh * hd), dtype, device, sd),
        "wv": _normal(gen, (periods, d, kvh * hd), dtype, device, sd),
        "wo": _normal(gen, (periods, h * hd, d), dtype, device,
                      1.0 / math.sqrt(h * hd)),
    }
    if cfg.qkv_bias:
        for n, w in (("bq", h * hd), ("bk", kvh * hd), ("bv", kvh * hd)):
            p["attn"][n] = torch.zeros((periods, w), dtype=dtype,
                                       device=device)
    if cfg.qk_norm:
        for n in ("q_norm", "k_norm"):
            p["attn"][n] = torch.ones((periods, hd), dtype=dtype,
                                      device=device)
    if sub.ffn != "none":
        p["norm2"] = {"scale": torch.ones((periods, d), dtype=dtype,
                                          device=device)}
        if sub.ffn == "moe":
            e, f = cfg.moe.num_experts, cfg.moe.d_ff
            sf = 1.0 / math.sqrt(f)
            p["moe"] = {
                "router": {"w_gate": _normal(gen, (periods, d, e), dtype,
                                             device, sd)},
                "experts": {
                    "w_gate": _normal(gen, (periods, e, d, f), dtype,
                                      device, sd),
                    "w_up": _normal(gen, (periods, e, d, f), dtype,
                                    device, sd),
                    "w_down": _normal(gen, (periods, e, f, d), dtype,
                                      device, sf),
                },
            }
        else:
            f, sf = cfg.d_ff, 1.0 / math.sqrt(cfg.d_ff)
            p["ffn"] = {
                "w_gate": _normal(gen, (periods, d, f), dtype, device, sd),
                "w_up": _normal(gen, (periods, d, f), dtype, device, sd),
                "w_down": _normal(gen, (periods, f, d), dtype, device, sf),
            }
    return p


def init_params(cfg, seed: int, device):
    """Random parameters from a seeded ``torch.Generator`` on `device`,
    laid out as the reference's pytree (layer leaves stacked over
    periods). The numbers differ from the reference's JAX keys; to feed
    both packages the same weights, convert the reference's with
    ``repro_torch.params.from_jax``."""
    if cfg.norm != "rmsnorm" or cfg.act != "swiglu":
        raise NotImplementedError(
            f"{cfg.name}: norm={cfg.norm} act={cfg.act} arrive with the "
            "model-family slice")
    dtype = getattr(torch, cfg.dtype)
    pattern = layer_pattern(cfg)
    assert cfg.num_layers % len(pattern) == 0, \
        f"{cfg.name}: num_layers={cfg.num_layers} not divisible by " \
        f"period={len(pattern)}"
    np_ = cfg.num_layers // len(pattern)
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_model
    params = {
        "embed": _normal(gen, (cfg.padded_vocab, d), dtype, device, 0.02),
        "layers": [_init_sublayer(gen, cfg, sub, np_, dtype, device)
                   for sub in pattern],
        "final_norm": {"scale": torch.ones((d,), dtype=dtype,
                                           device=device)},
    }
    if not cfg.tie_embeddings:
        params["head"] = _normal(gen, (d, cfg.padded_vocab), dtype, device,
                                 1.0 / math.sqrt(d))
    return params


def _period(tree, i: int):
    """Period `i`'s slice of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _period(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------- forward


def _apply_sublayer(cfg, sub: SubLayer, p, x, positions, *, cache=None,
                    cache_len=None, window=0, collect: bool = False,
                    token_mask=None, block_tables=None, new_counts=None,
                    ep_ctx=None, ep_state=None):
    """One sublayer (attention + ffn) with residuals. The layer's cache
    slice is written in place. With `ep_ctx` and this sublayer's
    `ep_state` the MoE runs through the EP slot data plane. Returns
    (x, metrics)."""
    metrics = {}
    h = L.norm(x, p["norm1"], cfg.norm)
    y, _ = L.attention_block(p["attn"], cfg, h, positions,
                             cache=None if cache is None else cache["attn"],
                             cache_len=cache_len, window=window,
                             impl=cfg.impl, block_tables=block_tables,
                             new_counts=new_counts)
    x = x + y
    if sub.ffn != "none":
        h = L.norm(x, p["norm2"], cfg.norm)
        if sub.ffn == "moe":
            if ep_ctx is not None and ep_state is not None:
                # serving hot path with the expert runtime on: the EP slot
                # data plane with the runtime's live tables/weights
                from repro_torch.distributed.ep import moe_ep_ffn
                y, m = moe_ep_ffn(p["moe"], h, ep_state, ep_ctx, cfg,
                                  token_mask=token_mask)
            else:
                y, m = MOE.dispatch_moe(
                    p["moe"], h, top_k=cfg.moe.top_k,
                    num_experts=cfg.moe.num_experts,
                    capacity_factor=cfg.moe.capacity_factor, act=cfg.act,
                    groups=_moe_groups(h), token_mask=token_mask,
                    impl=cfg.impl)
            metrics["expert_load"] = m["expert_load"]
            metrics["aux_loss"] = m["aux_loss"]
            metrics["dropped"] = m["dropped"]
            if collect:   # predictor fine-tuning dataset (paper §5)
                metrics["gate_input"] = h
        else:
            fp = p["ffn"]
            y = torch.nn.functional.silu(h @ fp["w_gate"]) \
                * (h @ fp["w_up"]) @ fp["w_down"]
        x = x + y
    return x, metrics


def _moe_groups(h):
    # dispatch-group size capped at ~2048 tokens (the one-hot dispatch
    # tensor is O(t_g^2) per group), as the reference's single-mesh
    # default (one data shard)
    t = h.shape[0] * h.shape[1]
    return max(1, t // 2048)


# ---------------------------------------------------------------- decode


def init_cache(cfg, params, batch: int, max_len: int):
    """Cache tree mirroring params['layers']: one {attn: {k, v, pos}}
    per pattern position, leaves stacked over periods, on the
    parameters' device."""
    pattern = layer_pattern(cfg)
    np_ = cfg.num_layers // len(pattern)
    return [{"attn": L.init_attn_cache(cfg, (np_, batch), max_len,
                                       getattr(torch, cfg.dtype),
                                       params["embed"].device)}
            for _ in pattern]


def init_paged_cache(cfg, params, num_blocks: int, block: int):
    """Paged-pool cache tree: the same per-period stacking as
    ``init_cache``, but each attention sublayer holds ONE global block
    pool (periods, num_blocks, block, KV, hd) addressed by per-row block
    tables instead of per-slot rows."""
    pattern = layer_pattern(cfg)
    np_ = cfg.num_layers // len(pattern)
    return [{"attn": L.init_paged_attn_cache(cfg, np_, num_blocks, block,
                                             getattr(torch, cfg.dtype),
                                             params["embed"].device)}
            for _ in pattern]


def decode_step(cfg, params, batch, cache, cache_len, *, window: int = 0,
                collect: bool = False, ep_ctx=None, ep_state=None):
    """One decode iteration: batch['tokens'] is (B, S_new) — S_new=1 for
    token-by-token decode, S_new=prompt_len for prefill-into-cache
    (cache_len=0). `cache_len` is an int (uniform batch) or a (B,) int32
    tensor of per-row cache depths (the continuous-batching slot pool).
    `batch` may carry 'token_mask' (B, S_new) or 'active' (B,) to exclude
    tokens from the expert-load metrics. With a paged cache, `batch`
    carries 'block_tables' (B, nbs) int32 and 'new_counts' (B,) — the
    tokens each row really writes this step (a chunk for prefilling
    rows, 1 for decoding rows, 0 for inactive rows); without a
    'token_mask' the mask is built from 'new_counts'. `ep_ctx`
    (``distributed.ep.EPContext``) + `ep_state` (one entry per sublayer
    pattern position, None for non-MoE positions, else that position's
    slot tables/weights stacked over periods, from
    ``serving.expert_runtime.ExpertRuntime.ep_state``) route every MoE
    sublayer through the EP slot data plane. The cache is updated in
    place and returned. Returns (logits (B,S_new,V), cache, metrics)."""
    pattern = layer_pattern(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()]
    bsz, s_new = tokens.shape
    steps = torch.arange(s_new, dtype=torch.int32, device=tokens.device)
    if isinstance(cache_len, int):
        pos = (cache_len + steps)[None].expand(bsz, s_new)
    else:
        cache_len = cache_len.to(torch.int32)
        pos = cache_len[:, None] + steps[None]
    # continuous batching: mask of tokens whose routing counts toward the
    # control plane's expert-load metric — per-token (B, S_new) via
    # 'token_mask' (padded prefill) or per-slot (B,) via 'active'
    token_mask = batch.get("token_mask")
    if token_mask is None and "active" in batch:
        token_mask = batch["active"][:, None].expand(bsz, s_new)
    block_tables = batch.get("block_tables")
    new_counts = batch.get("new_counts")
    if block_tables is not None and new_counts is not None and \
            token_mask is None:
        token_mask = steps[None] < new_counts.to(torch.int32)[:, None]
    np_ = cfg.num_layers // len(pattern)
    ms = []
    for i in range(np_):
        for j, sub in enumerate(pattern):
            x, m = _apply_sublayer(cfg, sub, _period(params["layers"][j], i),
                                   x, pos, cache=_period(cache[j], i),
                                   cache_len=cache_len, window=window,
                                   collect=collect, token_mask=token_mask,
                                   block_tables=block_tables,
                                   new_counts=new_counts, ep_ctx=ep_ctx,
                                   ep_state=None if ep_state is None
                                   or ep_state[j] is None
                                   else _period(ep_state[j], i))
            ms.append(m)
    x = L.norm(x, params["final_norm"], cfg.norm)
    metrics = {}
    loads = [m["expert_load"] for m in ms if "expert_load" in m]
    if loads:
        metrics["expert_load"] = torch.stack(loads)
        metrics["dropped"] = torch.stack(
            [torch.as_tensor(m["dropped"], dtype=torch.float32,
                             device=x.device) for m in ms if "dropped" in m])
    if collect and loads:
        metrics["gate_input"] = torch.stack(
            [m["gate_input"] for m in ms if "gate_input" in m])
    return _lm_head(cfg, params, x), cache, metrics


# ---------------------------------------------------------------- sampling


def _filter_top_k_top_p(lg, k, p):
    """Mask each row of logits (B, V) to its top-k entries (k <= 0: all)
    and its top-p nucleus (the smallest prefix of the descending order
    with cumulative mass >= p; the argmax always survives), with a
    different k and p on every row. Ties keep vocabulary order (a stable
    sort), as the reference's ``argsort`` does."""
    v = lg.shape[-1]
    order = torch.argsort(-lg, dim=-1, stable=True)      # descending
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(v, device=lg.device).expand_as(order))
    keep_k = (k[:, None] <= 0) | (ranks < k[:, None])
    srt = lg.gather(-1, order)
    e = torch.exp(srt - srt.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    cum = torch.cumsum(probs, -1) - probs               # exclusive mass
    keep_p = (cum < p[:, None]).gather(-1, ranks)       # rank 0 kept
    return torch.where(keep_k & keep_p, lg, -math.inf)


@torch.no_grad()
def sample_tokens(logits, temperature, top_k, top_p, seed, step):
    """Next token of EVERY row in one call, with no host sync and no
    data-dependent shape.

    logits (B, V); temperature/top_p (B,) float32; top_k (B,) int32;
    seed (B,) int32 per-request seeds; step (B,) int32 = tokens each
    request has already sampled; all on the logits' device. Rows with
    temperature <= 0 take ``torch.argmax``, bit-identical to greedy
    decoding. Sampled rows take argmax(filtered(logits / t) + Gumbel
    noise) with the key ``fold_in(PRNGKey(seed), step)`` (``models.
    prng``, the reference's threefry bits): keyed by the request, not
    the slot or the batch, so batched decoding samples what sequential
    decoding does. Returns (B,) int32."""
    greedy = torch.argmax(logits, dim=-1)
    lg = logits.float() / temperature.clamp_min(1e-6)[:, None]
    lg = _filter_top_k_top_p(lg, top_k, top_p)
    key = prng.fold_in(prng.key(seed), step)
    sampled = torch.argmax(prng.gumbel(key, lg.shape[-1]) + lg, dim=-1)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)


def _lm_head(cfg, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = x @ head
    if cfg.padded_vocab != cfg.vocab_size:   # mask pad entries
        bias = torch.where(
            torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size,
            0.0, -1e9).to(logits.dtype)
        logits = logits + bias
    return logits
