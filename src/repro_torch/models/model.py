"""Public model API of the port: parameters, parameter accounting, the
window helpers, the loss and the step builders.

  train_step(params, opt_state, batch)        -> (params, opt_state, metrics)
  prefill_step(params, batch)                 -> (logits, metrics)
  serve_step(params, batch, cache, cache_len) -> (logits, cache)
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.training.optimizer import _leaves, _map

# window of the sliding-window variant that makes long_500k runnable on
# the quadratic-attention archs (the reference's DESIGN.md section 4)
LONG_CONTEXT_WINDOW = 8192


def needs_window(cfg, shape) -> bool:
    """Quadratic-attention archs use the sliding-window variant at 500k."""
    has_full_attn = cfg.family not in ("ssm",)
    return (has_full_attn and shape.seq_len > 65536
            and cfg.sliding_window == 0)


def effective_window(cfg, shape) -> int:
    if cfg.sliding_window:
        return cfg.sliding_window
    return LONG_CONTEXT_WINDOW if needs_window(cfg, shape) else 0


def kv_cache_len(cfg, shape) -> int:
    w = effective_window(cfg, shape)
    return min(shape.seq_len, w) if w else shape.seq_len


def resolve_device(device=None) -> torch.device:
    """`device`, defaulting to the CUDA card; asking for CUDA where none
    is present raises (the CPU is used only when asked for)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' "
                           "to run on the CPU")
    return dev


def init_params(cfg, seed: int = 0, device=None):
    """Random parameters of `cfg` from a seeded ``torch.Generator``, on
    the CUDA card unless `device` says otherwise."""
    return T.init_params(cfg, seed, resolve_device(device))


def input_specs(cfg, shape, *, abstract: bool = True, generator=None,
                device=None):
    """Model inputs for one step of `shape` (``configs.InputShape``),
    with the reference's keys, shapes and dtypes. With `abstract` the
    tensors live on the ``meta`` device (shapes only, no allocation);
    else they are drawn from `generator` (a seeded ``torch.Generator``
    on `device`, resolved as ``resolve_device``) and differ from the
    reference's draws.

    train:   {tokens (B, S), labels (B, S), ...}
    prefill: {tokens (B, S), ...}
    decode:  {tokens (B, 1), ...}  (the cache is built separately)
    A vlm adds vis_embeds (B, S, D) bf16, vis_mask (B, S) bool (a prefix
    of min(64, max(1, S // 2)) patch positions) and, under mrope,
    positions (B, S, 3) int32. The audio family (an encoder-decoder)
    adds the encoder's input, bf16 (B, T, D) with T its encoder_seq_len:
    enc_out for a decode step, which consumes the frozen encoder output,
    else enc_embeds (the stub frontend's frame embeddings)."""
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    dev = torch.device("meta") if abstract else resolve_device(device)
    if not abstract and generator is None:
        raise ValueError("concrete input_specs need a seeded generator")

    def mk(shp, dtype=torch.int32, maxval=None):
        if abstract:
            return torch.empty(shp, dtype=dtype, device=dev)
        if dtype == torch.int32:
            return torch.randint(0, maxval or cfg.vocab_size, shp,
                                 generator=generator, dtype=dtype,
                                 device=dev)
        return torch.randn(shp, generator=generator, dtype=dtype,
                           device=dev) * 0.02

    batch = {"tokens": mk((b, s))}
    if shape.kind == "train":
        batch["labels"] = mk((b, s))
    if cfg.family == "vlm":
        # patch embeddings (stub vision frontend) occupy a prefix of the
        # sequence
        batch["vis_embeds"] = mk((b, s, cfg.d_model), torch.bfloat16)
        if abstract:
            batch["vis_mask"] = torch.empty((b, s), dtype=torch.bool,
                                            device=dev)
        else:
            batch["vis_mask"] = (torch.arange(s, device=dev)[None]
                                 < min(64, max(1, s // 2))).expand(b, s)
        if cfg.rope == "mrope":
            batch["positions"] = mk((b, s, 3), torch.int32,
                                    maxval=shape.seq_len)
    if cfg.family == "audio":
        key = "enc_out" if shape.kind == "decode" else "enc_embeds"
        batch[key] = mk((b, cfg.encdec.encoder_seq_len, cfg.d_model),
                        torch.bfloat16)
    return batch


def loss_fn(cfg, params, batch, *, window: int = 0, aux_weight: float = 0.01,
            remat: str = "full"):
    """(total, metrics): the mean next-token cross entropy of
    batch['labels'] (B, S) under float32 logits, in logsumexp form (the
    padded vocab's -1e9 entries stay inside the logsumexp), plus
    `aux_weight` times the summed router aux loss; metrics gain
    'loss'."""
    logits, metrics = T.forward(cfg, params, batch, window=window,
                                remat=remat)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1,
                          batch["labels"].long()[..., None])[..., 0]
    loss = (lse - picked).mean()
    total = loss + aux_weight * metrics.get("aux_loss", 0.0)
    return total, dict(metrics, loss=loss)


def make_train_step(cfg, optimizer, *, window: int = 0, remat: str = "full",
                    microbatches: int = 1, grad_shardings=None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), functional as the reference's: gradients of ``loss_fn``
    through ``torch.autograd.grad`` on detached leaves (the caller's
    tensors never require grad), then one ``optimizer.update``
    (``training.optimizer.Optimizer``).

    microbatches > 1 splits the batch along dim 0 and accumulates
    float32 gradients from zeros, bounding activation memory at
    B / microbatches a pass; gradients and metrics are divided by
    `microbatches` (an int32 metric such as 'expert_load' comes out
    float32, as JAX's true division gives it). With one microbatch the
    gradients keep the parameters' dtype."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings (a sharded gradient accumulator, ZeRO-2) "
            "arrives with the port's multi-rank sharding slice "
            "(distributed/sharding.py)")

    def grads(params, batch):
        """(metrics, gradients) of ``loss_fn`` at `params` on `batch`."""
        live = _map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            total, metrics = loss_fn(cfg, live, batch, window=window,
                                     remat=remat)
            leaves = _leaves(live)
            gs = torch.autograd.grad(total, leaves, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, gs)])
        return ({k: v.detach() for k, v in metrics.items()},
                _map(lambda _: next(it), params))

    def accumulated_grads(params, batch):
        if microbatches == 1:
            return grads(params, batch)
        mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                           + tuple(v.shape[1:])) for k, v in batch.items()}
        acc = _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
        metrics = None
        for i in range(microbatches):
            m, g = grads(params, {k: v[i] for k, v in mb.items()})
            _map(lambda a, b: a.add_(b), acc, g)
            metrics = m if metrics is None else \
                {k: metrics[k] + m[k] for k in m}
            del g
        return ({k: v / microbatches for k, v in metrics.items()},
                _map(lambda a: a.div_(microbatches), acc))

    def train_step(params, opt_state, batch):
        # named ranges for a profile of the step; autograd runs the
        # backward on a thread of its own, outside the first one
        with torch.profiler.record_function("train_step/grads"):
            metrics, g = accumulated_grads(params, batch)
        with torch.no_grad(), \
                torch.profiler.record_function("train_step/update"):
            params, opt_state = optimizer.update(params, g, opt_state)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg, *, window: int = 0):
    """prefill_step(params, batch) -> (last-position logits (B, 1, V),
    metrics): ``forward`` with ``last_only``."""
    def prefill_step(params, batch):
        return T.forward(cfg, params, batch, window=window, last_only=True)

    return prefill_step


def make_serve_step(cfg, *, window: int = 0):
    """serve_step(params, batch, cache, cache_len) -> (logits, cache):
    one ``decode_step``, the cache written in place."""
    def serve_step(params, batch, cache, cache_len):
        logits, cache, _ = T.decode_step(cfg, params, batch, cache,
                                         cache_len, window=window)
        return logits, cache

    return serve_step


def count_params_analytic(cfg, active_only: bool = False) -> int:
    """Total (or, with `active_only`, per-token active) parameter count
    of the tree ``init_params`` builds."""
    pattern = T.layer_pattern(cfg)
    periods = cfg.num_layers // len(pattern)
    d = cfg.d_model
    n_mats = 3 if cfg.act == "swiglu" else 2
    nd = d if cfg.norm == "rmsnorm" else 2 * d    # scale (+ bias)
    total = cfg.padded_vocab * d + nd
    if not cfg.tie_embeddings:
        total += d * cfg.padded_vocab
    if cfg.encdec is not None:    # encoder layers and their final norm
        total += cfg.encdec.num_encoder_layers * (
            2 * nd + _mixer_params(cfg, "attn") + n_mats * d * cfg.d_ff) + nd
    expert = 0
    for sub in pattern:
        n = nd + _mixer_params(cfg, sub.mixer)
        if sub.cross_attn:
            n += nd + _mixer_params(cfg, "attn")
        if sub.ffn != "none":
            n += nd
            if sub.ffn == "moe":
                n += d * cfg.moe.num_experts
                expert += periods * n_mats * cfg.moe.num_experts * d \
                    * cfg.moe.d_ff
            else:
                n += n_mats * d * cfg.d_ff
        total += periods * n
    total += expert
    if active_only and cfg.is_moe:
        total -= expert
        total += expert * cfg.moe.top_k // cfg.moe.num_experts
    return total


def _mixer_params(cfg, mixer: str) -> int:
    """Parameters of one sublayer's mixer (``models.ssm`` init shapes
    for the recurrent ones)."""
    d, nh = cfg.d_model, cfg.num_heads
    if mixer == "mamba":
        di, n = cfg.ssm.expand * d, cfg.ssm.d_state
        r = max(1, -(-d // 16))                     # dt_rank
        return d * 2 * di + cfg.ssm.d_conv * di + di + di * (r + 2 * n) \
            + r * di + di + di * n + di + di * d
    if mixer == "mlstm":
        di = cfg.ssm.expand * d
        return d * 2 * di + 3 * di * di + di * 2 * nh + 2 * nh + di * d
    if mixer == "slstm":
        hd = d // nh
        return d * 4 * d + nh * hd * 4 * hd + 4 * d + d * 2 * d + d * d
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    n = 2 * d * nh * hd + 2 * d * kvh * hd
    if cfg.qkv_bias:
        n += nh * hd + 2 * kvh * hd
    if cfg.qk_norm:
        n += 2 * hd
    return n
