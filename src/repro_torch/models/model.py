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
            remat: str = "full", data_mesh=None):
    """(total, metrics): the mean next-token cross entropy of
    batch['labels'] (B, S) under float32 logits, in logsumexp form (the
    padded vocab's -1e9 entries stay inside the logsumexp), plus
    `aux_weight` times the summed router aux loss; metrics gain
    'loss'. `data_mesh`: ``transformer.forward``'s (the ZeRO-2 step)."""
    logits, metrics = T.forward(cfg, params, batch, window=window,
                                remat=remat, data_mesh=data_mesh)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1,
                          batch["labels"].long()[..., None])[..., 0]
    loss = (lse - picked).mean()
    total = loss + aux_weight * metrics.get("aux_loss", 0.0)
    return total, dict(metrics, loss=loss)


def _check_microbatches(batch_size: int, parts: int) -> None:
    if batch_size % parts:
        raise ValueError(f"a batch of {batch_size} rows does not split "
                         f"into {parts} equal parts")


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
    gradients keep the parameters' dtype.

    grad_shardings: a ``distributed.sharding.NamedSharding`` tree
    matching the parameters (``params_shardings(..., fsdp=True)``), the
    float32 accumulator's layout. On a ``launch.mesh.LogicalMesh`` it is
    a layout only, as the reference's pin is (sharding never changes its
    values): the step is the one-process step. On a ``ProcessMesh`` of
    (data, 1) ranks the step is ZeRO-2 over the data ranks (see
    ``_zero2_step``), and computes the one-process step at
    ``transformer.set_moe_dispatch_groups(data)``: every rank receives
    the global batch and returns replicated parameters; `opt_state` is
    this rank's shard (``optimizer.init`` of ``sharding.shard_tree(
    params, grad_shardings)``). model > 1 raises NotImplementedError.

    The returned step carries its two halves: ``train_step.grads(params,
    batch) -> (metrics, gradients)`` (the accumulator: this rank's
    shards under ZeRO-2) and ``train_step.apply(params, gradients,
    opt_state) -> (params, opt_state)``; ``train_step.stats`` holds
    the ZeRO-2 step's meters."""
    mesh = None
    if grad_shardings is not None:
        mesh = _sharding_mesh(grad_shardings)
        if not hasattr(mesh, "groups"):
            mesh = None    # a logical layout: the one-process step
        elif mesh.shape["model"] > 1:
            raise NotImplementedError(
                "tensor-parallel (model > 1) execution of the train step "
                "is queued work (ROADMAP queue 1); run ZeRO-2 over "
                "(data, 1) ranks")

    def grads(params, batch):
        """(metrics, gradients) of ``loss_fn`` at `params` on `batch`."""
        live = _map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            total, metrics = loss_fn(cfg, live, batch, window=window,
                                     remat=remat, data_mesh=mesh)
            leaves = _leaves(live)
            gs = torch.autograd.grad(total, leaves, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, gs)])
        return ({k: v.detach() for k, v in metrics.items()},
                _map(lambda _: next(it), params))

    def accumulated_grads(params, batch, pin=None, acc_shape=None):
        """(metrics, gradients) of `batch` in `microbatches` equal parts:
        each part's gradients summed into a float32 accumulator, then
        the accumulator and the summed metrics divided by `microbatches`.
        ZeRO-2 passes `pin(i, g)`, which takes leaf i's float32 gradient
        of a part to this rank's contribution to its accumulator leaf,
        of shape `acc_shape(i, leaf)`."""
        if microbatches == 1 and pin is None:
            return grads(params, batch)
        _check_microbatches(batch["tokens"].shape[0], microbatches)
        mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                           + tuple(v.shape[1:])) for k, v in batch.items()}
        acc = [torch.zeros(p.shape if acc_shape is None else acc_shape(i, p),
                           dtype=torch.float32, device=p.device)
               for i, p in enumerate(_leaves(params))]
        metrics = None
        for i in range(microbatches):
            m, g = grads(params, {k: v[i] for k, v in mb.items()})
            for j, (a, q) in enumerate(zip(acc, _leaves(g))):
                a.add_(q if pin is None else pin(j, q.float()))
            metrics = m if metrics is None else \
                {k: metrics[k] + m[k] for k in m}
            del g
        if microbatches > 1:
            metrics = {k: v / microbatches for k, v in metrics.items()}
            for a in acc:
                a.div_(microbatches)
        it = iter(acc)
        return metrics, _map(lambda _: next(it), params)

    if mesh is not None:
        return _zero2_step(accumulated_grads, optimizer, mesh,
                           grad_shardings, microbatches)

    def train_step(params, opt_state, batch):
        # named ranges for a profile of the step; autograd runs the
        # backward on a thread of its own, outside the first one
        with torch.profiler.record_function("train_step/grads"):
            metrics, g = accumulated_grads(params, batch)
        with torch.no_grad(), \
                torch.profiler.record_function("train_step/update"):
            params, opt_state = optimizer.update(params, g, opt_state)
        return params, opt_state, metrics

    train_step.grads, train_step.apply = accumulated_grads, optimizer.update
    train_step.stats = {}
    return train_step


def _sharding_mesh(grad_shardings):
    """The one mesh of a NamedSharding tree, or ValueError."""
    from repro_torch.distributed.sharding import NamedSharding
    meshes = {id(s.mesh): s.mesh for s in _leaves(grad_shardings)
              if isinstance(s, NamedSharding)}
    if len(meshes) != 1 or not all(isinstance(s, NamedSharding)
                                   for s in _leaves(grad_shardings)):
        raise ValueError("grad_shardings must be a tree of "
                         "distributed.sharding.NamedSharding on one mesh "
                         f"(found {len(meshes)} meshes)")
    return next(iter(meshes.values()))


def _zero2_step(accumulated_grads, optimizer, mesh, grad_shardings,
                microbatches: int):
    """ZeRO-2 over the data ranks of `mesh` (a (data, 1) ProcessMesh).

    Rows: within microbatch i of a global batch of B rows, rank r takes
    rows i * B/mb + r * B/(mb * dp) onward, B/(mb * dp) of them: exactly
    dispatch group r of that microbatch at set_moe_dispatch_groups(dp),
    not the contiguous DP shard of the batch (``transformer._moe_groups``
    raises where finer groups do not split into whole groups a rank).
    The MoE metrics and aux loss are the microbatch's (``moe.
    dispatch_moe(data_mesh=)``); the loss (and the aux loss, the same
    on every rank) is the mean over the equal ranks.

    Gradients, per microbatch (``accumulated_grads``' `pin`): each
    leaf's float32 gradient is reduce-scattered (summed) over the data
    group into this rank's accumulator shard, on the dim its spec gives
    the data axis; that dim is moved to the front, contiguous, around
    the collective (a copy, metered in ``stats``). A leaf with no data
    dim is all-reduced into a whole accumulator. The sum over ranks of
    each rank's gradient is dp times the microbatch's, so the
    accumulator is divided by dp.

    The update: ``optimizer.update`` on this rank's shards (μ and ν
    sharded alike), its global-norm clip summed over the data group with
    a replicated leaf counted once; then the parameter shards are
    all-gathered, so the parameters come back replicated over data."""
    from repro_torch.distributed import sharding as SH
    dp, r = mesh.shape["data"], mesh.index("data")
    stats = {"transpose_bytes": 0, "gathered_bytes": 0, "batch_bytes": 0}

    def specs_for(params):
        """(path, leaf, sharding, data dim) of every leaf, or
        ValueError where grad_shardings does not match `params`."""
        paths = []
        SH.tree_map_with_path(lambda p, x: paths.append((p, x)), params)
        out = []
        for path, leaf in paths:
            try:
                sh = SH.leaf_at(grad_shardings, path)
                SH.shard_shape(leaf.shape, sh)
            except (KeyError, IndexError, TypeError, AttributeError,
                    ValueError) as e:
                raise ValueError(f"grad_shardings does not match the "
                                 f"parameters at {path}: {e!r}") from None
            out.append((path, leaf, sh, SH.data_dim(sh)))
        n = len(_leaves(grad_shardings))
        if len(out) != n:
            raise ValueError(f"grad_shardings has {n} leaves, the "
                             f"parameters {len(out)}")
        return out

    def to_front(x, j: int):
        """x with dim j first, contiguous (the bytes of the copy where
        it copies are metered)."""
        if j == 0:
            return x.contiguous()
        y = x.movedim(j, 0).contiguous()
        stats["transpose_bytes"] += y.numel() * y.element_size()
        return y

    def local_rows(batch, device):
        b = batch["tokens"].shape[0]
        _check_microbatches(b, microbatches * dp)
        return {k: v.reshape((microbatches, dp, b // (microbatches * dp))
                             + tuple(v.shape[1:]))[:, r]
                .reshape((b // dp,) + tuple(v.shape[1:])).to(device)
                for k, v in batch.items()}

    def sharded_grads(params, batch):
        specs = specs_for(params)
        local = local_rows(batch, specs[0][1].device)
        stats["batch_bytes"] = sum(v.numel() * v.element_size()
                                   for v in local.values())

        def pin(i: int, g):
            j = specs[i][3]
            if j is None:
                return mesh.all_reduce(g, "data")
            return mesh.reduce_scatter(to_front(g, j), "data").movedim(0, j)

        metrics, acc = accumulated_grads(
            params, local, pin,
            lambda i, p: SH.shard_shape(p.shape, specs[i][2]))
        for k in ("loss", "aux_loss"):
            metrics[k] = mesh.all_reduce(metrics[k], "data") / dp
        return metrics, _map(lambda a: a.div_(dp), acc)

    def apply(params, g, opt_state):
        specs = specs_for(params)
        flags = [j is not None for *_, j in specs]

        def sum_squares(sq):
            shard = [q for q, f in zip(sq, flags) if f]
            whole = [q for q, f in zip(sq, flags) if not f]
            total = mesh.all_reduce(sum(shard) if shard else
                                    torch.zeros((), device=sq[0].device),
                                    "data")
            return total + sum(whole) if whole else total

        new, opt_state = optimizer.update(
            SH.shard_tree(params, grad_shardings), g, opt_state,
            sum_squares)
        out = []
        for leaf, (_, _, _, j) in zip(_leaves(new), specs):
            if j is None:
                out.append(leaf)
                continue
            full = mesh.all_gather(to_front(leaf, j), "data") \
                .flatten(0, 1).movedim(0, j)
            out.append(full.contiguous())
            stats["gathered_bytes"] += full.numel() * full.element_size()
        it = iter(out)
        return _map(lambda _: next(it), params), opt_state

    def train_step(params, opt_state, batch):
        with torch.profiler.record_function("train_step/grads"):
            metrics, g = sharded_grads(params, batch)
        with torch.no_grad(), \
                torch.profiler.record_function("train_step/update"):
            params, opt_state = apply(params, g, opt_state)
        return params, opt_state, metrics

    train_step.grads, train_step.apply = sharded_grads, apply
    train_step.stats = stats
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


def abstract_params(cfg):
    """The parameter tree of `cfg` on the ``meta`` device: the shapes and
    dtypes ``init_params`` builds, with no storage (the reference's
    ``jax.eval_shape`` of its ``init_params``)."""
    return T.init_params(cfg, 0, torch.device("meta"))


def abstract_cache(cfg, shape):
    """The decode cache of `shape` (``configs.InputShape``: its global
    batch, ``kv_cache_len`` positions) on the ``meta`` device."""
    return T.init_cache(cfg, abstract_params(cfg), shape.global_batch,
                        kv_cache_len(cfg, shape))


def count_params_analytic(cfg, active_only: bool = False) -> int:
    """Total (or, with `active_only`, per-token active) parameter count,
    read from ``abstract_params`` as the reference's is: an expert
    leaf's count scaled by top_k / E when active."""
    from repro_torch.distributed.sharding import tree_map_with_path
    total = expert = 0

    def one(path, leaf):
        nonlocal total, expert
        n = leaf.numel()
        total += n
        if "experts" in path:
            expert += n
    tree_map_with_path(one, abstract_params(cfg))
    if active_only and cfg.is_moe:
        total -= expert
        total += expert * cfg.moe.top_k // cfg.moe.num_experts
    return total
