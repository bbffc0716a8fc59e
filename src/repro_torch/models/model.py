"""Public model API of the port: parameters, parameter accounting, the
window helpers, the loss and the step builders.

  train_step(params, opt_state, batch)        -> (params, opt_state, metrics)
  prefill_step(params, batch)                 -> (logits, metrics)
  serve_step(params, batch, cache, cache_len) -> (logits, cache)
"""
from __future__ import annotations

import torch

from repro_torch.distributed import tensor_parallel as TP
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
            remat: str = "full", data_mesh=None, param_shardings=None,
            grad_sinks=None):
    """(total, metrics): the mean next-token cross entropy of
    batch['labels'] (B, S) under float32 logits, in logsumexp form (the
    padded vocab's -1e9 entries stay inside the logsumexp), plus
    `aux_weight` times the summed router aux loss; metrics gain
    'loss'. `data_mesh`, `param_shardings`, `grad_sinks`:
    ``transformer.forward``'s (the ZeRO-2 and ZeRO-3 steps); where its
    logits are this rank's vocabulary columns (model > 1) the cross
    entropy is reduced over the model group without gathering them
    (``tensor_parallel.vocab_cross_entropy``)."""
    logits, metrics = T.forward(cfg, params, batch, window=window,
                                remat=remat, data_mesh=data_mesh,
                                param_shardings=param_shardings,
                                grad_sinks=grad_sinks)
    logits = logits.float()
    if logits.shape[-1] != cfg.padded_vocab:
        loss = TP.vocab_cross_entropy(logits, batch["labels"],
                                      data_mesh).mean()
    else:
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
                    microbatches: int = 1, grad_shardings=None,
                    param_shardings=None):
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
    (data, model) ranks the step is ZeRO-2 over the data ranks and
    tensor-parallel over the model ranks (see ``_zero2_step``), and
    computes the one-process step at ``transformer.
    set_moe_dispatch_groups(data)``: every rank receives the global
    batch; the parameters in and out are this rank's model shards,
    replicated over data (``sharding.shard_tree(params, train_step.
    param_shardings, copy=True)``: ``grad_shardings`` without the data
    axes, whole at model 1); `opt_state` is this rank's shard
    (``optimizer.init`` of ``sharding.shard_tree(params,
    grad_shardings)``).

    param_shardings: the parameters' layout (the reference's params
    ``in_shardings``), a NamedSharding tree. With data axes in it
    (``params_shardings(..., fsdp=True)``) the step on a ``ProcessMesh``
    is ZeRO-3 (``_zero2_step``'s frame, `zero3`): the parameters in and
    out and `opt_state` are this rank's (data, model) shards
    (``sharding.shard_tree(params, param_shardings, copy=True)``), each
    data-split leaf gathered over the data group at use and its
    gradient reduce-scattered back in float32; ``grad_shardings``
    defaults to it, and given with another layout raises ValueError.
    Without data axes it is the ZeRO-2 step's parameter layout (the
    accumulator is then ``grad_shardings``, or the parameters' layout
    where none is given). A leaf may be split over "model" on another
    dim than its accumulator (``params_shardings(fsdp=False,
    ep_experts=True)``'s expert banks, split on E, beside the
    reference's accumulator ``params_shardings(fsdp=True)``, split on
    F): ``_zero2_step`` moves its gradient and its parameters between
    the two splits by all-to-all over the model group.

    The returned step carries its two halves: ``train_step.grads(params,
    batch) -> (metrics, gradients)`` (the accumulator: this rank's
    shards under ZeRO-2 and ZeRO-3) and ``train_step.apply(params,
    gradients, opt_state) -> (params, opt_state)``;
    ``train_step.stats`` holds the sharded step's meters."""
    zero3 = _check_layouts(param_shardings, grad_shardings)
    if grad_shardings is None:
        grad_shardings = param_shardings
    mesh = _process_mesh(grad_shardings)
    layout = param_shardings if zero3 and mesh is not None else None

    def grads(params, batch, sinks=None):
        """(metrics, gradients) of ``loss_fn`` at `params` on `batch`.
        `sinks`: ``forward``'s `grad_sinks` (ZeRO-3): a leaf with a sink
        has its gradient there and None here."""
        live = _map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            total, metrics = loss_fn(cfg, live, batch, window=window,
                                     remat=remat, data_mesh=mesh,
                                     param_shardings=layout,
                                     grad_sinks=sinks)
            leaves = _leaves(live)
            gs = torch.autograd.grad(total, leaves, allow_unused=True)
        sunk = [False] * len(leaves) if sinks is None else \
            [s is not None for s in _leaves(sinks)]
        it = iter([torch.zeros_like(p) if g is None and not s else g
                   for p, g, s in zip(leaves, gs, sunk)])
        return ({k: v.detach() for k, v in metrics.items()},
                _map(lambda _: next(it), params))

    def accumulated_grads(params, batch, pin=None, acc_shape=None,
                          sunk=()):
        """(metrics, gradients) of `batch` in `microbatches` equal parts:
        each part's gradients summed into a float32 accumulator, then
        the accumulator and the summed metrics divided by `microbatches`.
        ZeRO-2 passes `pin(i, g)`, which takes leaf i's float32 gradient
        of a part to this rank's contribution to its accumulator leaf,
        of shape `acc_shape(i, leaf)`; ZeRO-3 also passes `sunk`, the
        leaves whose accumulator the forward's data gathers sum into
        themselves (``forward``'s `grad_sinks`)."""
        if microbatches == 1 and pin is None:
            return grads(params, batch)
        _check_microbatches(batch["tokens"].shape[0], microbatches)
        mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                           + tuple(v.shape[1:])) for k, v in batch.items()}
        acc = [torch.zeros(p.shape if acc_shape is None else acc_shape(i, p),
                           dtype=torch.float32, device=p.device)
               for i, p in enumerate(_leaves(params))]
        sinks = None
        if sunk:
            it = iter([a if i in sunk else None for i, a in enumerate(acc)])
            sinks = _map(lambda _: next(it), params)
        metrics = None
        for i in range(microbatches):
            m, g = grads(params, {k: v[i] for k, v in mb.items()}, sinks)
            for j, (a, q) in enumerate(zip(acc, _leaves(g))):
                if j in sunk:
                    continue
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
        return _zero2_step(cfg, accumulated_grads, optimizer, mesh,
                           grad_shardings, microbatches, layout,
                           None if zero3 else param_shardings)

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


def _sharding_mesh(shardings):
    """The one mesh of a NamedSharding tree, or ValueError."""
    from repro_torch.distributed.sharding import NamedSharding
    meshes = {id(s.mesh): s.mesh for s in _leaves(shardings)
              if isinstance(s, NamedSharding)}
    if len(meshes) != 1 or not all(isinstance(s, NamedSharding)
                                   for s in _leaves(shardings)):
        raise ValueError("shardings must be a tree of "
                         "distributed.sharding.NamedSharding on one mesh "
                         f"(found {len(meshes)} meshes)")
    return next(iter(meshes.values()))


def _check_layouts(param_shardings, grad_shardings) -> bool:
    """Whether `param_shardings` splits leaves over the data axes (the
    ZeRO-3 layout); ValueError where both trees are given and disagree:
    in whether a leaf is split over "model", or (ZeRO-3) in its model or
    its data dim. ZeRO-2 moves a leaf split on another model dim than
    its accumulator's (``_zero2_step``)."""
    if param_shardings is None:
        return False
    from repro_torch.distributed import sharding as SH
    ps = _leaves(param_shardings)
    _sharding_mesh(param_shardings)
    zero3 = any(SH.data_dim(s) is not None for s in ps)
    if grad_shardings is None:
        return zero3
    gs = _leaves(grad_shardings)
    if len(gs) != len(ps) or any(
            (SH.model_dim(p) is None) != (SH.model_dim(g) is None)
            or (zero3 and (SH.model_dim(p) != SH.model_dim(g)
                           or SH.data_dim(p) != SH.data_dim(g)))
            for p, g in zip(ps, gs)):
        raise ValueError("param_shardings and grad_shardings lay the "
                         "parameters out differently" + (
                             " over the data axes (ZeRO-3 takes its "
                             "accumulator in the parameters' layout)"
                             if zero3 else ""))
    return zero3


def _process_mesh(shardings):
    """The ``ProcessMesh`` of a NamedSharding tree; None for no tree or
    one on a ``LogicalMesh`` (a layout only: the one-process step)."""
    if shardings is None:
        return None
    mesh = _sharding_mesh(shardings)
    return mesh if hasattr(mesh, "groups") else None


def _zero2_step(cfg, accumulated_grads, optimizer, mesh, grad_shardings,
                microbatches: int, zero3=None, param_shardings=None):
    """ZeRO-2 over the data ranks of `mesh` (a (data, model)
    ProcessMesh), tensor-parallel over its model ranks; ZeRO-3 where
    `zero3` is the parameters' layout with data axes (below).

    Parameters: this rank's model shards (`param_shardings` where given,
    else ``grad_shardings`` without the data axes; ``train_step.
    param_shardings``: ``params_shardings(..., fsdp=False)`` for the
    reference's layout), replicated over data; ``transformer.forward``
    runs them as ``distributed.tensor_parallel`` says. At model 1 they
    are the whole parameters. A leaf split over "model" on another dim
    than its accumulator (the expert banks of ``params_shardings(
    ep_experts=True)``: E against the accumulator's F) is moved between
    the two splits by one all-to-all over the model group
    (``tensor_parallel.move_split``) where the two layouts meet: each
    part's float32 gradient before the data group's reduce-scatter
    ("all_to_all/model/grads"), the parameters before the update and
    the updated parameters after the data group's all-gather
    ("all_to_all/model/params"). Moves change no value.

    Rows: within microbatch i of a global batch of B rows, rank r takes
    rows i * B/mb + r * B/(mb * dp) onward, B/(mb * dp) of them: exactly
    dispatch group r of that microbatch at set_moe_dispatch_groups(dp),
    not the contiguous DP shard of the batch (``transformer._moe_groups``
    raises where finer groups do not split into whole groups a rank).
    Every model rank of a data index takes the same rows, and holds them
    as ``batch_shardings`` lays them out (the sequence over "model"
    where it divides), all-gathered over the model group at use. The MoE
    metrics and aux loss are the microbatch's (``moe.dispatch_moe(
    data_mesh=)``); the loss (and the aux loss, the same on every rank)
    is the mean over the data ranks, equal already on every model rank.

    Gradients, per microbatch (``accumulated_grads``' `pin`): each
    leaf's float32 gradient of this rank's model shard is
    reduce-scattered (summed) over the data group into this rank's
    accumulator shard, on the dim its spec gives the data axis; that dim
    is moved to the front, contiguous, around the collective (a copy,
    metered in ``stats``). A leaf with no data dim is all-reduced into a
    whole accumulator. The sum over ranks of each rank's gradient is dp
    times the microbatch's, so the accumulator is divided by dp.

    The update: ``optimizer.update`` on this rank's (data, model) shards
    (μ and ν sharded alike), its global-norm clip's squared norm summed
    over the data group for leaves split on data and over the model
    group for leaves split on model, a leaf replicated on an axis
    counted once; then the shards are all-gathered over the data group
    only, so the parameters come back as this rank's model shards.

    ZeRO-3 (`zero3`, ``make_train_step(param_shardings=)``): the
    parameters are this rank's (data, model) shards, in and out. The
    rows, the division by dp, the clip and the meters are as above;
    ``transformer.forward`` gathers each data-split leaf over the data
    group at use, and its backward reduce-scatters that leaf's float32
    gradient straight into this rank's accumulator shard
    (``tensor_parallel.gather_from_data`` with the accumulator as its
    sink), so `pin` takes only the leaves with no data dim (all-reduced,
    as above). The update runs on the shards as they are and nothing is
    gathered after it. Every rank issues the same collectives in the
    same order: the forward's gathers and the backward's scatters follow
    the graph, which every rank builds alike, and `pin`'s all-reduces
    run after the backward in leaf order."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import dp_axes
    dp, r = mesh.shape["data"], mesh.index("data")
    param_sh = zero3 if zero3 is not None else param_shardings \
        if param_shardings is not None else \
        SH.without_axes(grad_shardings, dp_axes(mesh))
    data_sh = SH.without_axes(grad_shardings, ("model",))
    stats = {"transpose_bytes": 0, "gathered_bytes": 0, "batch_bytes": 0}

    def specs_for(params):
        """(leaf, data dim, model dim, accumulator shape, the leaf's own
        model dim) of every leaf (the dims of the accumulator's layout),
        or ValueError where grad_shardings does not match `params` (this
        rank's model shards of `cfg`'s parameters)."""
        whole = T._whole_shapes(cfg)
        paths = []
        SH.tree_map_with_path(lambda p, x: paths.append((p, x)), params)
        out = []
        for path, leaf in paths:
            try:
                sh = SH.leaf_at(grad_shardings, path)
                full = SH.leaf_at(whole, path).shape
                want = SH.shard_shape(full, SH.leaf_at(param_sh, path))
                acc = SH.shard_shape(full, sh)
            except (KeyError, IndexError, TypeError, AttributeError,
                    ValueError) as e:
                raise ValueError(f"grad_shardings does not match the "
                                 f"parameters at {path}: {e!r}") from None
            if tuple(leaf.shape) != want:
                raise ValueError(f"grad_shardings does not match the "
                                 f"parameters at {path}: a leaf of "
                                 f"{tuple(leaf.shape)}, its model shard "
                                 f"{want}")
            out.append((leaf, SH.data_dim(sh), SH.model_dim(sh), acc,
                        SH.model_dim(SH.leaf_at(param_sh, path))))
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
        """This rank's rows, held split over the model group as
        ``batch_shardings`` lays the global batch out, then gathered."""
        b = batch["tokens"].shape[0]
        _check_microbatches(b, microbatches * dp)
        out, held = {}, 0
        for k, v in batch.items():
            rows = v.reshape((microbatches, dp, b // (microbatches * dp))
                             + tuple(v.shape[1:]))[:, r] \
                .reshape((b // dp,) + tuple(v.shape[1:]))
            m = SH.model_dim(SH.batch_shardings(v, mesh))
            if m is not None:
                n = rows.shape[m] // mesh.shape["model"]
                rows = rows.narrow(m, mesh.index("model") * n, n)
            rows = rows.to(device, copy=True, memory_format=torch.
                           contiguous_format)
            held += rows.numel() * rows.element_size()
            out[k] = rows if m is None else mesh.all_gather(
                rows, "model").movedim(0, m).flatten(m, m + 1)
        stats["batch_bytes"] = held
        return out

    def sharded_grads(params, batch):
        specs = specs_for(params)
        local = local_rows(batch, specs[0][0].device)

        def pin(i: int, g):
            _, j, m, _, own = specs[i]
            g = TP.move_split(g, mesh, own, m, tag="grads")
            if j is None:
                return mesh.all_reduce(g, "data")
            return mesh.reduce_scatter(to_front(g, j), "data").movedim(0, j)

        sunk = () if zero3 is None else \
            {i for i, s in enumerate(specs) if s[1] is not None}
        metrics, acc = accumulated_grads(params, local, pin,
                                         lambda i, p: specs[i][3], sunk)
        for k in ("loss", "aux_loss"):
            metrics[k] = mesh.all_reduce(metrics[k], "data") / dp
        return metrics, _map(lambda a: a.div_(dp), acc)

    def apply(params, g, opt_state):
        specs = specs_for(params)

        def sum_squares(sq):
            # by (split on data, split on model): each part summed over
            # the axes it is split on, and only those
            part = {}
            for q, (_, j, m, _, _) in zip(sq, specs):
                key = (j is not None, m is not None)
                part[key] = part.get(key, 0) + q
            zero = torch.zeros((), device=sq[0].device)
            both, data = mesh.all_reduce(torch.stack(
                [part.get((True, True), zero),
                 part.get((True, False), zero)]), "data")
            both, model = mesh.all_reduce(torch.stack(
                [both, part.get((False, True), zero)]), "model")
            return both + data + model + part.get((False, False), zero)

        if zero3 is not None:
            return optimizer.update(params, g, opt_state, sum_squares)
        it = iter([TP.move_split(leaf, mesh, own, m, tag="params")
                   for leaf, _, m, _, own in specs])
        new, opt_state = optimizer.update(
            SH.shard_tree(_map(lambda _: next(it), params), data_sh), g,
            opt_state, sum_squares)
        out = []
        for leaf, (_, j, m, _, own) in zip(_leaves(new), specs):
            if j is not None:
                leaf = mesh.all_gather(to_front(leaf, j), "data") \
                    .flatten(0, 1).movedim(0, j).contiguous()
                stats["gathered_bytes"] += leaf.numel() * leaf.element_size()
            out.append(TP.move_split(leaf, mesh, m, own, tag="params"))
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
    train_step.stats, train_step.param_shardings = stats, param_sh
    return train_step


def make_prefill_step(cfg, *, window: int = 0, param_shardings=None):
    """prefill_step(params, batch) -> (last-position logits (B, 1, V),
    metrics): ``forward`` with ``last_only``.

    param_shardings: the parameters' ``distributed.sharding.
    NamedSharding`` tree (the reference's ``in_shardings``). On a
    ``LogicalMesh`` it is a layout only: the one-process step. On a
    ``ProcessMesh`` `params` are this rank's shards (``sharding.
    shard_tree(..., copy=True)``), split over "model" and, under ZeRO-3
    (``params_shardings(fsdp=True)``), over the data axes too: a
    data-split leaf is gathered over the data group at use, one layer
    period at a time (``transformer.forward``), so the step computes
    what it computes on the ``fsdp=False`` layout, bit for bit. Each
    rank runs its contiguous rows of the global batch (B over
    data, as ``batch_shardings`` lays it out: its dispatch groups at
    ``transformer.set_moe_dispatch_groups(data)``), tensor-parallel over
    its model group, and returns the global logits (B, 1, V) and
    metrics, equal on every rank: the one-process step's at that
    dispatch-group count."""
    mesh = _process_mesh(param_shardings)
    if mesh is None:
        def prefill_step(params, batch):
            return T.forward(cfg, params, batch, window=window,
                             last_only=True)

        return prefill_step
    dp, r = mesh.shape["data"], mesh.index("data")

    def prefill_step(params, batch):
        b = batch["tokens"].shape[0]
        if b % dp:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{dp} data ranks")
        dev = _leaves(params)[0].device
        local = {k: v.narrow(0, r * (b // dp), b // dp).to(dev)
                 for k, v in batch.items()}
        logits, metrics = T.forward(cfg, params, local, window=window,
                                    last_only=True, data_mesh=mesh,
                                    param_shardings=param_shardings)
        if logits.shape[-1] != cfg.padded_vocab:   # this rank's columns
            logits = TP.gather_from_model(logits, mesh, logits.ndim - 1)
        return mesh.all_gather(logits, "data").flatten(0, 1), metrics

    return prefill_step


def make_serve_step(cfg, *, window: int = 0, param_shardings=None,
                    cache_shardings=None):
    """serve_step(params, batch, cache, cache_len) -> (logits, cache):
    one ``decode_step``, the cache written in place. The step's metrics
    (expert loads and drops) are left on ``serve_step.metrics``.

    param_shardings: as ``make_prefill_step``'s. cache_shardings: the
    cache's NamedSharding tree (``distributed.sharding.cache_shardings``,
    the reference's cache ``in_shardings``). On a ``ProcessMesh`` of more
    than one rank `params` are this rank's shards (under ZeRO-3 also
    split over the data axes, gathered at use as the prefill's), `cache`
    is this rank's contiguous shards of the whole cache, written in
    place, and `batch` and `cache_len` (an int, a 0-d or a (B,) tensor)
    are global: the rank runs its rows where the cache's batch splits
    over data, else the whole batch (an encoder-decoder's `enc_out` or
    `enc_embeds` too, and its `cache_len` an int or a 0-d tensor). The
    step runs at ``transformer.set_moe_dispatch_groups(data)``, as the
    reference's dry-run sets it; the logits (B, S_new, V) and the
    metrics are the global ones, equal on every rank. Every config runs
    so: attention caches, recurrent state (Mamba, mLSTM, sLSTM) and
    encoder-decoder caches (``transformer.decode_step``)."""
    mesh = _process_mesh(param_shardings)
    sharded = mesh is not None and mesh.size > 1
    if sharded:
        from repro_torch.distributed import sharding as SH
        if cache_shardings is None:
            raise ValueError("a decode step on a process mesh needs the "
                             "cache's layout (cache_shardings)")
        # the batch rows split alike in every leaf (transformer.
        # _cache_shards): read them from the first, whatever its mixer
        rows_sharding = _leaves(cache_shardings)[0]

    def serve_step(params, batch, cache, cache_len):
        if not sharded:
            logits, cache, serve_step.metrics = T.decode_step(
                cfg, params, batch, cache, cache_len, window=window)
            return logits, cache
        first = _leaves(cache)[0]
        rows = SH.shard_ranges(rows_sharding, first.shape)[1]
        dev = first.device

        def mine(t):
            t = t.to(dev)
            return t if rows is None else t.narrow(0, rows[1],
                                                   rows[2] - rows[1])
        local = {k: mine(v) for k, v in batch.items()}
        if isinstance(cache_len, torch.Tensor):
            cache_len = cache_len.to(dev)
            if cache_len.ndim:
                cache_len = mine(cache_len)
        groups = T._MOE_GROUPS["groups"]
        T.set_moe_dispatch_groups(mesh.shape["data"])
        try:
            logits, cache, serve_step.metrics = T.decode_step(
                cfg, params, local, cache, cache_len, window=window,
                data_mesh=mesh, cache_shardings=cache_shardings,
                param_shardings=param_shardings)
        finally:
            T.set_moe_dispatch_groups(groups)
        if logits.shape[-1] != cfg.padded_vocab:   # this rank's columns
            logits = TP.gather_over(logits, mesh, logits.ndim - 1, "model",
                                    tag="logits")
        if rows is not None:
            logits = TP.gather_over(logits, mesh, 0, rows[0], tag="logits")
        return logits, cache

    serve_step.metrics = None
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
