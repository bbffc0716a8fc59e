"""Tensor parallelism over the "model" group of a ``launch.mesh.
ProcessMesh``: the collectives that GSPMD inserts into the reference's
model-sharded steps, written out for eager torch.

The reference shards a parameter over "model" on its largest divisible
dim (``distributed.sharding.spec_for_param``) and leaves the rest to the
compiler. The port runs four kinds of leaf on such a mesh:

  * a column/row pair (an FFN whose gate/up products are split on their
    output F and whose down product on its input F, the expert banks'
    and the dense FFNs' layout): the rank multiplies its F-columns and
    its F-rows, and the partial (.., D) sums are summed over the group;
  * the vocabulary (an embedding split on V, a head on V): a masked
    lookup of the rows this rank holds, summed over the group, and the
    rank's logit columns, which ``vocab_cross_entropy`` reduces without
    ever gathering the (B, S, V) logits;
  * an expert bank split on its expert dim (``params_shardings(
    ep_experts=True)``: each rank holds E/model whole experts): the rank
    runs its experts' rows of the dispatch buffer, and their outputs are
    all-gathered over the group in group-rank order
    (``gather_experts``), so every expert's rows are computed whole and
    only concatenated; no weight crosses the group;
  * any other leaf with a model dim (attention, router, norms, the
    recurrent mixers, whisper's encoder): gathered whole at its use.

Activations are replicated over "model". Every operator below is a
``torch.autograd.Function`` whose backward keeps that true, and an
identity on a group of one:

  copy_to_model       identity;          backward: sum over the group
  reduce_from_model   sum over the group; backward: identity
  gather_from_model   all-gather on dim;  backward: this rank's slice
                      (``gather_experts``: the expert outputs, dim 0)
  gather_from_data    all-gather on dim over the data axes;
                                          backward: reduce-scatter (sum)

``copy_to_model`` goes before a product whose input gradient is partial
on each rank (a column-parallel product, a head over the rank's logit
columns); ``reduce_from_model`` after a row-parallel product (in
float32: ``reduce_partial``) and in the vocabulary sums;
``gather_from_model``'s backward does not sum, since every model rank
computes the same whole gradient of a gathered weight from the same
activations. The collectives are the mesh's, metered by
name in its ``host_ms`` and ``nbytes``.

The ZeRO-3 layout (``params_shardings(fsdp=True)``) splits a leaf over
the data axes too. ``gather_from_data`` undoes that split at use: its
forward concatenates the data group's shards in block order, and its
backward sums the gradient over the group, since each data rank holds
other rows of the batch, and hands this rank its block. The sum is
taken in float32 (the gradient arrives in the leaf's dtype, bf16 on
the card). Autograd would round a returned float32 gradient back to the
leaf's dtype, so where the caller gives a float32 `sink` (this rank's
accumulator of the leaf's gradient) the backward adds the float32 sum
into it in place and returns no gradient for the leaf; with no sink it
returns the sum, rounded by autograd.

The sharded decode step adds two forward-only pieces: ``gather_over``,
a shard concatenated over any of the mesh's axes (a cache leaf gathered
at use, the logits' rows and columns), and ``merge_softmax``, which
merges the partial attention results of ranks that each hold a part of
a row's cache slots by their softmax statistics.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import refuse_autograd
from repro_torch.launch.mesh import dp_axes


def model_size(mesh) -> int:
    """The model degree of `mesh` (1 for None or a mesh without it)."""
    return 1 if mesh is None else mesh.shape.get("model", 1)


def data_size(mesh) -> int:
    """The data degree of `mesh`, the product over its data axes (1 for
    None)."""
    return 1 if mesh is None else math.prod(mesh.shape[a]
                                            for a in dp_axes(mesh))


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, "model"), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, tag):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = mesh.index("model")
        return mesh.all_gather(x, "model", tag=tag).movedim(0, dim) \
            .flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, \
            None, None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, sink):
        ctx.mesh, ctx.dim, ctx.sink = mesh, dim, sink
        return gather_over(x, mesh, dim, dp_axes(mesh),
                           tag="params").contiguous()

    @staticmethod
    def backward(ctx, g):
        # the gather's blocks are row-major over the data axes: scatter
        # over the outer axis first
        part = g.float().movedim(ctx.dim, 0)
        for a in dp_axes(ctx.mesh):
            part = ctx.mesh.reduce_scatter(part.contiguous(), a,
                                           tag="grads")
        part = part.movedim(0, ctx.dim)
        if ctx.sink is None:
            return part, None, None, None
        ctx.sink.add_(part)
        return None, None, None, None


def copy_to_model(x, mesh):
    """`x` as it is; its gradient summed over the model group."""
    return x if model_size(mesh) == 1 else _Copy.apply(x, mesh)


def reduce_from_model(x, mesh):
    """The sum of `x` over the model group; its gradient as it is."""
    return x if model_size(mesh) == 1 else _Reduce.apply(x, mesh)


def reduce_partial(x, mesh, dtype):
    """The sum over the model group of `x`, a row-parallel product's
    partial sum, taken in float32 and rounded once to `dtype`, where the
    one-process product rounds its whole sum."""
    return reduce_from_model(x.float(), mesh).to(dtype)


def gather_from_model(x, mesh, dim: int, tag=None):
    """The model group's shards of a leaf concatenated on `dim`, in
    group-rank order; its gradient is this rank's slice of the whole
    gradient, with no sum. `tag` names the transfer in the mesh's
    meters."""
    return x if model_size(mesh) == 1 else _Gather.apply(x, mesh, dim, tag)


def gather_experts(y, mesh):
    """The (E, N, D) expert outputs from each model rank's (E/model, N,
    D) outputs of its own experts, concatenated in group-rank order,
    metered as "all_gather/model/experts"; the gradient is this rank's
    experts' rows."""
    return gather_from_model(y, mesh, 0, tag="experts")


def move_split(x, mesh, src: int, dst: int, tag=None):
    """A model shard split on dim `src` re-cut to the one split on dim
    `dst` with one all-to-all over the model group: chunk i of `x` on
    `dst` goes to model rank i, and the chunks received are concatenated
    on `src` in group-rank order. Data moves, no value changes; forward
    only. `tag` names it in the mesh's meters."""
    m = model_size(mesh)
    if m == 1 or src == dst:
        return x
    parts = torch.stack(x.chunk(m, dim=dst)).contiguous()
    return torch.cat(mesh.all_to_all(parts, "model", tag=tag).unbind(0),
                     dim=src)


def gather_from_data(x, mesh, dim: int, sink=None):
    """The data group's shards of a leaf concatenated on `dim`, in block
    order over the data axes (``sharding.shard_tree``'s cut undone); its
    gradient summed over the group in float32 and cut to this rank's
    block: added into `sink` (float32, `x`'s shape) where given, with no
    gradient returned for `x`, else returned (module docstring). Every
    data rank must call it, in the same order."""
    return x if data_size(mesh) == 1 else _GatherData.apply(x, mesh, dim,
                                                            sink)


def gather_over(x, mesh, dim: int, axes, tag=None):
    """The shards of `x` on `dim` over the mesh `axes` (a name or a
    tuple, row-major as ``sharding.shard_tree`` cuts) concatenated in
    block order; forward only. `tag` names the transfer in the mesh's
    meters."""
    for a in reversed((axes,) if isinstance(axes, str) else tuple(axes)):
        if mesh.group_size(a) > 1:
            x = mesh.all_gather(x, a, tag=tag).movedim(0, dim) \
                .flatten(dim, dim + 1)
    return x


def merge_softmax(out, m, l, mesh, axes, dtype=None):
    """Attention over a row's slots split over the mesh `axes` (a name
    or a tuple), from each rank's partial result over its own slots:
    `out` (.., hd) normalised by the rank's own `l`, `m` and `l` (..)
    its softmax statistics (the max of the scaled scores, the sum of
    exp(score - m)), all float32. M = max of m over the axes, w =
    exp(m - M), L = sum of l w, and the result sum of out l w over L
    (L clamped at 1e-30, as the one-process attention clamps l), cast
    once to `dtype` (default float32). A rank with no visible slot has
    m = NEG_INF and weighs nothing beside one that has. The identity on
    a group of one; forward only (refuses inputs that require grad under
    grad mode: decode needs no gradient)."""
    refuse_autograd("merge_softmax", out, m, l)
    out, m, l = out.float(), m.float(), l.float()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    dtype = torch.float32 if dtype is None else dtype
    axes = tuple(a for a in axes if mesh.group_size(a) > 1)
    if not axes:
        return out.to(dtype)
    top = m
    for a in axes:
        top = mesh.all_reduce(top, a, op="max", tag="softmax")
    w = l * torch.exp(m - top)
    # one sum over the axes for the weighted outputs and the weights
    packed = torch.cat([out * w[..., None], w[..., None]], dim=-1)
    for a in axes:
        packed = mesh.all_reduce(packed, a, tag="softmax")
    acc, total = packed[..., :-1], packed[..., -1:]
    return (acc / torch.clamp(total, min=1e-30)).to(dtype)


class StackedShards:
    """A stand-in for a mesh where one process holds every rank's
    partial result stacked on dim 0, as ``merge_softmax`` takes shards
    computed side by side: a reduction over any axis reduces dim 0 and
    hands every row the result, as the ranks' all-reduce would."""

    def __init__(self, n: int):
        self.n = n

    def group_size(self, axis) -> int:
        return self.n

    def all_reduce(self, x, group, op="sum", tag=None):
        r = x.amax(0, keepdim=True) if op == "max" else x.sum(0, keepdim=True)
        return r.expand_as(x).contiguous()


# ------------------------------------------------------------ layouts


def model_dims(tree, full):
    """Where each leaf of a rank's parameter `tree` is split over
    "model": the one dim whose size differs from the same leaf of
    `full` (the whole tree's shapes, e.g. on the meta device), or None
    for a leaf held whole. Same structure as `tree`."""
    if isinstance(tree, dict):
        return {k: model_dims(v, full[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(model_dims(v, f) for v, f in zip(tree, full))
    diff = [i for i, (a, b) in enumerate(zip(tree.shape, full.shape))
            if a != b]
    if len(diff) > 1 or tree.ndim != full.ndim:
        raise ValueError(f"a shard of shape {tuple(tree.shape)} of a leaf "
                         f"of shape {tuple(full.shape)} is split on more "
                         "than one dim")
    return diff[0] if diff else None


def split_ffn(p, dims) -> bool:
    """Whether an FFN's leaves `p` ((.., D, F) up, (.., F, D) down) with
    model dims `dims` are a column/row pair: every up product split on
    its last dim (F), the down product on its second to last (F)."""
    down = p["w_down"].ndim - 2
    return dims["w_down"] == down and all(
        dims[k] == down + 1 for k in ("w_gate", "w_up") if k in p)


def split_experts(p, dims) -> bool:
    """Whether an expert bank's leaves `p` ((E, D, F) up, (E, F, D)
    down, one period's slice) with model dims `dims` are split over
    "model" on their expert dim (dim 0), every one of them
    (``params_shardings(ep_experts=True)``); ValueError where some are
    and some are not."""
    on_e = [dims[k] == 0 for k in p]
    if any(on_e) and not all(on_e):
        raise ValueError("an expert bank split on its expert dim in some "
                         f"leaves and not in others: model dims {dims}")
    return all(on_e)


def gather_tree(tree, dims, mesh, keep=(), path=()):
    """`tree` with every leaf that has a model dim gathered at use
    (``gather_from_model``), but the subtrees at the paths (tuples of
    keys from the root) in `keep`."""
    if path in keep:
        return tree
    if isinstance(tree, dict):
        return {k: gather_tree(v, dims[k], mesh, keep, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, d, mesh, keep, path + (i,))
                          for i, (v, d) in enumerate(zip(tree, dims)))
    return tree if dims is None else gather_from_model(tree, mesh, dims)


def gather_data_tree(tree, dims, mesh, sinks=None, keep=(), path=()):
    """`tree` with every leaf that has a data dim in `dims` gathered over
    the data group (``gather_from_data``), its gradient summed into the
    leaf of `sinks` (a tree of `tree`'s structure, float32 tensors or
    None; None for no sink) at the same place, but the subtrees at the
    paths in `keep`."""
    if path in keep:
        return tree
    if isinstance(tree, dict):
        return {k: gather_data_tree(v, dims[k], mesh,
                                    None if sinks is None else sinks[k],
                                    keep, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            gather_data_tree(v, d, mesh, None if sinks is None else sinks[i],
                             keep, path + (i,))
            for i, (v, d) in enumerate(zip(tree, dims)))
    return tree if dims is None else gather_from_data(tree, mesh, dims, sinks)


def unstack_dims(dims):
    """Model dims of one period's slice of stacked leaves (the period
    axis, dim 0, is never split)."""
    if isinstance(dims, dict):
        return {k: unstack_dims(v) for k, v in dims.items()}
    if isinstance(dims, (list, tuple)):
        return type(dims)(unstack_dims(v) for v in dims)
    return None if dims is None else dims - 1


# ------------------------------------------------------------ vocabulary


def vocab_offset(mesh, local: int) -> int:
    """The first global vocabulary index of this rank's `local` rows."""
    return mesh.index("model") * local


def vocab_embed(table, tokens, mesh):
    """Embeddings of `tokens` from this rank's rows of a table split on
    V: the rows it holds looked up, zeros elsewhere, summed over the
    group (one rank contributes each token's row, so the sum is exact)."""
    v = table.shape[0]
    idx = tokens.long() - vocab_offset(mesh, v)
    hit = (idx >= 0) & (idx < v)
    rows = table[idx.clamp(0, v - 1)]
    return reduce_from_model(torch.where(hit[..., None], rows,
                                         torch.zeros_like(rows)), mesh)


def vocab_cross_entropy(logits, labels, mesh):
    """Per-token ``logsumexp(logits) - logits[label]`` (B, S) of
    float32 logits split on V (this rank's columns, (B, S, V/model)):
    a detached local max reduced with MAX over the group, the local sum
    of exponentials summed by ``reduce_from_model``, and the label's
    logit taken on the rank that holds it (zero elsewhere) and summed
    alike. The logits are never gathered."""
    v = logits.shape[-1]
    top = mesh.all_reduce(logits.detach().amax(-1), "model", op="max")
    total = reduce_from_model(torch.exp(logits - top[..., None]).sum(-1),
                              mesh)
    idx = labels.long() - vocab_offset(mesh, v)
    hit = (idx >= 0) & (idx < v)
    mine = torch.gather(logits, -1, idx.clamp(0, v - 1)[..., None])[..., 0]
    picked = reduce_from_model(torch.where(hit, mine,
                                           torch.zeros_like(mine)), mesh)
    return torch.log(total) + top - picked
