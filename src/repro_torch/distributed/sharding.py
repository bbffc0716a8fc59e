"""Sharding-rule engine of the port: maps every parameter / input / cache
leaf to a partition spec on a ("data", "model") mesh, with the
reference's rules (``repro.distributed.sharding``), and cuts a tree to
one rank's shards.

Rules (generic, divisibility-checked so every (arch x shape x mesh)
combination has a layout):
  * parameters: tensor-parallel 'model' on the largest divisible dim,
    then FSDP over the data-parallel axes on the next largest divisible
    dim (ZeRO-3 style). Layer-stacked leading axes (the period axis)
    are never sharded.
  * batch inputs: DP axes on the batch dim when divisible, else the
    largest divisible dim takes 'model' (e.g. long_500k's batch=1 shards
    its KV-cache sequence/head dims instead).

A mesh is any object with ``.shape`` (axis name -> size, in mesh order)
and ``.axis_names``: a ``launch.mesh.LogicalMesh`` for the dry-run's
reckoning, or a ``launch.mesh.ProcessMesh`` whose rank ``shard_tree``
cuts for. Trees are the port's nested dicts and lists; a leaf's path is
its keys from the root (the reference's pytree keys).

The reference's ``constrain_activations`` is a GSPMD layout hint that
never changes values. The port's returns `h` unchanged and records
nothing: eager torch has no layout for a compiler to follow, and the
sharded training step (``models.model.make_train_step``) places its rows
itself.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.launch.mesh import dp_axes


class PartitionSpec(tuple):
    """A partition spec: one entry per dim, each None (replicated), an
    axis name, or a tuple of axis names (sharded over their product);
    ``PartitionSpec(None, "data")`` as JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):    # pickles as its entries, not one tuple
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh, as JAX's ``NamedSharding``."""
    mesh: object
    spec: PartitionSpec


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes)) if axes else 1


def _best_dim(shape, divisor: int, taken: set, *, skip: set = frozenset()):
    """Largest dim divisible by divisor, not already taken; ties -> later
    dim (the reference's rule: matmul-minor dims lay out better on a
    TPU)."""
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if i in taken or i in skip:
            continue
        if s % divisor == 0 and s >= divisor and s >= best_size:
            best, best_size = i, s
    return best


def spec_for_param(shape, mesh, *, skip_axis0: bool = False) -> P:
    skip = {0} if skip_axis0 else set()
    entries = [None] * len(shape)
    taken = set()
    mp = mesh.shape.get("model", 1)
    i = _best_dim(shape, mp, taken, skip=skip)
    if i is not None and mp > 1:
        entries[i] = "model"
        taken.add(i)
    dps = dp_axes(mesh)
    dp = _axis_size(mesh, dps)
    j = _best_dim(shape, dp, taken, skip=skip)
    if j is not None and dp > 1:
        entries[j] = dps if len(dps) > 1 else dps[0]
        taken.add(j)
    return P(*entries)


def spec_for_input(shape, mesh) -> P:
    """Batch-first rule: DP on dim 0 if divisible; 'model' on the largest
    remaining divisible dim (so e.g. a (B, S, KV, hd) cache shards)."""
    entries = [None] * len(shape)
    taken = set()
    dps = dp_axes(mesh)
    dp = _axis_size(mesh, dps)
    if len(shape) >= 1 and dp > 1 and shape[0] % dp == 0 and shape[0] >= dp:
        entries[0] = dps if len(dps) > 1 else dps[0]
        taken.add(0)
    mp = mesh.shape.get("model", 1)
    if mp > 1:
        i = _best_dim(shape, mp, taken | {0} if 0 not in taken else taken)
        if i is not None and i != 0:
            entries[i] = "model"
    return P(*entries)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of nested dicts, lists and
    tuples, keeping the structure; `path` is the tuple of keys."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn, tree):
    """`fn` over the leaves of nested dicts, lists and tuples."""
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def _is_stacked(path) -> bool:
    # leaves under params['layers'][j] / params['encoder']['layers'][j]
    # carry a leading period axis
    return "layers" in path


def params_shardings(params_shapes, mesh, *, fsdp: bool = True,
                     ep_experts: bool = False):
    """NamedSharding tree for a params (or optimizer-state) tree of
    tensors (or anything with ``.shape``).

    fsdp=False (ZeRO-2 / inference layout): parameters are
    tensor-parallel over 'model' only and replicated over the DP axes;
    keep fsdp=True for optimizer state, which is touched once a step.

    ep_experts=True (the paper's expert parallelism as a layout): expert
    weight banks (stacked (layers, E, d, f)) put 'model' on the EXPERT
    dim when divisible, so each model rank owns E/mp whole experts."""
    mp = mesh.shape.get("model", 1)

    def one(path, leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return NamedSharding(mesh, P())
        shape = tuple(leaf.shape)
        stacked = _is_stacked(path)
        is_expert = "experts" in path
        if ep_experts and is_expert and len(shape) >= 3:
            e_axis = 1 if stacked else 0
            if mp > 1 and shape[e_axis] % mp == 0:
                entries = [None] * len(shape)
                entries[e_axis] = "model"
                if fsdp:
                    dps = dp_axes(mesh)
                    dp = _axis_size(mesh, dps)
                    j = _best_dim(shape, dp,
                                  {e_axis} | ({0} if stacked else set()))
                    if j is not None and dp > 1:
                        entries[j] = dps if len(dps) > 1 else dps[0]
                return NamedSharding(mesh, P(*entries))
        spec = spec_for_param(shape, mesh, skip_axis0=stacked)
        if not fsdp:
            dps = set(dp_axes(mesh))
            spec = P(*[None if (e in dps or (isinstance(e, tuple)
                                             and set(e) & dps)) else e
                       for e in spec])
        return NamedSharding(mesh, spec)
    return tree_map_with_path(one, params_shapes)


def batch_shardings(batch_shapes, mesh, *, replicate: bool = False):
    def one(leaf):
        if replicate or not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, spec_for_input(tuple(leaf.shape), mesh))
    return tree_map(one, batch_shapes)


def cache_shardings(cache_shapes, mesh, *, seq_over_dp: bool = False,
                    heads_model: bool = False):
    """Decode caches: leading period axis skipped, batch dim next.

    seq_over_dp (the reference's inference layout): the cache SEQUENCE
    dim takes the DP axes and the batch dim is left replicated.
    heads_model: batch over DP, the LAST dim (hd) over 'model', so cache
    writes stay local."""
    def one(leaf):
        shape = tuple(leaf.shape)
        if len(shape) <= 1:
            return NamedSharding(mesh, P())
        if heads_model and len(shape) >= 3:
            dps = dp_axes(mesh)
            dp = _axis_size(mesh, dps)
            mp = mesh.shape.get("model", 1)
            entries = [None] * (len(shape) - 1)
            if dp > 1 and shape[1] % dp == 0 and shape[1] >= dp:
                entries[0] = dps if len(dps) > 1 else dps[0]
            if mp > 1 and shape[-1] % mp == 0 and shape[-1] >= mp:
                entries[-1] = "model"
            return NamedSharding(mesh, P(None, *entries))
        if seq_over_dp and len(shape) >= 3:
            dps = dp_axes(mesh)
            dp = _axis_size(mesh, dps)
            entries = [None] * (len(shape) - 1)
            taken = set()
            if shape[2] % dp == 0 and shape[2] >= dp and dp > 1:
                entries[1] = dps if len(dps) > 1 else dps[0]
                taken.add(1)
            mp = mesh.shape.get("model", 1)
            i = _best_dim(shape[1:], mp, taken | {0})
            if i is not None and mp > 1:
                entries[i] = "model"
            return NamedSharding(mesh, P(None, *entries))
        inner = spec_for_input(shape[1:], mesh)
        return NamedSharding(mesh, P(None, *inner))
    return tree_map(one, cache_shapes)


def replicated(mesh):
    return NamedSharding(mesh, P())


# ------------------------------------------------------------ shards


def shard_shape(shape, sharding: NamedSharding) -> tuple:
    """The shape of one rank's shard of a leaf of `shape`: each sharded
    dim divided by the product of its axes' sizes (the rules shard only
    dims those sizes divide)."""
    out = list(shape)
    for i, e in enumerate(sharding.spec):
        if e is not None:
            n = _axis_size(sharding.mesh, e)
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not "
                                 f"divide over {e!r} ({n})")
            out[i] //= n
    return tuple(out)


def shard_nbytes(tree, shardings) -> int:
    """Bytes of one rank's shards of every leaf of `tree` (tensors, on
    any device, the meta device included) under `shardings`."""
    total = 0

    def one(path, leaf):
        nonlocal total
        sh = leaf_at(shardings, path)
        total += math.prod(shard_shape(leaf.shape, sh)) * leaf.element_size()
    tree_map_with_path(one, tree)
    return total


def leaf_at(tree, path):
    """The leaf of `tree` at `path` (its keys from the root)."""
    for k in path:
        tree = tree[k]
    return tree


def _dim_of(sharding: NamedSharding, names: set):
    for i, e in enumerate(sharding.spec):
        axes = set(e) if isinstance(e, tuple) else {e}
        if axes & names:
            return i
    return None


def data_dim(sharding: NamedSharding):
    """The dim of `sharding`'s spec that the data axes shard, or None."""
    return _dim_of(sharding, set(dp_axes(sharding.mesh)))


def model_dim(sharding: NamedSharding):
    """The dim of `sharding`'s spec that "model" shards, or None."""
    return _dim_of(sharding, {"model"})


def without_axes(shardings, axes):
    """`shardings` with the mesh `axes` dropped from every spec entry
    (an entry left with no axis is None). The parameter layout of a
    ZeRO-2 step is its accumulator's ``grad_shardings`` without the
    data axes: ``params_shardings(fsdp=False)`` entry for entry, since
    ``spec_for_param`` places "model" before the data axes."""
    drop = set(axes)

    def entry(e):
        if e is None:
            return None
        kept = tuple(a for a in (e if isinstance(e, tuple) else (e,))
                     if a not in drop)
        if not kept:
            return None
        return kept if isinstance(e, tuple) and len(kept) > 1 else kept[0]
    return tree_map(lambda s: NamedSharding(s.mesh, P(*map(entry, s.spec))),
                    shardings)


def _block(mesh, e, coords) -> tuple[int, int]:
    """(block index, block count) of spec entry `e` at mesh `coords`
    (axis name -> index): row-major over the entry's axes."""
    block, n = 0, 1
    for a in (e if isinstance(e, tuple) else (e,)):
        block = block * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return block, n


def shard_ranges(sharding: NamedSharding, local_shape) -> list:
    """Where this rank's shard of a leaf lies in the whole leaf, dim by
    dim: None for a dim held whole, else (axes, lo, hi), the mesh axes
    that split it (a tuple, row-major) and the [lo, hi) of the whole
    dim that this rank holds. `local_shape` is the shard's shape, and
    the mesh a ``launch.mesh.ProcessMesh`` (a rank)."""
    mesh = sharding.mesh
    coords = {a: mesh.index(a) for a in mesh.axis_names}
    out = []
    for e, size in zip(sharding.spec, local_shape):
        if e is None:
            out.append(None)
            continue
        block, _ = _block(mesh, e, coords)
        out.append((e if isinstance(e, tuple) else (e,), block * size,
                    (block + 1) * size))
    out.extend([None] * (len(local_shape) - len(sharding.spec)))
    return out


def shard_tree(tree, shardings, *, copy: bool = False):
    """This rank's shard of every leaf of `tree` under `shardings` (the
    counterpart of ``jax.device_put`` with shardings): each sharded dim
    narrowed to this rank's block, as a view, or with `copy` as a
    contiguous tensor of its own (what a rank stores, and what the
    kernels take; the views serve the byte reckoning). The shardings'
    mesh must be a ``launch.mesh.ProcessMesh`` (a rank to cut for)."""
    def one(path, leaf):
        sh = leaf_at(shardings, path)
        mesh = sh.mesh
        if not hasattr(mesh, "index"):
            raise ValueError("shard_tree needs a ProcessMesh (a rank to "
                             f"cut for), got {type(mesh).__name__}")
        coords = {a: mesh.index(a) for a in mesh.axis_names}
        out = leaf
        for i, e in enumerate(sh.spec):
            if e is None:
                continue
            block, n = _block(mesh, e, coords)
            size = leaf.shape[i] // n
            out = out.narrow(i, block * size, size)
        return out.clone(memory_format=torch.contiguous_format) if copy \
            else out
    return tree_map_with_path(one, tree)


def assemble(parts, sharding: NamedSharding):
    """The whole leaf from every rank's shard of it: `parts` in rank
    order, the ranks row-major over ``sharding.mesh.shape``, each
    written at its blocks (ranks that share a block write equal
    copies)."""
    mesh = sharding.mesh
    names, sizes = list(mesh.shape), list(mesh.shape.values())
    shape = list(parts[0].shape)
    for i, e in enumerate(sharding.spec):
        if e is not None:
            shape[i] *= _block(mesh, e, dict.fromkeys(names, 0))[1]
    out = parts[0].new_empty(shape)
    for r, part in enumerate(parts):
        coords = {a: (r // math.prod(sizes[k + 1:])) % sizes[k]
                  for k, a in enumerate(names)}
        at = out
        for i, e in enumerate(sharding.spec):
            if e is not None:
                block, _ = _block(mesh, e, coords)
                at = at.narrow(i, block * part.shape[i], part.shape[i])
        at.copy_(part)
    return out


# ------------------------------------------------------------ activations

def set_activation_mesh(mesh) -> None:
    """The reference's setter of the mesh of its sequence-parallel
    activation constraints. The port's ``constrain_activations`` is an
    identity, so there is nothing to set: this does nothing, and stays
    so that the reference's launch code ports line for line."""


def constrain_activations(h):
    """h: (B, S, D) residual stream. The reference pins it to batch over
    DP and sequence over 'model', a layout hint that never changes
    values; the port returns `h` as it is and records nothing."""
    return h
