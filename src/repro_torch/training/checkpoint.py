"""Checkpoints of nested dicts and lists of tensors as numpy ``.npz``
files, in the reference's format: keys are the '/'-joined dict keys and
list indices of each leaf, and bfloat16 leaves are stored as float32
(npz cannot hold bf16). A file written by either package restores into
the other's tree of the same structure, exactly: ``restore`` casts each
leaf back to the dtype of the `like` leaf, on its device.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import torch


def leaf_paths(tree, prefix=()):
    """(key path, leaf) pairs of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield "/".join(prefix), tree
        return
    for k, v in items:
        yield from leaf_paths(v, prefix + (str(k),))


def _flatten(tree) -> dict:
    out = {}
    for key, leaf in leaf_paths(tree):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()          # npz can't store bf16; restore casts
        out[key] = t.cpu().numpy()  # back to the model dtype
    return out


def save(path, tree, *, step: int = 0, extra: dict | None = None) -> None:
    """`tree` into ``<path>.npz`` (numpy appends the suffix unless `path`
    has it) and ``{"step", "keys", **extra}`` into the sibling
    ``.meta.json`` (``Path.with_suffix``, as the reference names it)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    np.savez(path, **flat)
    meta = {"step": step, "keys": sorted(flat), **(extra or {})}
    path.with_suffix(".meta.json").write_text(json.dumps(meta))


def restore(path, like):
    """A new tree of `like`'s structure from the ``.npz`` at `path`, each
    leaf cast to the dtype of `like`'s leaf, on its device."""
    path = pathlib.Path(path)
    with np.load(path if path.suffix == ".npz"
                 else path.with_suffix(".npz")) as data:
        keys = dict(leaf_paths(like))
        if set(keys) != set(data.files):
            raise ValueError(
                f"checkpoint/model tree mismatch: only in the file "
                f"{sorted(set(data.files) - set(keys))[:5]}, only in the "
                f"tree {sorted(set(keys) - set(data.files))[:5]}")
        loaded = {k: torch.from_numpy(data[k]).to(device=l.device,
                                                  dtype=l.dtype)
                  for k, l in keys.items()}
    return _rebuild(like, loaded)


def _rebuild(tree, loaded, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, loaded, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, loaded, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return loaded["/".join(prefix)]


def latest_step(path) -> int:
    meta = pathlib.Path(path).with_suffix(".meta.json")
    if not meta.exists():
        return 0
    return json.loads(meta.read_text()).get("step", 0)
