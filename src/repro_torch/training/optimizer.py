"""Minimal optimizers over nested dicts and lists of tensors: AdamW and
SGD, with global-norm clipping and a cosine/linear learning-rate
schedule. Updates are functional, as the reference's are:
``update(params, grads, state) -> (params, state)`` returns new tensors
and leaves its arguments as they were. Moments are float32; ``step`` is
a 0-d int32 tensor, so nothing is read back to the host."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch


def _map(fn, *trees):
    """`fn` over the leaves of trees of one structure (dicts, lists,
    tuples), returning that structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def global_norm(tree, sum_squares=sum) -> torch.Tensor:
    """The tree's L2 norm. `sum_squares` takes its leaves' squared norms
    (0-d float32 tensors, in leaf order) to the tree's squared norm:
    under ZeRO-2 the leaves are this rank's shards, summed over the data
    group for a leaf split on data and over the model group for a leaf
    split on model, a leaf replicated on an axis counted once
    (``models.model.make_train_step(grad_shardings=)``)."""
    return torch.sqrt(sum_squares([torch.sum(torch.square(l.float()))
                                   for l in _leaves(tree)]))


def clip_by_global_norm(tree, max_norm: float, sum_squares=sum):
    n = global_norm(tree, sum_squares)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    # a bf16 leaf times the f32 scale is f32, as jnp promotes it (a 0-d
    # tensor would keep it bf16 in torch)
    return _map(lambda g: g.to(torch.promote_types(g.dtype, scale.dtype))
                * scale, tree), n


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    # (params, grads, state, sum_squares=sum) -> (params, state); the
    # update is elementwise but for the clip's norm (``global_norm``), so
    # it runs on shards as it is
    update: Callable


def _zeros(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def adamw(lr: float | Callable = 1e-3, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params):
        dev = _leaves(params)[0].device
        return {"mu": _zeros(params), "nu": _zeros(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(params, grads, state, sum_squares=sum):
        step = state["step"] + 1
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, sum_squares)
        lr_t = lr_fn(step)
        t = step.float()
        c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)

        def upd(p, g, mu, nu):
            g = g.float()
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            delta = (mu / c1) / (torch.sqrt(nu / c2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            return (p.float() - lr_t * delta).to(p.dtype), mu, nu

        out = _map(upd, params, grads, state["mu"], state["nu"])
        # the (param, mu, nu) leaves of `out`, walked by params' structure
        pick = lambda i: _map(lambda _, o: o[i], params, out)  # noqa: E731
        return pick(0), {"mu": pick(1), "nu": pick(2), "step": step}

    return Optimizer(init=init, update=update)


def sgd(lr: float = 1e-2, momentum: float = 0.9,
        clip_norm: Optional[float] = None) -> Optimizer:
    def init(params):
        return {"m": _zeros(params)}

    def update(params, grads, state, sum_squares=sum):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, sum_squares)
        m = _map(lambda mm, g: momentum * mm + g.float(), state["m"], grads)
        params = _map(lambda p, mm: (p.float() - lr * mm).to(p.dtype),
                      params, m)
        return params, {"m": m}

    return Optimizer(init=init, update=update)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def fn(step):
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return fn
