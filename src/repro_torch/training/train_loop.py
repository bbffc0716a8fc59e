"""Training loop: the train step, the synthetic token stream,
checkpoints and expert-load logging (the training-side view of the
paper's Fig. 1 skew).

A checkpoint at `checkpoint_path` is two files: the parameters in
``<path>.npz`` (with ``.meta.json``), the reference's format, and the
optimizer state (moments and step counter) in ``<path>.opt.npz``. A
resumed run therefore equals the uninterrupted one. The reference saves
and restores the parameters alone, so its resumed run restarts the
moments, the bias corrections and the learning-rate schedule; a
reference checkpoint still restores here, with a fresh optimizer state,
and the loop says so.
"""
from __future__ import annotations

import pathlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.training.checkpoint import latest_step, restore, save
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optimizer import adamw, cosine_schedule


@dataclass
class TrainResult:
    losses: list = field(default_factory=list)
    expert_loads: list = field(default_factory=list)
    step_s: list = field(default_factory=list)   # wall seconds a step
    steps_per_s: float = 0.0


def _opt_path(checkpoint_path) -> str:
    return f"{checkpoint_path}.opt.npz"


def save_checkpoint(checkpoint_path, params, opt_state, step: int) -> None:
    """The optimizer state, then the parameters (whose ``.meta.json``
    step is what a resume reads)."""
    save(_opt_path(checkpoint_path), opt_state, step=step)
    save(f"{checkpoint_path}.npz", params, step=step)


def restore_checkpoint(checkpoint_path, params, opt_state, log=print):
    """(params, opt_state, step) from the checkpoint at `checkpoint_path`,
    or the arguments and step 0 where there is none. Without an
    optimizer file of the same step (a reference checkpoint) the
    optimizer state stays as given, and `log` says so."""
    npz = pathlib.Path(f"{checkpoint_path}.npz")
    if not npz.exists():
        return params, opt_state, 0
    params = restore(npz, params)
    step = latest_step(npz)
    opt = pathlib.Path(_opt_path(checkpoint_path))
    if opt.exists() and latest_step(opt) == step:
        opt_state = restore(opt, opt_state)
    else:
        log(f"resumed {npz} at step {step} with a fresh optimizer state: "
            f"no optimizer state of that step beside it")
    return params, opt_state, step


def train(cfg, *, steps: int = 50, seq_len: int = 128, global_batch: int = 8,
          lr: float = 3e-4, seed: int = 0, microbatches: int = 1,
          checkpoint_path=None, checkpoint_every: int = 0,
          log_every: int = 10, verbose: bool = True, device=None):
    """Train `cfg` from random weights of `seed` on ``TokenStream(seed)``
    with AdamW under the reference's cosine schedule, on the CUDA card
    unless `device` says otherwise; resume from `checkpoint_path` where
    it holds a checkpoint, save there every `checkpoint_every` steps and
    at the end. Returns (TrainResult, params)."""
    dev = M.resolve_device(device)
    params = M.init_params(cfg, seed, dev)
    opt = adamw(cosine_schedule(lr, warmup=max(1, steps // 10), total=steps),
                weight_decay=0.01)
    opt_state = opt.init(params)
    step_fn = M.make_train_step(cfg, opt, microbatches=microbatches)
    stream = TokenStream(DataConfig(cfg.vocab_size, seq_len, global_batch,
                                    seed=seed))
    start = 0
    if checkpoint_path is not None:
        params, opt_state, start = restore_checkpoint(
            checkpoint_path, params, opt_state,
            log=print if verbose else (lambda _: None))

    res = TrainResult()
    t0 = time.perf_counter()
    for step in range(start, steps):
        t_step = time.perf_counter()
        b = stream.batch(step)
        toks = torch.from_numpy(np.stack([b["tokens"], b["labels"]])).to(dev)
        params, opt_state, metrics = step_fn(
            params, opt_state, {"tokens": toks[0], "labels": toks[1]})
        loss = float(metrics["loss"])     # waits for the step
        res.step_s.append(time.perf_counter() - t_step)
        res.losses.append(loss)
        if "expert_load" in metrics:
            res.expert_loads.append(metrics["expert_load"].cpu().numpy())
        if verbose and step % log_every == 0:
            print(f"step {step:4d} loss={loss:.4f} "
                  f"aux={float(metrics.get('aux_loss', 0.0)):.4f}")
        if checkpoint_path and checkpoint_every \
                and (step + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, params, opt_state, step + 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res.steps_per_s = (steps - start) / max(time.perf_counter() - t0, 1e-9)
    if checkpoint_path:
        save_checkpoint(checkpoint_path, params, opt_state, steps)
    return res, params
