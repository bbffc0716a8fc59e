"""Train a small MoE for a few hundred steps in the PyTorch port, the
counterpart of ``examples/train_moe.py``: grok-1's smoke config
reshaped (d_model 192, 2 layers, 4 experts top-2, vocab 4096), the
synthetic Zipf+Markov stream, AdamW at lr 1e-3; the loss must drop, and
the per-layer CV of the final expert loads shows the skew that emerges
(paper Fig. 1). Training runs the plain expert FFN and attention (the
kernels have no backward). On the CUDA card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train_moe --device cpu \\
      --steps 40 --checkpoint "$TMPDIR/moe_ckpt"

A checkpoint is written every 100 steps and at the end; a second run on
the same path resumes from it.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import NamedTuple

import numpy as np

# the reference's /tmp/repro_moe_ckpt, under $TMPDIR where that is set
CHECKPOINT = os.path.join(tempfile.gettempdir(), "repro_moe_ckpt")


class TrainMoe(NamedTuple):
    """``run``'s outcome: the parameter count, ``train``'s result, the
    mean loss of the first and last 10 steps (None when the run resumed
    with no step left) and the final expert-load CV per layer."""
    n_params: int
    result: object
    first: float | None
    last: float | None
    cv: np.ndarray | None


def config():
    """The example's model: grok-1's smoke config at d_model 192, 2
    layers, 4 heads (2 KV) of 48, d_ff 384, vocab 4096, 4 experts top-2
    of d_ff 384, impl "ref"."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoESpec
    return get_config("grok-1-314b", smoke=True).with_(
        num_layers=2, d_model=192, num_heads=4, num_kv_heads=2,
        head_dim=48, d_ff=384, vocab_size=4096,
        moe=MoESpec(num_experts=4, top_k=2, d_ff=384), impl="ref")


def run(*, steps: int = 200, batch: int = 8, seq_len: int = 64,
        checkpoint_path=CHECKPOINT, device=None,
        log=print) -> TrainMoe:
    """Train ``config()`` for `steps` steps of `batch` x `seq_len`
    tokens through ``train_loop.train`` (lr 1e-3, a line every 25 steps,
    a checkpoint every 100 at `checkpoint_path`, resumed from there when
    one is present) on `device` (default: the CUDA card). Asserts that
    the loss dropped, unless the run resumed with no step left."""
    from repro_torch.models.model import count_params_analytic
    from repro_torch.training.train_loop import train
    cfg = config()
    n = count_params_analytic(cfg)
    log(f"model: {n / 1e6:.1f}M params "
        f"({cfg.moe.num_experts} experts top-{cfg.moe.top_k})")
    res, _params = train(cfg, steps=steps, seq_len=seq_len,
                         global_batch=batch, lr=1e-3, log_every=25,
                         checkpoint_path=checkpoint_path,
                         checkpoint_every=100, device=device)
    if not res.losses:
        log(f"\nresumed from {checkpoint_path} at step {steps}: no step "
            f"left to train")
        return TrainMoe(n, res, None, None, None)
    first = float(np.mean(res.losses[:10]))
    last = float(np.mean(res.losses[-10:]))
    log(f"\nloss: {first:.3f} -> {last:.3f} "
        f"({res.steps_per_s:.2f} steps/s)")
    assert last < first, "training did not reduce loss"
    cv = None
    if res.expert_loads:
        loads = res.expert_loads[-1]
        cv = loads.std(-1) / np.maximum(loads.mean(-1), 1e-9)
        log(f"final expert-load CV per layer: {cv.round(2)} "
            f"(skew emerges naturally, cf. paper Fig. 1)")
    return TrainMoe(n, res, first, last, cv)


def main(argv=None) -> TrainMoe:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--checkpoint", default=CHECKPOINT,
                    help="checkpoint path (<path>.npz, .meta.json, "
                         ".opt.npz); resumed from when present")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card; raises "
                         "where none is present)")
    args = ap.parse_args(argv)
    return run(steps=args.steps, batch=args.batch, seq_len=args.seq_len,
               checkpoint_path=args.checkpoint, device=args.device)


if __name__ == "__main__":
    main()
