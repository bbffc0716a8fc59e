"""Training launcher of the PyTorch port, on the CUDA card unless
``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch mixtral-8x7b --smoke --steps 100 --seq-len 128 --batch 8

Full (non-smoke) configs do not fit one card beyond a few layers; on
the CPU use --smoke. Training runs the plain expert FFN and attention
(``--impl ref``): the CUDA kernels have no backward, in this package or
in the reference, and refuse inputs that require grad.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.kernels import IMPLS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--impl", default="ref", choices=IMPLS,
                    help="kernel backend; 'ref' (the default) because the "
                         "CUDA kernels have no backward in either package, "
                         "so 'auto' and 'cuda' raise under autograd")
    args = ap.parse_args(argv)

    from repro_torch.training.train_loop import train
    cfg = get_config(args.arch, smoke=args.smoke).with_(impl=args.impl)
    print(f"training {cfg.name} (smoke={args.smoke}) for {args.steps} steps "
          f"on {args.device}, impl={args.impl}")
    res, _params = train(
        cfg, steps=args.steps, seq_len=args.seq_len,
        global_batch=args.batch, lr=args.lr,
        microbatches=args.microbatches,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every, device=args.device)
    print(f"done: loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
          f"({res.steps_per_s:.2f} steps/s)")


if __name__ == "__main__":
    main()
