"""Where a serving decode step spends its time on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode

Serves the same traffic as ``chip_smoke.py``'s full-width phase
(mixtral-8x7b at its published widths, depth cut to ``--layers``, bf16,
random seeded weights, ``MoElessController`` attached, 8 slots, 12
requests with prompts of 128/256/384/512 tokens and 16/32/48 new
tokens, all arriving at t=0) and traces ``--steps`` batched decode
steps with ``torch.profiler`` once the pool is full, after timing as
many steps without it. Prints, per decode step: wall time with and
without the profiler, device busy time (the sum of kernel times; one
stream, so kernels do not overlap), the device's idle share of the
unprofiled step, the host time in the model call and in the control
plane, and the kernels by device time. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import MoElessController, ServingEngine
    from repro_torch.serving.scheduler import GenRequest

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    full = get_config("mixtral-8x7b")
    cfg = full.with_(num_layers=args.layers)
    params = init_params(cfg, seed=args.seed, device="cuda")
    ctrl = MoElessController(cfg, num_devices=8)
    engine = ServingEngine(cfg, params, max_len=512 + 48 + 1,
                           controller=ctrl)
    rng = np.random.default_rng(args.seed)
    lens, gens = (128, 256, 384, 512), (16, 32, 48)
    reqs = [GenRequest(rid=i, arrival=0.0,
                       prompt=rng.integers(0, cfg.vocab_size,
                                           size=lens[i % 4], dtype=np.int32),
                       max_new_tokens=gens[i % 3]) for i in range(12)]

    # host seconds spent in the model call (enqueueing its kernels) and
    # in the control plane (its one device->host sync included)
    host = {"model_call": 0.0, "control_plane": 0.0}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[name] += time.perf_counter() - t
        return run

    engine._step = timed("model_call", engine._step)
    ctrl.step = timed("control_plane", ctrl.step)
    engine.start(num_slots=8)
    for r in reqs:
        engine.submit(r)
    # warm up until every slot decodes, then time `steps` iterations
    # without and `steps` with the profiler; the shortest request ends
    # after 15 decode steps, so both windows are decode-only at 8 slots
    sess = engine._session
    while len(sess.sched.running) < 8 or sess.iters < 2:
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        engine.step()
    torch.cuda.synchronize()
    wall_plain = (time.perf_counter() - t0) / args.steps
    host.update(model_call=0.0, control_plane=0.0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    host = {k: v / args.steps * 1e3 for k, v in host.items()}
    engine.run()
    engine.close()

    kern = sorted(((e.key, _device_us(e) / args.steps / 1e3)
                   for e in prof.key_averages()
                   if "cuda" in str(getattr(e, "device_type", "")).lower()
                   and _device_us(e) > 0), key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kern)
    print(f"card: {card}")
    print(f"mixtral-8x7b, {cfg.num_layers} of {full.num_layers} layers, "
          f"bf16, 8 slots all decoding; {args.steps} decode steps traced")
    print(f"per decode step: wall {wall_plain * 1e3:.3f} ms (profiler off), "
          f"{wall * 1e3:.3f} ms (profiler on); host (profiler on) "
          f"in model call "
          f"{host['model_call']:.3f} ms, in control plane "
          f"{host['control_plane']:.3f} ms")
    if busy == 0.0:
        print("device busy: not measured (the profiler saw no kernels)")
        return 1
    print(f"device busy {busy:.3f} ms per step ({len(kern)} kernel names); "
          f"idle share {max(0.0, 1 - busy / (wall_plain * 1e3)):.3f} of the "
          f"unprofiled step")
    for name, ms in kern[:15]:
        print(f"  {ms:9.4f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
