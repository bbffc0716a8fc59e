"""Serving launcher of the PyTorch port: requests through the
ServingEngine's request-level API (submit / run) with the MoEless
control plane attached, on the CUDA card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --requests 8 --prompt-len 32 --gen 16

  # paged KV, chunked prefill and the radix prefix cache, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --kv-block 16 --prefill-chunk 8 --prefix-cache

  # the expert runtime on the EP slot plane (ep=1), int8 slot banks
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --expert-runtime on --slot-dtype int8

The model is the architecture's reduced (smoke) config with random
weights from ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import ServingSpec, get_config
from repro_torch.kernels import IMPLS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--devices", type=int, default=8,
                    help="EP devices the control plane plans replicas for")
    ap.add_argument("--slots", type=int, default=8,
                    help="KV slot pool size (max concurrent requests)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-moeless", action="store_true")
    ap.add_argument("--impl", default="auto", choices=IMPLS,
                    help="kernel backend (repro_torch.kernels.ops)")
    ap.add_argument("--kv-block", type=int, default=0,
                    help="paged-KV block size in tokens (0 = contiguous "
                         "per-slot KV layout)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="fold prompt prefill into the batched decode "
                         "step, <= N prompt tokens per request per "
                         "iteration (0 = solo prefill; needs --kv-block)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prompt-prefix sharing over the paged "
                         "pool (needs --prefill-chunk)")
    ap.add_argument("--expert-runtime", default="off", choices=("off", "on"),
                    help="execute the control plane's replica plans as "
                         "slot diffs on device-resident expert banks and "
                         "route every MoE layer through the EP slot data "
                         "plane (needs the MoEless control plane)")
    ap.add_argument("--slot-dtype", default="fp32", choices=("fp32", "int8"),
                    help="expert slot-bank storage: fp32 = the model's "
                         "dtype, int8 = per-row symmetric int8 with fp32 "
                         "scales (dequantizing kernels)")
    ap.add_argument("--capacity-factor", type=float, default=0.0,
                    help="override the MoE capacity factor (0 = arch "
                         "default)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.models import model as M
    from repro_torch.serving.engine import MoElessController, ServingEngine
    from repro_torch.serving.scheduler import GenRequest

    cfg = get_config(args.arch, smoke=True)
    if args.prefill_chunk and not args.kv_block:
        raise SystemExit("--prefill-chunk needs --kv-block (chunked "
                         "prefill runs over the paged pool)")
    if args.prefix_cache and not args.prefill_chunk:
        raise SystemExit("--prefix-cache needs --prefill-chunk (partial "
                         "prefix hits resume mid-prompt)")
    if args.kv_block:
        cfg = cfg.with_(serving=ServingSpec(
            kv="paged", kv_block=args.kv_block,
            prefill_chunk=args.prefill_chunk,
            prefix_cache=args.prefix_cache))
    if args.capacity_factor > 0 and cfg.is_moe:
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=args.capacity_factor))
    if cfg.is_moe:
        # before the controller and the engine exist, so the control
        # plane's cost coefficients and the runtime's slot banks derive
        # the same byte base
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, slot_dtype=args.slot_dtype))
    cfg = cfg.with_(impl=args.impl)
    params = M.init_params(cfg, args.seed, device=args.device)
    ctrl = None
    if cfg.is_moe and not args.no_moeless:
        ctrl = MoElessController(cfg, num_devices=args.devices)
    if args.expert_runtime == "on" and ctrl is None:
        raise SystemExit("--expert-runtime on needs an MoE arch with the "
                         "MoEless control plane (drop --no-moeless)")
    # the runtime executes the SESSION control plane's plans: attach the
    # controller there instead of as the per-iteration engine controller
    # (attached to both, it would step twice per iteration)
    session_ctrl = ctrl if args.expert_runtime == "on" else None
    engine = ServingEngine(cfg, params,
                           max_len=args.prompt_len + args.gen + 1,
                           controller=None if session_ctrl else ctrl,
                           impl=args.impl,
                           expert_runtime=args.expert_runtime)
    rng = np.random.default_rng(args.seed)
    engine.start(num_slots=args.slots, control=session_ctrl)
    handles = [engine.submit(GenRequest(
        rid=i, arrival=0.0,
        prompt=rng.integers(0, cfg.vocab_size, size=args.prompt_len,
                            dtype=np.int32),
        max_new_tokens=args.gen))
        for i in range(args.requests)]
    res = engine.run()
    s = res.summary()
    print(f"served {args.requests} requests x {args.gen} tokens "
          f"with {cfg.name} on {params['embed'].device} "
          f"(occupancy {res.mean_batch_occupancy:.1f}, greedy, "
          f"kv={cfg.serving.kv})")
    kv = engine._session.kv
    if getattr(kv, "prefix", None) is not None:
        print(f"  prefix cache: hits={kv.prefix.hits} "
              f"tokens_saved={kv.prefix.tokens_saved} "
              f"cow_blocks={kv.cow_blocks}")
    print(f"  TTFT p50={s['ttft']['p50']*1e3:.2f} ms  "
          f"TPOT p50={s['tpot']['p50']*1e3:.3f} ms  "
          f"E2E p50={s['e2e']['p50']*1e3:.1f} ms (wall clock)")
    if ctrl is not None:
        reps = [p.total_replicas for p in ctrl.plans]
        stats = [ctrl.pool(l).stats for l in range(len(ctrl.plans))]
        print(f"  replica slots/layer: mean={np.mean(reps):.1f} "
              f"max={max(reps)}")
        print(f"  warm starts={sum(s.warm_starts for s in stats)} "
              f"cold={sum(s.cold_starts for s in stats)} "
              f"prewarmed={sum(s.prewarmed for s in stats)}")
    if res.runtime is not None:
        st = res.runtime.finalize(res.clock_s)
        print(f"  expert runtime [slot_dtype={args.slot_dtype}]: "
              f"c/w/p {st.cold_starts}/{st.warm_starts}/{st.prewarmed}, "
              f"{st.transfers} transfers, "
              f"{st.bytes_moved / 1e6:.1f}MB moved, "
              f"{st.instance_seconds_gb:.3g} GB-s resident")
        print(f"  overlap: {st.overlap_eligible_copies} eligible / "
              f"{st.exposed_copies} exposed copies, "
              f"{st.overlap_hidden_s:.3g}s hidden; per-rank MB "
              + str({r: round(b / 1e6, 2)
                     for r, b in sorted(st.rank_bytes.items())}))
    print("sample continuations:",
          np.asarray([h.tokens[:8] for h in handles[:2]]))


if __name__ == "__main__":
    main()
