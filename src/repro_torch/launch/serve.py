"""Serving launcher of the PyTorch port: requests through the
ServingEngine's request-level API (submit / run) with the MoEless
control plane attached, on the CUDA card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --requests 8 --prompt-len 32 --gen 16 --temperature 0.8

  # paged KV, chunked prefill and the radix prefix cache, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --kv-block 16 --prefill-chunk 8 --prefix-cache

  # the expert runtime on the EP slot plane (ep=1), int8 slot banks
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --expert-runtime on --slot-dtype int8

``--gateway`` boots the OpenAI-compatible HTTP front door instead: an
asyncio server exposing /v1/completions + /v1/chat/completions (token-id
prompts, SSE streaming), /healthz and /metrics over a router of engine
replicas that share one parameter set, with meter-driven autoscaling
between ``--replicas min:max``:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --gateway --port 0 --replicas 1:2 --slots 4 --max-pending 64

The model is the architecture's reduced (smoke) config with random
weights from ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import ServingSpec, get_config
from repro_torch.kernels import IMPLS


def _parse_replicas(spec: str) -> tuple[int, int]:
    """'N' or 'MIN:MAX' -> (min, max)."""
    lo, _, hi = spec.partition(":")
    try:
        lo_i = int(lo)
        hi_i = int(hi) if hi else lo_i
    except ValueError:
        raise SystemExit(f"--replicas {spec!r}: expected N or MIN:MAX")
    if not 1 <= lo_i <= hi_i:
        raise SystemExit(f"--replicas {spec!r}: need 1 <= min <= max")
    return lo_i, hi_i


def _run_gateway(args, cfg, params, max_len: int) -> None:
    import asyncio

    from repro_torch.obs import Telemetry, Tracer
    from repro_torch.serving.engine import MoElessController, ServingEngine
    from repro_torch.serving.gateway import (AutoscalerConfig, EngineDriver,
                                             GatewayServer, Router)

    lo, hi = _parse_replicas(args.replicas)
    # the gateway always serves /metrics, so telemetry is always live
    # here; a session control plane is attached to every MoE replica so
    # the control-plane families are populated even without the expert
    # runtime (generated tokens are unchanged either way)
    tracer = Tracer(process_name="repro-gateway") if args.trace_out \
        else None
    tel = Telemetry(tracer=tracer)
    use_ctrl = cfg.is_moe and not args.no_moeless

    def factory(i: int) -> EngineDriver:
        # replicas share the one parameter set; each owns its engine,
        # session and control plane (controllers hold per-balancer
        # mutable state and are never shared); all share one registry
        ctrl = MoElessController(cfg, num_devices=args.devices,
                                 telemetry=tel,
                                 track=f"replica{i}/control") \
            if use_ctrl else None
        eng = ServingEngine(cfg, params, max_len=max_len, impl=args.impl,
                            expert_runtime=args.expert_runtime,
                            telemetry=tel, name=f"replica{i}")
        return EngineDriver(eng, replica_id=i, num_slots=args.slots,
                            max_pending=args.max_pending, control=ctrl)

    router = Router(factory, telemetry=tel, scaler=AutoscalerConfig(
        min_replicas=lo, max_replicas=hi,
        queue_delay_up_s=args.scale_up_delay,
        idle_gb_s_down=args.scale_down_idle_gb_s))

    async def _main():
        srv = GatewayServer(router, host=args.host, port=args.port)
        host, port = await srv.start()
        print(f"GATEWAY READY http://{host}:{port} "
              f"arch={cfg.name} device={params['embed'].device} "
              f"replicas={lo}:{hi} slots={args.slots} max_len={max_len} "
              f"max_pending={args.max_pending}", flush=True)
        try:
            await srv.serve_forever()
        finally:
            await srv.close()

    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()
        if tracer is not None:
            n = tracer.write(args.trace_out)
            print(f"wrote {n} trace events to {args.trace_out} "
                  "(load in https://ui.perfetto.dev)")


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
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
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
    ap.add_argument("--gateway", action="store_true",
                    help="serve the OpenAI-compatible HTTP gateway "
                         "instead of running a one-shot batch")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="gateway port (0 = pick a free one)")
    ap.add_argument("--replicas", default="1",
                    help="engine replica count: N or MIN:MAX "
                         "(MAX > MIN enables autoscaling)")
    ap.add_argument("--max-pending", type=int, default=64,
                    help="per-replica admission queue bound; beyond it "
                         "the gateway answers HTTP 429")
    ap.add_argument("--max-len", type=int, default=0,
                    help="gateway KV slot capacity in tokens "
                         "(0 = prompt-len + gen + 1)")
    ap.add_argument("--scale-up-delay", type=float, default=0.5,
                    help="sustained queue delay (s) that adds a replica")
    ap.add_argument("--scale-down-idle-gb-s", type=float, default=1.0,
                    help="idle GB-s burn that retires a replica")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON of the run "
                         "(load in Perfetto / chrome://tracing)")
    args = ap.parse_args(argv)

    from repro_torch.models import model as M
    from repro_torch.serving.engine import MoElessController, ServingEngine
    from repro_torch.serving.scheduler import GenRequest, SamplingParams

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
    if args.gateway:
        max_len = args.max_len or args.prompt_len + args.gen + 1
        _run_gateway(args, cfg, params, max_len)
        return
    tel = tracer = None
    if args.trace_out:
        from repro_torch.obs import Telemetry, Tracer
        tracer = Tracer()
        tel = Telemetry(tracer=tracer)
    ctrl = None
    if cfg.is_moe and not args.no_moeless:
        ctrl = MoElessController(cfg, num_devices=args.devices,
                                 telemetry=tel)
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
                           expert_runtime=args.expert_runtime,
                           telemetry=tel)
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    rng = np.random.default_rng(args.seed)
    engine.start(num_slots=args.slots, control=session_ctrl)
    handles = [engine.submit(GenRequest(
        rid=i, arrival=0.0,
        prompt=rng.integers(0, cfg.vocab_size, size=args.prompt_len,
                            dtype=np.int32),
        max_new_tokens=args.gen, sampling=sampling))
        for i in range(args.requests)]
    res = engine.run()
    s = res.summary()
    print(f"served {args.requests} requests x {args.gen} tokens "
          f"with {cfg.name} on {params['embed'].device} "
          f"(occupancy {res.mean_batch_occupancy:.1f}, "
          f"temperature={args.temperature}, kv={cfg.serving.kv})")
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
    if tracer is not None:
        n = tracer.write(args.trace_out)
        print(f"wrote {n} trace events to {args.trace_out} "
              "(load in https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
