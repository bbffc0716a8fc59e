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

  # the EP slot plane over 4 local ranks (gloo; --device cuda shares
  # the one card between them)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --expert-runtime on --ep 4 --host-devices 4

  # one rank a card under torchrun (the backend is the caller's choice)
  torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --expert-runtime on --ep 4 --dist-backend nccl

On a mesh every rank serves the same requests (SPMD): the expert banks
are sharded over the ranks, the other layers run replicated, and rank 0
prints.

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
import datetime
import os

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
    ap.add_argument("--ep", type=int, default=0,
                    help="EP mesh degree for the slot data plane "
                         "(0 = one rank)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree inside each expert")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="spawn N local ranks on --device over gloo (CPU "
                         "multi-rank serving, or ranks sharing one card)")
    ap.add_argument("--dist-backend", default=None,
                    choices=("nccl", "gloo"),
                    help="process-group backend under torchrun (nccl: one "
                         "card a rank)")
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
    if args.gateway and (args.ep or args.tp > 1 or args.host_devices > 1):
        raise SystemExit("--ep/--tp/--host-devices serve a one-shot batch; "
                         "the gateway runs on one rank")
    if (args.ep or args.tp > 1) and args.expert_runtime != "on":
        raise SystemExit("--ep/--tp shard the EP slot plane: they need "
                         "--expert-runtime on")
    if args.host_devices > 1:
        if args.host_devices != max(args.ep, 1) * args.tp:
            raise SystemExit(f"--host-devices {args.host_devices} must "
                             f"equal ep x tp = {max(args.ep, 1) * args.tp}")
        if args.device.startswith("cuda"):
            from repro_torch.kernels import build as KB
            KB.build()     # once here, not once a rank
        from repro_torch.launch.mesh import spawn_local
        spawn_local(_host_rank, args.host_devices, backend="gloo",
                    args=(args,), wall_s=3600.0)
        return
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        _init_torchrun(args)
    _serve(args)


def _host_rank(rank: int, args) -> None:
    """One local rank of ``--host-devices``: the process group is up. On
    the CPU the ranks split the cores between them."""
    if args.device == "cpu":
        import torch
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // args.host_devices))
    _serve(args)


def _init_torchrun(args) -> None:
    """Join the process group torchrun describes in the environment, on
    the caller's backend (``--dist-backend``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import INIT_TIMEOUT_S
    if args.dist_backend is None:
        raise SystemExit("under torchrun, name the process-group backend: "
                         "--dist-backend nccl (one card a rank) or gloo")
    if args.dist_backend == "nccl" and args.device.startswith("cuda"):
        args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        torch.cuda.set_device(args.device)
    dist.init_process_group(
        args.dist_backend,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))


def _serve(args) -> None:
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
    mesh = None
    if args.ep or args.tp > 1:
        from repro_torch.launch.mesh import make_serving_mesh
        ep = args.ep or None
        mesh = make_serving_mesh(
            None if ep is None else ep * args.tp, ep=ep, tp=args.tp,
            device=params["embed"].device)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a: None)
    if mesh is not None:
        say(f"serving mesh: data={mesh.shape['data']} "
            f"ep={mesh.shape['ep']} tp={mesh.shape['tp']} over "
            f"{mesh.size} devices (backend {_backend()})")
    # the runtime executes the SESSION control plane's plans: attach the
    # controller there instead of as the per-iteration engine controller
    # (attached to both, it would step twice per iteration)
    session_ctrl = ctrl if args.expert_runtime == "on" else None
    engine = ServingEngine(cfg, params,
                           max_len=args.prompt_len + args.gen + 1,
                           controller=None if session_ctrl else ctrl,
                           impl=args.impl,
                           expert_runtime=args.expert_runtime,
                           mesh=mesh, telemetry=tel)
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    rng = np.random.default_rng(args.seed)
    reqs = [GenRequest(
        rid=i, arrival=0.0,
        prompt=rng.integers(0, cfg.vocab_size, size=args.prompt_len,
                            dtype=np.int32),
        max_new_tokens=args.gen, sampling=sampling)
        for i in range(args.requests)]
    engine.start(num_slots=args.slots, control=session_ctrl, requests=reqs)
    res = engine.run()
    s = res.summary()
    say(f"served {args.requests} requests x {args.gen} tokens "
        f"with {cfg.name} on {params['embed'].device} "
        f"(occupancy {res.mean_batch_occupancy:.1f}, "
        f"temperature={args.temperature}, kv={cfg.serving.kv})")
    kv = engine._session.kv
    if getattr(kv, "prefix", None) is not None:
        say(f"  prefix cache: hits={kv.prefix.hits} "
            f"tokens_saved={kv.prefix.tokens_saved} "
            f"cow_blocks={kv.cow_blocks}")
    say(f"  TTFT p50={s['ttft']['p50']*1e3:.2f} ms  "
        f"TPOT p50={s['tpot']['p50']*1e3:.3f} ms  "
        f"E2E p50={s['e2e']['p50']*1e3:.1f} ms (wall clock)")
    if ctrl is not None:
        reps = [p.total_replicas for p in ctrl.plans]
        stats = [ctrl.pool(l).stats for l in range(len(ctrl.plans))]
        say(f"  replica slots/layer: mean={np.mean(reps):.1f} "
            f"max={max(reps)}")
        say(f"  warm starts={sum(s.warm_starts for s in stats)} "
            f"cold={sum(s.cold_starts for s in stats)} "
            f"prewarmed={sum(s.prewarmed for s in stats)}")
    if res.runtime is not None:
        st = res.runtime.finalize(res.clock_s)
        say(f"  expert runtime [slot_dtype={args.slot_dtype}]: "
            f"c/w/p {st.cold_starts}/{st.warm_starts}/{st.prewarmed}, "
            f"{st.transfers} transfers, "
            f"{st.bytes_moved / 1e6:.1f}MB moved, "
            f"{st.instance_seconds_gb:.3g} GB-s resident")
        say(f"  overlap: {st.overlap_eligible_copies} eligible / "
            f"{st.exposed_copies} exposed copies, "
            f"{st.overlap_hidden_s:.3g}s hidden; per-rank MB "
            + str({r: round(b / 1e6, 2)
                   for r, b in sorted(st.rank_bytes.items())}))
    say("sample continuations:",
      np.asarray([r.tokens[:8] for r in reqs[:2]]))
    if tracer is not None and lead:
        n = tracer.write(args.trace_out)
        say(f"wrote {n} trace events to {args.trace_out} "
            "(load in https://ui.perfetto.dev)")


def _backend() -> str:
    import torch.distributed as dist
    return dist.get_backend() if dist.is_initialized() else "none"


if __name__ == "__main__":
    main()
