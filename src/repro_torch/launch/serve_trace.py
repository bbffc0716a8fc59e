"""The paper's end-to-end trace replay in the PyTorch port: replay an
Azure-like arrival trace through all four balancing strategies on
Mixtral-8x7B and Phi-3.5-MoE and reproduce the paper's headline
comparisons (§6.2, Figs. 8-10).

Two paths:
  default       — the analytic discrete-event simulator over the full
                  configs (synthetic Zipf expert loads).
  --real-model  — continuous batching over the real model (smoke
                  configs, float32): trace arrivals join and leave a
                  slot-pool batch mid-decode, expert loads come from the
                  model's routers, MoEless predictions from gate-replica
                  predictors, and each balancer's modeled latency drives
                  the serving clock -> per-request TTFT / TPOT / E2E
                  percentiles per balancer. On the CUDA card unless
                  ``--device cpu``.

Every time printed from the serving clock is the reference cost model's
(``core/costmodel.py:V5E``, TPU v5e constants) times ``--time-scale``;
the wall column is this replay's own.

  PYTHONPATH=src python -m repro_torch.launch.serve_trace --duration 20
  PYTHONPATH=src python -m repro_torch.launch.serve_trace --device cpu \\
      --real-model --duration 3 --slots 2 --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.serve_trace --device cpu \\
      --real-model --duration 3 --expert-runtime on --slot-dtype int8
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import SLOT_DTYPES
from repro_torch.core.simulator import ServingSimulator
from repro_torch.core.trace import TraceConfig, generate_requests
from repro_torch.kernels import IMPLS

STRATEGIES = ("megatron-lm", "eplb", "oracle", "moeless")
ARCHS = ("mixtral-8x7b", "phi-3.5-moe")


def run_simulator(args):
    for arch in ARCHS:
        cfg = get_config(arch)
        sim = ServingSimulator(
            cfg, num_devices=args.devices,
            trace=TraceConfig(duration_s=args.duration,
                              base_rate=args.rate))
        res = sim.run_all()
        base = res["megatron-lm"]
        print(f"\n=== {arch} ({args.devices} devices, "
              f"{args.duration:.0f}s trace) ===")
        print(f"{'strategy':12s} {'mean ms':>8s} {'p99 ms':>8s} "
              f"{'cost':>10s} {'replicas':>9s} {'lat red':>8s} "
              f"{'cost red':>9s}")
        for k, r in res.items():
            print(f"{k:12s} {r.mean_ms():8.3f} {r.p99_ms():8.3f} "
                  f"{r.total_cost:10.2f} "
                  f"{r.mean_replicas_per_layer:9.1f} "
                  f"{(1 - r.mean_ms() / base.mean_ms()) * 100:7.1f}% "
                  f"{(1 - r.total_cost / base.total_cost) * 100:8.1f}%")
        m, e = res["moeless"], res["eplb"]
        print(f"paper check: latency -43.2% vs Megatron (ours "
              f"{(1 - m.mean_ms() / base.mean_ms()) * 100:.1f}%), "
              f"-21.9% vs EPLB (ours "
              f"{(1 - m.mean_ms() / e.mean_ms()) * 100:.1f}%)")


def arch_seed(seed: int, index: int) -> int:
    """The weights' seed of the `index`-th arch: the smoke configs of the
    two archs coincide (<= 4 experts), so the index is folded into the
    seed to make their weights differ."""
    return int(np.random.SeedSequence((seed, index)).generate_state(1)[0])


class Replay(NamedTuple):
    """One strategy's replay: the engine's result, the session control
    plane, the runtime's settled meters (None with the runtime off), the
    served requests (their tokens), the trace's clip report and the wall
    seconds of each serving iteration (admission and prefill included)."""
    result: object
    control: object
    stats: object
    requests: list
    clip: object
    iter_walls: list


def replay(cfg, params, trace, strategy: str, *, slots: int = 8,
           max_len: int = 128, max_new: int = 32, distance: int = 1,
           sampling=None, expert_runtime: str = "off",
           time_scale: float = 5000.0, seed: int = 0, telemetry=None,
           predictor=None, name: str = "", runtime_double_buffer=True,
           **control_kw) -> Replay:
    """Serve `trace` (``core.trace.Request`` list) with continuous
    batching under one balancing strategy: fresh requests from the trace
    (``requests_from_trace``), a fresh engine and a session
    ``ControlPlane(cfg, strategy, **control_kw)`` whose modeled latency
    drives the serving clock. MoEless plans from `predictor` (by default
    the model's gate replicas at `distance`); the other strategies get
    none. `runtime_double_buffer` is the engine's (False: the expert
    runtime writes replica copies into the bank the step reads, half the
    bank memory)."""
    from repro_torch.core.control import ControlPlane
    from repro_torch.core.predictor import from_gates
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import GREEDY, requests_from_trace
    name = name or f"{cfg.name}/{strategy}"
    if strategy == "moeless" and predictor is None:
        predictor = from_gates(cfg, params, distance=distance)
    engine = ServingEngine(cfg, params, max_len=max_len,
                           expert_runtime=expert_runtime,
                           telemetry=telemetry, name=name,
                           runtime_double_buffer=runtime_double_buffer)
    # each replay has its own serving clock starting at t=0, so its
    # control plane gets a trace track of its own
    control = ControlPlane(
        cfg, strategy, predictor=predictor if strategy == "moeless"
        else None, prediction_distance=distance, telemetry=telemetry,
        track=f"{name}/control", **control_kw)
    reqs, clip = requests_from_trace(
        trace, cfg.vocab_size, max_len=max_len, seed=seed,
        max_new_cap=max_new,
        sampling=GREEDY if sampling is None else sampling)
    walls: list[float] = []
    last = [0.0]

    def lap(_events):
        now = time.perf_counter()
        walls.append(now - last[0])
        last[0] = now

    engine.add_step_hook(lap)
    last[0] = time.perf_counter()
    res = engine.serve(reqs, num_slots=slots, control=control,
                       time_scale=time_scale)
    stats = None if res.runtime is None else \
        res.runtime.finalize(res.clock_s)
    return Replay(res, control, stats, reqs, clip, walls)


def row(strategy: str, rp: Replay) -> str:
    """The reference's row of one replay: modeled TTFT/TPOT/E2E
    percentiles, mean layer ms and cost, then the replay's wall."""
    res, control, st = rp.result, rp.control, rp.stats
    s = res.summary()
    rt_info = ""
    if st is not None:
        pf = st.by_phase.get("prefill", {})
        rt_info = (f", runtime c/w/p "
                   f"{st.cold_starts}/{st.warm_starts}/"
                   f"{st.prewarmed}, "
                   f"{st.bytes_moved / 1e6:.1f}MB moved, "
                   f"{st.instance_seconds_gb:.3g} GB-s resident, "
                   f"{pf.get('iterations', 0)} EP prefills")
    return (f"{strategy:12s} {len(res.records):5d} "
            f"{res.iterations:6d} {res.mean_batch_occupancy:5.1f} "
            f"{s['ttft']['p50']*1e3:8.2f}/{s['ttft']['p99']*1e3:8.2f} "
            f"{s['tpot']['p50']*1e3:8.3f}/{s['tpot']['p99']*1e3:8.3f} "
            f"{s['e2e']['p50']*1e3:8.1f}/{s['e2e']['p99']*1e3:8.1f} "
            f"{control.mean_layer_ms():9.4f} {control.cost:9.3g} "
            f"{res.wall_s:8.2f} "
            f"[e2e mean {s['e2e']['mean']*1e3:.1f}ms over "
            f"n={s['e2e']['count']} "
            f"(tpot n={s['tpot']['count']}), "
            f"{control.host_transfers} host syncs, "
            f"{res.dropped_tokens:.0f} dropped{rt_info}]")


def run_real_model(args):
    from repro_torch.core.predictor import from_gates
    from repro_torch.models.model import init_params
    from repro_torch.serving.scheduler import SamplingParams

    # seed=None derives each request's RNG stream from its rid — still
    # deterministic across runs, but requests never share a stream
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    tracer = tel = None
    if args.trace_out:
        from repro_torch.obs import Telemetry, Tracer
        tracer = Tracer(process_name="serve-trace")
        tel = Telemetry(tracer=tracer)
    for ai, arch in enumerate(ARCHS):
        cfg = get_config(arch, smoke=True).with_(dtype="float32",
                                                 impl=args.impl)
        # slot_dtype is a config rewrite, not an engine knob: the control
        # plane's cost coefficients and the runtime's slot banks both
        # derive their byte base from cfg, so they can never disagree
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, slot_dtype=args.slot_dtype))
        params = init_params(cfg, arch_seed(args.seed, ai),
                             device=args.device)
        predictor = from_gates(cfg, params, distance=args.distance)
        trace = generate_requests(TraceConfig(
            duration_s=args.duration, base_rate=args.rate, seed=args.seed))
        rt_note = ", expert runtime ON (EP slot data plane)" \
            if args.expert_runtime == "on" else ""
        if args.slot_dtype != "fp32":
            rt_note += f", slot_dtype={args.slot_dtype}"
        print(f"\n=== {arch} [real model, continuous batching, "
              f"impl={args.impl}, device={params['embed'].device}, "
              f"temperature={args.temperature}{rt_note}] "
              f"({len(trace)} requests, "
              f"{args.slots} KV slots, {args.devices} modeled devices) ===")
        print(f"TTFT/TPOT/E2E and layer ms: modeled (v5e cost model) "
              f"serving clock x time_scale {args.time_scale:g}; wall s: "
              f"this replay's")
        print(f"{'strategy':12s} {'reqs':>5s} {'iters':>6s} {'occ':>5s} "
              f"{'TTFT p50/p99 ms':>17s} {'TPOT p50/p99 ms':>17s} "
              f"{'E2E p50/p99 ms':>17s} {'layer ms':>9s} {'cost':>9s} "
              f"{'wall s':>8s}")
        clip = None
        for strategy in STRATEGIES:
            rp = replay(cfg, params, trace, strategy, slots=args.slots,
                        max_len=args.max_len, max_new=args.max_new,
                        distance=args.distance, sampling=sampling,
                        expert_runtime=args.expert_runtime,
                        time_scale=args.time_scale, seed=args.seed,
                        telemetry=tel, predictor=predictor,
                        name=f"{arch}/{strategy}",
                        num_devices=args.devices)
            clip = rp.clip
            print(row(strategy, rp))
        if clip is not None and clip.any:
            print(f"note: trace clipped to fit max_len={args.max_len} "
                  f"slots ({clip})")
    if tracer is not None:
        n = tracer.write(args.trace_out)
        print(f"\nwrote {n} trace events to {args.trace_out} "
              "(load in https://ui.perfetto.dev)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--real-model", action="store_true",
                    help="continuous batching over the real model "
                         "(smoke configs) instead of the simulator")
    ap.add_argument("--slots", type=int, default=8,
                    help="KV slot pool size (max concurrent requests)")
    ap.add_argument("--max-len", type=int, default=128,
                    help="per-slot KV capacity (prompt + generation)")
    ap.add_argument("--max-new", type=int, default=32,
                    help="cap on generated tokens per request "
                         "(real-model path)")
    ap.add_argument("--distance", type=int, default=1,
                    help="MoEless prediction distance d")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature for the "
                         "real-model replay (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k sampling filter (0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1 = disabled)")
    ap.add_argument("--impl", default="auto", choices=IMPLS,
                    help="kernel backend for the real-model hot paths "
                         "(expert FFN, decode attention); auto = the "
                         "CUDA kernels on a CUDA tensor, the plain "
                         "versions on a CPU one")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the real-model path (default: "
                         "the CUDA card; raises where none is present)")
    ap.add_argument("--expert-runtime", default="off",
                    choices=("off", "on"),
                    help="execute the control plane's replica plans: "
                         "'on' applies each iteration's plans as slot "
                         "diffs to device-resident expert weight banks "
                         "and runs BOTH prefill and decode MoE layers "
                         "through the EP slot data plane, with "
                         "drop-equivalent capacity semantics to the "
                         "dispatch path (real-model path only)")
    ap.add_argument("--slot-dtype", default="fp32", choices=SLOT_DTYPES,
                    help="storage format of the serverless expert slot "
                         "banks (real-model path): 'int8' quantizes the "
                         "banks once (symmetric per-row scales) so every "
                         "cold start moves ~4x fewer bytes and residency "
                         "bills ~4x fewer GB-s, dequantizing inside the "
                         "expert-FFN kernels")
    ap.add_argument("--time-scale", type=float, default=5000.0,
                    help="serving-clock multiplier for the real-model "
                         "path: smoke-model modeled latencies are ~1000x "
                         "faster than the full models the trace was "
                         "shaped for; scaling restores a realistic "
                         "arrival/service ratio so batches actually fill")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON of the "
                         "real-model replay (Perfetto / chrome://tracing)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.trace_out and not args.real_model:
        ap.error("--trace-out requires --real-model (the simulator path "
                 "has no serving engine to trace)")
    if args.real_model:
        run_real_model(args)
    else:
        run_simulator(args)


if __name__ == "__main__":
    main()
