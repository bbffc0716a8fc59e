"""Where a serving decode step spends its time on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        [--kv contiguous,paged]
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        --layers 4 --kv contiguous,ep-int8
    PYTHONPATH=src python -m repro_torch.launch.profile_decode --prefill 10
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        --kv paged --temperature 0,0.8
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        --predictor 0,1
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        --arch jamba-v0.1-52b --layers 8 --prefill 3

Serves the same traffic as ``chip_smoke.py``'s full-width phase
(``--arch``, mixtral-8x7b by default, at its published widths, depth cut
to ``--layers``, bf16, random seeded weights, a MoE arch with
``MoElessController`` attached, 8 slots, 12
requests with prompts of 128/256/384/512 tokens and 16/32/48 new
tokens, all arriving at t=0) through one engine per KV layout named in
``--kv``: ``contiguous`` (the slot cache, solo prefill) and ``paged``
(16-token blocks, 256-token chunked prefill, prefix cache) and
``ep-int8`` (the slot cache with the expert runtime on: the session
controller's plans executed on int8 slot banks of 8 slots a device,
every MoE layer through the EP slot plane, as ``chip_smoke.py``'s phase
4c; its single-buffered 64-slot bank and padded quantized bank take
12.9 GB a layer, so it runs at ``--layers 4`` or fewer), once per
temperature named in ``--temperature`` (0: greedy; above 0 every request
samples with top-k 50, top-p 0.95 and a seed of its own, so each step
runs ``sample_tokens``), and once per entry of ``--predictor`` (1: the
controller carries the expert load predictor, gate replicas at distance
1 from ``core.predictor.from_gates``, so each step runs its
``predict_loads_all``; 0: the controller plans from the actual loads).
The engines share the weights and live in one
process. Once every slot of each decodes, each layout's next ``--steps`` steps are traced with
``torch.profiler`` and one more runs under
``torch.cuda.set_sync_debug_mode``; then the engines take turns, one
step each, until the first runs out of work. A round counts where every
engine's step was decode-only at 8 slots; alternating step by step puts
host drift into every layout alike.

Prints, per layout: the wall time of the counted steps, the host time in
the model call and in the control plane (medians), the CPU time of the
calling thread and of the whole process per step (means: those clocks
tick coarsely; a process share above the thread's means other threads
were running), the median paired
difference against the first layout, and from the traced steps the
device busy time (one stream, so kernels do not overlap) and the kernel
launches a step, the device's idle share of the untraced step, the kernels by device time, the host
operators by their own host time, and the call sites that block the
host on the device. With a temperature above 0, the sampler alone is
also traced at the decode step's shape (8 rows, the padded vocabulary):
its kernel launches and device time a call; with a predictor, its
``predict_loads_all`` alone likewise at the decode step's 8 tokens and
at a 512-token prefill. With ``--prefill N``, the
first engine then prefills one prompt of each bucket length (128, 256,
512) N times (solo prefill, as a request's admission runs it) and once
more traced:
per bucket, the wall time (median), the device busy time of the traced
prefill and the idle share, and its kernels by device time. Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import collections
import subprocess
import time
import warnings
from pathlib import Path

import numpy as np
import torch


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _device_events(prof):
    return [e for e in prof.key_averages()
            if "cuda" in str(getattr(e, "device_type", "")).lower()
            and _device_us(e) > 0]


def _kernel_ms(prof, steps: int) -> list[tuple[str, float]]:
    """(kernel name, device ms per step) of a trace over `steps` steps,
    largest first."""
    return sorted(((e.key, _device_us(e) / steps / 1e3)
                   for e in _device_events(prof)), key=lambda kv_: -kv_[1])


def _launches(prof, steps: int) -> float:
    """Kernel launches per step (device events other than copies and
    fills)."""
    return sum(e.count for e in _device_events(prof)
               if not e.key.startswith(("Memcpy", "Memset"))) / steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv", default="contiguous",
                    help="comma-separated KV layouts: contiguous, paged")
    ap.add_argument("--prefill", type=int, default=0,
                    help="solo prefills timed per bucket (0: none)")
    ap.add_argument("--temperature", default="0",
                    help="comma-separated sampling temperatures, one "
                         "engine per layout and temperature (0: greedy)")
    ap.add_argument("--predictor", default="0",
                    help="comma-separated 0/1: one engine each without "
                         "and with the load predictor on its controller")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    import dataclasses

    from repro_torch.configs import ServingSpec, get_config
    from repro_torch.core.predictor import from_gates
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import MoElessController, ServingEngine
    from repro_torch.serving.scheduler import GenRequest, SamplingParams

    specs = {"contiguous": ServingSpec(),
             "paged": ServingSpec(kv="paged", kv_block=16,
                                  prefill_chunk=256, prefix_cache=True),
             "ep-int8": ServingSpec()}
    layouts = args.kv.split(",")
    if not layouts or any(k not in specs for k in layouts):
        raise SystemExit(f"profile_decode: --kv takes {', '.join(specs)}")
    temps = [float(t) for t in args.temperature.split(",")]
    preds = [int(p) for p in args.predictor.split(",")]
    if any(p not in (0, 1) for p in preds):
        raise SystemExit("profile_decode: --predictor takes 0 and 1")
    runs = [(kv + ("" if len(temps) == 1 else f"@t={t:g}")
             + ("" if len(preds) == 1 else f"@predictor={p}"), kv, t, p)
            for kv in layouts for t in temps for p in preds]
    names = [name for name, _, _, _ in runs]
    if "ep-int8" in layouts and args.layers > 4:
        raise SystemExit("profile_decode: ep-int8 holds 12.9 GB of slot "
                         "banks a layer; use --layers 4 or fewer")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    full = get_config(args.arch)
    cfg = full.with_(num_layers=args.layers)
    if not cfg.is_moe and ("ep-int8" in layouts or max(preds)):
        raise SystemExit(f"profile_decode: {cfg.name} has no MoE layer for "
                         "the expert runtime or the load predictor")
    params = init_params(cfg, seed=args.seed, device="cuda")
    lens, gens = (128, 256, 384, 512), (16, 32, 48)

    def timed(host, name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[name] += time.perf_counter() - t
        return run

    # host seconds spent in the model call (enqueueing its kernels) and
    # in the control plane (its one device->host sync included)
    engines, hosts = {}, {}
    for name, kv, temp, with_pred in runs:
        runtime = kv == "ep-int8"
        c = cfg.with_(moe=dataclasses.replace(cfg.moe, slot_dtype="int8")) \
            if runtime else cfg
        # with the runtime on, the controller is the session's: its plans
        # are executed by the runtime's apply, timed on its own
        ctrl = MoElessController(c, num_devices=8,
                                 slots_per_device=8 if runtime else 0,
                                 predictor=from_gates(c, params, 1)
                                 if with_pred else None) \
            if c.is_moe else None
        engine = ServingEngine(c, params, max_len=512 + 48 + 1,
                               controller=None if runtime else ctrl,
                               serving=specs[kv],
                               expert_runtime="on" if runtime else "off",
                               runtime_double_buffer=False)
        host = hosts[name] = {"model_call": 0.0, "control_plane": 0.0,
                            "runtime": 0.0}
        engine._step = timed(host, "model_call", engine._step)
        if ctrl is not None:
            ctrl.step = timed(host, "control_plane", ctrl.step)
        rng = np.random.default_rng(args.seed)
        engine.start(num_slots=8, control=ctrl if runtime else None)
        rt = engine._session.runtime
        if rt is not None:
            rt.apply = timed(host, "runtime", rt.apply)
        for i in range(12):
            engine.submit(GenRequest(
                rid=i, arrival=0.0, max_new_tokens=gens[i % 3],
                prompt=rng.integers(0, cfg.vocab_size, size=lens[i % 4],
                                    dtype=np.int32),
                sampling=SamplingParams(temperature=temp, top_k=50,
                                        top_p=0.95, seed=i)))
        engines[name] = engine

    def prefilling(sess):   # chunked loop: a slot still feeding its prompt
        return any(sess.kv.lengths[s] < sess.plen[s]
                   for s in sess.sched.running)

    def decode_only(sess):
        return len(sess.sched.running) == 8 and not prefilling(sess)

    # warm up until every slot decodes; the shortest request ends after
    # 15 decode steps, so the traced and sync-checked steps are
    # decode-only at 8 slots
    for kv, engine in engines.items():
        sess = engine._session
        while len(sess.sched.running) < 8 or sess.iters < 2 \
                or prefilling(sess):
            engine.step()
    torch.cuda.synchronize()
    traces, syncs = {}, {}
    for kv, engine in engines.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                engine.step()
            torch.cuda.synchronize()
        traces[kv] = (prof, (time.perf_counter() - t0) / args.steps)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                engine.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs[kv] = collections.Counter(
            f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message))

    # the engines take turns, one step each; a round counts where every
    # step was decode-only at 8 slots (no admission, no prompt chunk)
    rows = {name: [] for name in names}
    while all(not e._session.sched.done for e in engines.values()):
        rnd = {}
        for kv, engine in engines.items():
            sess = engine._session
            ok = decode_only(sess)
            prefills = sess.prefills
            hosts[kv].update(model_call=0.0, control_plane=0.0, runtime=0.0)
            c0, m0 = time.process_time(), time.thread_time()
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rnd[kv] = (ok and sess.prefills == prefills,
                       (wall, hosts[kv]["model_call"],
                        hosts[kv]["control_plane"], hosts[kv]["runtime"],
                        time.thread_time() - m0,
                        time.process_time() - c0))
        if all(ok for ok, _ in rnd.values()):
            for kv, (_, row) in rnd.items():
                rows[kv].append(row)
    for engine in engines.values():
        engine.run()
    sampler = trace_sampler(cfg.padded_vocab) if max(temps) > 0 else None
    predictor = [(n, trace_predictor(from_gates(cfg, params, 1), cfg, n))
                 for n in (8, 512)] if max(preds) else []
    prefill_rows = _time_prefills(engines[names[0]], cfg, args, profile,
                                  ProfilerActivity)
    for engine in engines.values():
        engine.close()

    print(f"card: {card}")
    print(f"{cfg.name}, {cfg.num_layers} of {full.num_layers} layers, "
          f"{cfg.dtype}, 8 slots all decoding; layouts {', '.join(names)} in "
          f"one process, taking turns step by step; {len(rows[names[0]])}"
          f" rounds counted, {args.steps} steps traced per layout")
    if not rows[names[0]]:
        print("no round was decode-only in every layout")
        return 1
    base = np.asarray(rows[names[0]]) * 1e3
    status = 0
    for kv in names:
        r = np.asarray(rows[kv]) * 1e3
        wall, model, ctl, rtm = np.median(r[:, :4], axis=0)
        thread, proc = r[:, 4:].mean(axis=0)   # CPU clocks tick coarsely
        print(f"== kv={kv}")
        print(f"per decode step (median of the counted rounds): wall "
              f"{wall:.3f} ms; host in model call {model:.3f} ms, in "
              f"control plane {ctl:.3f} ms, in the expert runtime's apply "
              f"{rtm:.3f} ms; CPU time (mean) of this thread "
              f"{thread:.3f} ms, of the process {proc:.3f} ms")
        if kv != names[0]:
            d = r[:, 0] - base[:, 0]
            print(f"wall minus kv={names[0]}, same round: median "
                  f"{np.median(d):+.3f} ms, p10 {np.percentile(d, 10):+.3f},"
                  f" p90 {np.percentile(d, 90):+.3f}")
        prof, wall_on = traces[kv]
        print(f"traced steps: wall {wall_on * 1e3:.3f} ms (profiler on)")
        print(f"host-blocking calls in one step: "
              f"{dict(syncs[kv].most_common()) or 'none'}")
        kern = _kernel_ms(prof, args.steps)
        busy = sum(ms for _, ms in kern)
        if busy == 0.0:
            print("device busy: not measured (the profiler saw no kernels)")
            status = 1
            continue
        print(f"device busy {busy:.3f} ms per step ({len(kern)} kernel "
              f"names, {_launches(prof, args.steps):.1f} kernel launches a "
              f"step); idle share {max(0.0, 1 - busy / wall):.3f} of the "
              f"untraced step")
        for name, ms in kern[:15]:
            print(f"  {ms:9.4f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")
        ops = sorted(((e.key, e.count / args.steps,
                       e.self_cpu_time_total / args.steps / 1e3)
                      for e in prof.key_averages()
                      if e.self_cpu_time_total > 0), key=lambda t: -t[2])
        print("host operators by own host time per step (profiler on):")
        for name, calls, ms in ops[:12]:
            print(f"  {ms:9.4f} ms  {calls:7.1f} calls  {name[:80]}")
    if sampler is not None:
        launches, kern = sampler
        busy = sum(ms for _, ms in kern)
        print(f"== sample_tokens alone, 8 rows x {cfg.padded_vocab} "
              f"(bf16 logits, temperature 0.8, top-k 50, top-p 0.95): "
              f"{launches:.1f} kernel launches a call, device busy "
              f"{busy:.4f} ms a call")
        for name, ms in kern[:6]:
            print(f"  {ms:9.4f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")
    for n_tok, (launches, kern) in predictor:
        busy = sum(ms for _, ms in kern)
        print(f"== predict_loads_all alone, distance 1, {cfg.num_layers} "
              f"layers x {n_tok} tokens x d_model {cfg.d_model} (bf16 gate "
              f"inputs): {launches:.1f} kernel launches a call, device busy "
              f"{busy:.4f} ms a call")
        for name, ms in kern[:6]:
            print(f"  {ms:9.4f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")
    for bucket, walls, kern in prefill_rows:
        wall = float(np.median(walls)) * 1e3
        busy = sum(ms for _, ms in kern)
        print(f"== solo prefill, kv={names[0]}, bucket {bucket}: wall "
              f"median {wall:.3f} ms over {len(walls)} (min "
              f"{min(walls) * 1e3:.3f}); device busy {busy:.3f} ms (one "
              f"traced prefill), idle share {max(0.0, 1 - busy / wall):.3f}")
        for name, ms in kern[:6]:
            print(f"  {ms:9.4f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")
    return status


def trace_sampler(vocab: int, rows: int = 8, calls: int = 5):
    """(kernel launches a call, kernels as (name, device ms a call)) of
    ``sample_tokens`` over `rows` rows of bf16 logits of width `vocab`
    on the CUDA card, every row sampled (temperature 0.8, top-k 50,
    top-p 0.95), traced with ``torch.profiler`` over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import sample_tokens
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((rows, vocab), generator=gen,
                         device=dev).to(torch.bfloat16)
    args = (torch.full((rows,), 0.8, device=dev),
            torch.full((rows,), 50, dtype=torch.int32, device=dev),
            torch.full((rows,), 0.95, device=dev),
            torch.arange(rows, dtype=torch.int32, device=dev),
            torch.full((rows,), 3, dtype=torch.int32, device=dev))
    sample_tokens(logits, *args)   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            sample_tokens(logits, *args)
        torch.cuda.synchronize()
    return _launches(prof, calls), _kernel_ms(prof, calls)


def trace_predictor(pred, cfg, n_tok: int, calls: int = 5):
    """(kernel launches a call, kernels as (name, device ms a call)) of
    `pred`'s ``predict_loads_all`` over bf16 gate inputs of `n_tok`
    tokens a MoE layer (every token counted) on the CUDA card, traced
    with ``torch.profiler`` over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile
    dev = pred.weights.device
    gen = torch.Generator(device=dev).manual_seed(0)
    lm, e = pred.num_layers, cfg.moe.num_experts
    gi = torch.randn((lm, n_tok, cfg.d_model), generator=gen,
                     device=dev).to(torch.bfloat16)
    actual = torch.full((lm, e), n_tok * cfg.moe.top_k // e,
                        dtype=torch.int32, device=dev)
    mask = torch.ones(n_tok, dtype=torch.bool, device=dev)
    k = cfg.moe.top_k
    pred.predict_loads_all(gi, actual, k, token_mask=mask)   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            pred.predict_loads_all(gi, actual, k, token_mask=mask)
        torch.cuda.synchronize()
    return _launches(prof, calls), _kernel_ms(prof, calls)


def _time_prefills(engine, cfg, args, profile, activity):
    """[(bucket, wall seconds of each untraced solo prefill, kernels of one
    traced prefill as (name, device ms))] for prompts of each bucket's
    length, with the engine's session open."""
    rows = []
    rng = np.random.default_rng(args.seed + 1)
    for bucket in (128, 256, 512) if args.prefill else ():
        prompt = rng.integers(0, cfg.vocab_size, size=bucket,
                              dtype=np.int32)
        engine.prefill_request(prompt)   # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.prefill):
            t = time.perf_counter()
            engine.prefill_request(prompt)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        with profile(activities=[activity.CPU, activity.CUDA]) as prof:
            engine.prefill_request(prompt)
            torch.cuda.synchronize()
        rows.append((bucket, walls, _kernel_ms(prof, 1)))
    return rows


if __name__ == "__main__":
    raise SystemExit(main())
