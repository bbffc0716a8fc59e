"""Dry-run of the port: build every (architecture x input shape) step of
the reference's sweep on the ``meta`` device, over a logical production
mesh, and reckon its per-rank bytes from the sharding specs and its
operations from one meta run. Nothing is allocated and no step runs on
any device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--jobs 8]
Results accumulate in benchmarks/results/torch_dryrun/*.json (the
reference's sweep writes benchmarks/results/dryrun/).

Each step is built at ``impl="ref"``: no kernel runs on meta, and the
plain versions compute the same products. The result keeps the
reference's keys:

  * ``flops``: the step's floating-point operations per device, as the
    reference's ``compiled.cost_analysis()["flops"]`` is, which counts
    the per-device program of the partitioned step (a smoke config's
    count falls about 7.3x from one to eight host devices). Here it is
    the global count of ``torch.utils.flop_counter.FlopCounterMode``
    over one meta run of the step (forward, and backward with remat's
    recompute for train) divided evenly over the mesh's ranks; work the
    partitioned program would repeat on every rank is not counted.
    ``flops_global`` is the global count. The reference's count also
    takes a while loop's body once (its scanned microbatches: the smoke
    config's flops halve from one microbatch to two; and its scanned
    layer periods), where ``flops`` counts every iteration: at the
    default 8 microbatches a train step's ``flops`` is about 8 x the
    reference's. ``flops_per_scan_body`` is the reference's quantity:
    ``flops`` with the layer periods, the microbatches and the loops
    over time each counted once (the fit below, taken at one of each);
    the attention's loop over key blocks is counted in full.
  * ``bytes_accessed``: the sum over the run's operations of their input
    and output tensor bytes (views excluded), divided likewise;
    ``bytes_accessed_global`` is the sum.
  * ``argument_bytes_per_device``, ``output_bytes_per_device`` and
    ``alias_bytes_per_device``: exact, from the specs' shard shapes
    (``distributed.sharding.shard_nbytes``). Outputs take their inputs'
    layout (parameters, optimizer state, cache), the logits the input
    rule, the metrics replicated. The aliased bytes are the donated
    parameters and optimizer state (train) or cache (decode).
  * ``peak_bytes_per_device`` = argument + output - alias.
  * ``collective_bytes`` and ``temp_bytes_per_device``: null. The
    reference parses the compiled HLO's collectives and reads XLA's temp
    buffers; an eager torch step has neither.
  * ``build_s`` (the build and the count) replaces lower/compile seconds.

A meta run of a full model would take minutes: every operation passes
through Python there. So the count runs at a few corners and is
extrapolated exactly. Every layer period runs the same operations, and
so does every microbatch and every iteration of a loop over time (the
Mamba chunks, the x-LSTM tokens, all through ``models.ssm._time_loop``,
which a count cuts to a few iterations: ``_cut_loops``): each count is
affine in each of those trip counts, and the step's count is the
multilinear extrapolation from runs at 1 and 2 periods, 2 and 3
microbatches and 1 and 2 loop iterations, as the reference's HLO parse
multiplies a while body by its trip count.

``main`` and ``sweep`` run a sweep: the meta runs spread over ``--jobs``
spawned processes, a combination that fails reported and the others
kept; ``run_one`` and ``count_step`` count one combination in this
process.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import multiprocessing
import pathlib
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              batch_shardings,
                                              cache_shardings,
                                              params_shardings, replicated)
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import adamw

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] \
    / "benchmarks" / "results" / "torch_dryrun"


def build_step(cfg, shape, variant=None, *, mesh=None):
    """Returns (step_fn, abstract_args, shardings_builder), the args on
    the meta device. `mesh` is the mesh the ZeRO-2 variant's gradient
    layout is pinned to (the reference hangs it on the function). On a
    ``launch.mesh.ProcessMesh`` (a rank) the step runs the layout that
    ``shardings_builder(mesh)`` returns: with ``fsdp_params`` (the
    default) the ZeRO-3 train step (``make_train_step(param_shardings=
    )``), and the prefill and decode steps on the same (data, model)
    shards; without it the ZeRO-2 train step and the prefill and decode
    steps on the model shards. On a ``LogicalMesh`` the shardings are a
    layout only and the step is the one-process step (ZeRO-2's gradient
    layout pinned to it as a layout). With ``ep_experts`` a rank's steps
    run the expert banks split on E (its whole experts); ZeRO-2's
    accumulator and μ/ν keep the reference's ``params_shardings(fsdp=
    True)`` (F over "model"), and its step moves the banks between the
    two splits.

    `variant` (dict) selects the reference's hillclimb configurations:
      microbatches: int (train, default 8)
      remat: 'full' | 'dots' | 'none'
      fsdp_params: bool (False => ZeRO-2: TP-only parameters)
      seq_over_dp: bool (decode: replicate batch, shard cache seq over DP)
      cache_heads_model: bool (decode: cache hd over 'model')
      ep_experts: bool ('model' on the expert dim)
      mamba: dict for models.ssm.set_mamba_opts (the other levers off)
    """
    v = dict(variant or {})
    S.set_mamba_opts(**{"fused_y": False, "chunk_remat": False,
                        "inline_ab": False, **v.get("mamba", {})})
    cfg = cfg.with_(impl="ref")
    fsdp = v.get("fsdp_params", True)
    epx = v.get("ep_experts", False)
    window = M.effective_window(cfg, shape)
    batch = M.input_specs(cfg, shape, abstract=True)
    aparams = M.abstract_params(cfg)
    # a rank's step runs its shards (the layout below); a logical mesh's
    # is the one-process step
    ps = params_shardings(aparams, mesh, fsdp=fsdp, ep_experts=epx) \
        if hasattr(mesh, "groups") else None

    if shape.kind == "train":
        opt = adamw(1e-4)
        aopt = opt.init(aparams)
        gs = None
        if not fsdp and mesh is not None:
            # ZeRO-2: gradients reduce-scatter into a fully sharded f32
            # accumulator though the parameters are TP-only
            gs = params_shardings(aparams, mesh, fsdp=True)
        step = M.make_train_step(cfg, opt, window=window,
                                 microbatches=v.get("microbatches", 8),
                                 remat=v.get("remat", "full"),
                                 grad_shardings=gs, param_shardings=ps)

        def shardings(mesh):
            return (params_shardings(aparams, mesh, fsdp=fsdp,
                                     ep_experts=epx),
                    _opt_shardings(aopt, mesh),
                    batch_shardings(batch, mesh))
        return step, (aparams, aopt, batch), shardings

    if shape.kind == "prefill":
        step = M.make_prefill_step(cfg, window=window, param_shardings=ps)

        def shardings(mesh):
            return (params_shardings(aparams, mesh, fsdp=fsdp,
                                     ep_experts=epx),
                    batch_shardings(batch, mesh))
        return step, (aparams, batch), shardings

    # decode
    acache = M.abstract_cache(cfg, shape)
    cache_len = torch.empty((), dtype=torch.int32, device="meta")
    seq_dp = v.get("seq_over_dp", False)
    heads_model = v.get("cache_heads_model", False)
    step = M.make_serve_step(
        cfg, window=window, param_shardings=ps,
        cache_shardings=None if ps is None else cache_shardings(
            acache, mesh, seq_over_dp=seq_dp, heads_model=heads_model))

    def shardings(mesh):
        return (params_shardings(aparams, mesh, fsdp=fsdp,
                                 ep_experts=epx),
                batch_shardings(batch, mesh, replicate=seq_dp),
                cache_shardings(acache, mesh, seq_over_dp=seq_dp,
                                heads_model=heads_model),
                replicated(mesh))
    return step, (aparams, batch, acache, cache_len), shardings


def _opt_shardings(aopt, mesh):
    return {"mu": params_shardings(aopt["mu"], mesh),
            "nu": params_shardings(aopt["nu"], mesh),
            "step": NamedSharding(mesh, P())}


# ------------------------------------------------------------ counting


class _ByteCounter(TorchDispatchMode):
    """Sums the input and output tensor bytes of every operation that is
    not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(
                t.numel() * t.element_size()
                for t in _tensors((args, kwargs or {}, out)))
        return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _fresh_output_bytes(kind: str, out, mesh) -> int:
    """Per-rank bytes of the outputs that alias no input: the metrics
    (replicated) and the logits (the input rule)."""
    if kind == "train":
        metrics = out[2]
        return SH.shard_nbytes(metrics, SH.tree_map(lambda _: replicated(mesh),
                                                metrics))
    logits, rest = out[0], out[1]
    total = SH.shard_nbytes(logits, batch_shardings(logits, mesh))
    if kind == "prefill":     # rest: the metrics
        total += SH.shard_nbytes(rest, SH.tree_map(lambda _: replicated(mesh),
                                               rest))
    return total


@contextlib.contextmanager
def _cut_loops(limit: int):
    """Within this block every loop over time (``models.ssm._time_loop``)
    runs at most `limit` iterations, its outputs padded to the full
    count with the last one detached: the backward then runs the
    iterations run and nothing else, so a loop's counts, forward and
    backward, are affine in the iterations run. Yields the set of the
    loops' full trip counts."""
    seen, plain = set(), S._time_loop

    def cut(step, n: int, carry):
        seen.add(n)
        carry, ys = plain(step, min(n, limit), carry)
        return carry, ys + [ys[-1].detach()] * (n - len(ys))

    S._time_loop = cut
    try:
        yield seen
    finally:
        S._time_loop = plain


def _corner(cfg, shape, variant, mesh, periods: int, micro, trips):
    """One meta run: the step at `periods` layer periods, `micro`
    microbatches (train) and loops over time cut to `trips` iterations.
    Returns ({flops, bytes, out}, the loops' full trip counts)."""
    period = len(T.layer_pattern(cfg))
    ccfg = cfg.with_(num_layers=periods * period)
    v = dict(variant or {})
    cshape = shape
    if micro is not None:
        per = shape.global_batch // v.get("microbatches", 8)
        cshape = dataclasses.replace(shape, global_batch=per * micro)
        v["microbatches"] = micro
    step, args, _ = build_step(ccfg, cshape, v, mesh=mesh)
    with _cut_loops(trips) as seen, _ByteCounter() as bc, \
            FlopCounterMode(display=False) as fc:
        out = step(*args)
    return {"flops": fc.get_total_flops(), "bytes": bc.bytes,
            "out": _fresh_output_bytes(shape.kind, out, mesh)}, set(seen)


def _axes(cfg, shape, variant) -> dict:
    """Each trip count the count extrapolates over: (its full value, the
    corner values it is run at): two where the full value is 2 or more,
    so that ``_combine`` can take the fit at one iteration too.
    The loops over time are found by the first run (``_with_trips``)."""
    periods = cfg.num_layers // len(T.layer_pattern(cfg))
    mb = (variant or {}).get("microbatches", 8) \
        if shape.kind == "train" else None
    return {"periods": (periods, (1, 2)) if periods > 1 else
            (periods, (periods,)),
            "micro": (mb, (2, 3)) if mb is not None and mb > 1 else
            (mb, (mb,)),
            "trips": (1, (1,))}


def _first(axes) -> tuple:
    """The first corner: the least of each axis, loops cut to one trip."""
    return (axes["periods"][1][0], axes["micro"][1][0], 1)


def _with_trips(axes, seen) -> dict:
    """`axes` with the loops over time the first run met (their trip
    counts `seen`)."""
    if len(seen) > 1:
        raise ValueError(f"loops over time of {sorted(seen)} trips in one "
                         "step: the count needs one trip count")
    n = next(iter(seen), 1)
    return dict(axes, trips=(n, (1, 2)) if n > 1 else (n, (n,)))


def _corners(axes) -> list:
    return list(itertools.product(*(v[1] for v in axes.values())))


def _fit(axes, runs, at) -> dict:
    """The multilinear fit of the corner runs' counts, taken at `at`
    (one value an axis; exact where every count is affine in each)."""
    total = dict.fromkeys(next(iter(runs.values())), 0)
    for corner, counts in runs.items():
        w = 1
        for (_, vals), c, x in zip(axes.values(), corner, at):
            if len(vals) == 2:
                w *= (vals[1] - x) if c == vals[0] else (x - vals[0])
        for k, v in counts.items():
            total[k] += w * v
    return total


def _combine(axes, runs) -> dict:
    """The counts at each axis's full value, with ``flops_scan_once``,
    the flops at one iteration of each (module docstring)."""
    total = _fit(axes, runs, [full for full, _ in axes.values()])
    total["flops_scan_once"] = _fit(axes, runs, [1] * len(axes))["flops"]
    total["corners"] = len(runs)
    return total


def count_step(cfg, shape, variant=None, mesh=None) -> dict:
    """{flops, flops_scan_once, bytes, out, corners}: the step's global
    operation count (and at one iteration of each loop), operation bytes
    and per-rank fresh output bytes, extrapolated
    multilinearly from meta runs at corners of its trip counts (module
    docstring), in this process."""
    axes = _axes(cfg, shape, variant)
    first = _first(axes)
    probe, seen = _corner(cfg, shape, variant, mesh, *first)
    axes = _with_trips(axes, seen)
    return _combine(axes, {
        c: probe if c == first else
        _corner(cfg, shape, variant, mesh, *c)[0] for c in _corners(axes)})


def _mesh_of(multi_pod: bool, variant):
    return make_production_mesh(multi_pod=multi_pod,
                                shape=(variant or {}).get("mesh_shape"))


def _corner_job(job):
    """One meta run of ``sweep``'s pool: (arch, shape name, variant,
    multi_pod, corner) -> (counts, trip counts seen, seconds, whether
    this process has touched CUDA)."""
    arch, shape_name, variant, multi_pod, corner = job
    mesh = _mesh_of(multi_pod, variant)
    t0 = time.perf_counter()
    with _globals(mesh):
        counts, seen = _corner(get_config(arch), INPUT_SHAPES[shape_name],
                               variant, mesh, *corner)
    return counts, seen, time.perf_counter() - t0, \
        torch.cuda.is_initialized()


def sweep(combos, *, jobs: int, multi_pod: bool = False, variant=None,
          tag: str = "", save: bool = True, verbose: bool = True,
          results_dir=None, start_method: str = "spawn") -> tuple[list, list]:
    """``run_one`` for every (arch, shape name) of `combos`, the meta
    runs of all of them spread over `jobs` processes of `start_method`
    (a meta run is Python bound): first each combination's first corner, which
    finds its loops over time, then the other corners, the costliest
    first. Each result's ``count_seconds`` sums its runs' seconds, and
    ``count_touched_cuda`` says whether any of its runs' processes had
    initialised CUDA (none should). A combination that fails is reported
    (a FAIL line) and the others go on. Returns (results, failures:
    (arch, shape name, error) each)."""
    combos = [tuple(c) for c in combos]
    axes = {c: _axes(get_config(c[0]), INPUT_SHAPES[c[1]], variant)
            for c in combos}
    first = {c: _first(axes[c]) for c in combos}
    failures = {}

    def collect(futures) -> dict:
        done = {}
        for (c, k), fut in futures.items():
            try:
                done[(c, k)] = fut.result()
            except Exception:  # noqa: BLE001 - report, keep sweeping
                failures.setdefault(c, traceback.format_exc(limit=-3))
        return done

    ctx = multiprocessing.get_context(start_method)
    with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as pool:
        runs = collect({(c, first[c]): pool.submit(
            _corner_job, (*c, variant, multi_pod, first[c])) for c in combos})
        for c in combos:
            if c not in failures:
                axes[c] = _with_trips(axes[c], runs[(c, first[c])][1])
        rest = sorted(((c, k) for c in combos if c not in failures
                       for k in _corners(axes[c]) if k != first[c]),
                      key=lambda ck: -math.prod(v or 1 for v in ck[1]))
        runs.update(collect({(c, k): pool.submit(
            _corner_job, (*c, variant, multi_pod, k)) for c, k in rest}))
    results = []
    for c in combos:
        if c in failures:
            continue
        got = {k: runs[(c, k)] for k in _corners(axes[c])}
        count = _combine(axes[c], {k: v[0] for k, v in got.items()})
        count["seconds"] = sum(v[2] for v in got.values())
        count["touched_cuda"] = any(v[3] for v in got.values())
        try:
            results.append(run_one(*c, multi_pod=multi_pod, save=save,
                                   verbose=verbose, variant=variant,
                                   tag=tag, results_dir=results_dir,
                                   count=count))
        except Exception:  # noqa: BLE001 - report, keep sweeping
            failures[c] = traceback.format_exc(limit=-3)
    out = [(a, sh, failures[(a, sh)]) for a, sh in combos
           if (a, sh) in failures]
    for a, sh, err in out:
        print(f"[dryrun] FAIL {a} x {sh}: {err}"[:1000])
    return results, out


# ------------------------------------------------------------ one combination


@contextlib.contextmanager
def _globals(mesh):
    """Set the dispatch groups (the mesh's data-parallel degree) and the
    activation mesh (as the reference does; a no-op in the port) for a
    combination, and restore the groups and the Mamba levers after
    it."""
    saved = (dict(T._MOE_GROUPS), dict(S.MAMBA_OPTS))
    try:
        T.set_moe_dispatch_groups(
            math.prod(mesh.shape[a] for a in dp_axes(mesh)))
        SH.set_activation_mesh(mesh)
        yield
    finally:
        T._MOE_GROUPS.update(saved[0])
        S.MAMBA_OPTS.update(saved[1])


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            save: bool = True, verbose: bool = True,
            variant=None, tag: str = "", results_dir=None,
            count=None) -> dict:
    """One combination's result (module docstring). `count` is
    ``count_step``'s result when ``sweep`` has counted it already."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = _mesh_of(multi_pod, variant)
    ndev = mesh.size
    t0 = time.perf_counter()
    with _globals(mesh):
        step, args, shardings_builder = build_step(cfg, shape, variant,
                                                   mesh=mesh)
        in_sh = shardings_builder(mesh)
        arg_bytes = [SH.shard_nbytes(a, s) for a, s in zip(args, in_sh)]
        if count is None:
            count = count_step(cfg, shape, variant, mesh)
    build_s = time.perf_counter() - t0 + count.get("seconds", 0.0)
    # donated state: params + optimizer state (train), the cache (decode)
    alias = sum(arg_bytes[:2]) if shape.kind == "train" else \
        (arg_bytes[2] if shape.kind == "decode" else 0)
    out_bytes = alias + count["out"]
    mesh_name = "x".join(str(s) for s in mesh.shape.values())
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "num_devices": ndev,
        "kind": shape.kind,
        "window": M.effective_window(cfg, shape),
        "flops": count["flops"] / ndev,
        "flops_global": count["flops"],
        "flops_per_scan_body": count["flops_scan_once"] / ndev,
        "bytes_accessed": count["bytes"] / ndev,
        "bytes_accessed_global": count["bytes"],
        "collective_bytes": None,
        "argument_bytes_per_device": sum(arg_bytes),
        "output_bytes_per_device": out_bytes,
        "temp_bytes_per_device": None,
        "alias_bytes_per_device": alias,
        "peak_bytes_per_device": sum(arg_bytes) + out_bytes - alias,
        "build_s": round(build_s, 3),
        "count_corners": count["corners"],
        "count_touched_cuda": count.get("touched_cuda", False),
        "params": M.count_params_analytic(cfg),
        "active_params": M.count_params_analytic(cfg, active_only=True),
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} on {mesh_name}: "
              f"flops/dev={result['flops']:.3e} "
              f"peak/dev={result['peak_bytes_per_device'] / 1e9:.2f}GB "
              f"(args {sum(arg_bytes) / 1e9:.2f}GB, built and counted in "
              f"{build_s:.1f}s over {count['corners']} meta runs)")
    if save:
        out_dir = pathlib.Path(results_dir or RESULTS_DIR)
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        out = out_dir / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
        out.write_text(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    # the reference's hillclimb variant flags
    ap.add_argument("--tag", default="")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default=None,
                    choices=["full", "dots", "none"])
    ap.add_argument("--no-fsdp-params", action="store_true")
    ap.add_argument("--seq-over-dp", action="store_true")
    ap.add_argument("--cache-heads-model", action="store_true")
    ap.add_argument("--ep-experts", action="store_true")
    ap.add_argument("--mesh-shape", default=None,
                    help="per-pod data x model, e.g. 32x8")
    ap.add_argument("--mamba-fused", action="store_true")
    ap.add_argument("--mamba-remat", action="store_true")
    ap.add_argument("--mamba-inline", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes for the meta runs")
    args = ap.parse_args(argv)

    variant = {}
    if args.microbatches is not None:
        variant["microbatches"] = args.microbatches
    if args.remat is not None:
        variant["remat"] = args.remat
    if args.no_fsdp_params:
        variant["fsdp_params"] = False
    if args.seq_over_dp:
        variant["seq_over_dp"] = True
    if args.cache_heads_model:
        variant["cache_heads_model"] = True
    if args.ep_experts:
        variant["ep_experts"] = True
    if args.mesh_shape:
        variant["mesh_shape"] = tuple(
            int(x) for x in args.mesh_shape.split("x"))
    mam = {}
    if args.mamba_fused:
        mam["fused_y"] = True
    if args.mamba_remat:
        mam["chunk_remat"] = True
    if args.mamba_inline:
        mam["inline_ab"] = True
    if mam:
        variant["mamba"] = mam

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    todo = []
    for a, s in itertools.product(archs, shapes):
        mesh_tag = "2x16x16" if args.multi_pod else "16x16"
        f = RESULTS_DIR / f"{a}__{s}__{mesh_tag}.json"
        if args.skip_existing and f.exists():
            print(f"[dryrun] skip existing {a} x {s} ({mesh_tag})")
            continue
        todo.append((a, s))
    _, failures = sweep(todo, jobs=args.jobs, multi_pod=args.multi_pod,
                        variant=variant or None, tag=args.tag)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for a, s, e in failures:
            print(f"  {a} x {s}: {e.strip().splitlines()[-1]}"[:300])
        sys.exit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
