"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: name and power limit (nvidia-smi) and torch's device name;
  2. build: every CUDA kernel of the main path from ``kernels/csrc``,
     one nvcc per source, all started together;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main path's decode and prefill shapes (bf16) and at
     adversarial shapes (f32 and bf16), with its time, its bound, the
     plain version's time and one PyTorch library call's time — the
     int8-weight kernels at the EP slot plane's shapes (64 slots, 16 of
     them active); the path of ``moe_gmm`` and of the int8 kernels
     ("simt" or "wgmma") is named for every shape, the main path's decode
     and prefill shapes must take "wgmma" (the int8 kernels in one launch
     a call, torch.profiler, with no workspace), and each is timed in
     turns against the simt path (the int8 decode also against the same
     active slots packed into a bank of their own); ``decode_attn``'s path ("mma" or "simt") and cluster size
     are named for every case (rows with no visible lane, lanes past
     kv_len holding 1e4, k/v off alignment among them), the main shapes
     must take "mma" and run one launch a call (torch.profiler), and
     beside the eager time each has ``device_ms``, 20 launches captured
     in a CUDA graph and timed by replay, as has its library call;
  4. the slice at full width: mixtral-8x7b at its published widths (8 of
     32 layers, bf16, random seeded weights) serving 12 requests through
     ``ServingEngine`` with the MoEless controller attached, counting
     every kernel launch of that run and timing each model call; then
     every layer's attention and MoE sublayer through the kernels against
     the plain path from the same input (a prefill and a batched decode
     step), and the full-model logits of both paths compared;
  4b. paged KV at full width, with the same weights: the paged pool
     (16-token blocks), chunked prefill (256 tokens) and the radix prefix
     cache serving two waves of 8 requests that share a 256-token system
     prompt (prefix hits, one copy-on-write, no leaked block), counting
     that run's launches and timing mixed and decode-only steps; then
     every layer's paged attention sublayer through the kernel against
     the plain path from the same input and pool;
  4c. the expert runtime on the EP slot plane at full width with int8
     slot banks: mixtral-8x7b (4 of 32 layers, bf16) serving 12 requests
     through ``ServingEngine(expert_runtime="on")`` with a session
     MoEless controller (64 single-buffered slots a layer), counting
     that run's launches
     (prefill and decode both through the int8 kernels, every launch on
     their "wgmma" path, none through the unquantized kernels), checking
     the runtime's byte meters, then
     every layer's EP MoE sublayer through the kernels against the plain
     path from the same input and tables;
  6. the OpenAI-compatible gateway at full width, on phase 4's weights
     (so it runs right after 4b, before 4c's slot banks take the
     memory): a ``GatewayServer`` on 127.0.0.1 in a thread over a
     ``Router`` of 2 replicas on 4b's paged spec, drop-free, each with a
     session MoEless controller; a greedy and a sampled request sent
     alone over HTTP give ``engine.serve``'s tokens for each alone, the
     sampled one sent again (SSE) gives them again; each sent again
     with a stop sequence taken from its own answer ends there, finish
     "stop"; 16 concurrent clients (half sampled, half SSE, completions
     and chat) all end with their budget; ``/metrics`` is Prometheus text
     with the router, scheduler, KV and control families; the paged
     kernel and both bf16 ``moe_gmm`` kernels launched, counted after
     the replicas stop; then the wall TTFT/TPOT medians over HTTP and
     through offline engines, and the sampler's launches a step;
  5. token identity: the mixtral-8x7b smoke config at float32 gives the
     same greedy tokens through the kernels as the plain path on the
     contiguous cache, at its own capacity factor (where tokens are
     dropped) and at a drop-free one, where the paged runs (solo,
     chunked, prefix-warm) through the kernels give them too, as they
     give the tokens of a trace where half the requests sample, and
     sampled batched serving gives the tokens of one request at a time;
     with the expert runtime on, the kernels give the plain path's
     tokens with float32 and int8 slot banks, and at the drop-free
     factor the runtime gives the tokens of the runtime-off engine.

Phases run in the order 1, 2, 3, 4, 4b, 6, 4c, 5.

The second-to-last line is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import build as KB  # noqa: E402
from repro_torch.kernels import decode_attn as DA  # noqa: E402
from repro_torch.kernels import moe_gmm as MG  # noqa: E402

# H100 SXM data sheet: HBM rate and dense peak rates by input type
HBM_BYTES_S = 3.35e12
PAGED_BLOCK, PAGED_CHUNK = 16, 256   # the paged phase's serving knobs
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # atol = rtol
SOURCES = {
    "fused_gate_up": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                      "src/repro/kernels/moe_gmm.py:198"),
    "gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
            "src/repro/kernels/moe_gmm.py:69"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                         "src/repro/kernels/decode_attn.py:71"),
    "decode_attention_paged": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                               "src/repro/kernels/decode_attn.py:127"),
    "fused_gate_up_quant": ("src/repro_torch/kernels/csrc/moe_gmm_q.cu",
                            "src/repro/kernels/moe_gmm.py:268"),
    "gmm_quant": ("src/repro_torch/kernels/csrc/moe_gmm_q.cu",
                  "src/repro/kernels/moe_gmm.py:130"),
}
# phase 4c's session controller: MoElessController(num_devices=8,
# slots_per_device=8). With E = 8 experts a device never holds more than
# 8 instances, so no slot allocation can fail; the default 3 slots a
# device (24 a layer) fill up within a few iterations of this burst, as
# the modeled clock spans well under the 60 s keep-alive and no instance
# is ever reaped (the reference runtime raises there too). The bank is
# single-buffered (the engine's runtime_double_buffer=False): 64 int8
# slots x 176.25 MB = 11.3 GB a layer, 15.7 GB with the layer's padded
# quantized bank and its own bf16 experts, so 4 layers fit the card;
# double buffering would take 26 GB a layer. Phase 5 and the CPU tests
# hold double- and single-buffered banks equal.
EP_DEVICES, EP_SLOTS_PER_DEVICE = 8, 8
RUNTIME_LAYERS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 5) -> float:
    """Milliseconds per launch: CUDA events around `iters` back-to-back
    launches, over the count; the median of `reps` such runs after
    warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return float(np.median(times))


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name: str, got, want, dtype) -> float:
    tol = TOL[dtype]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.allclose(g, w, atol=tol, rtol=tol):
        raise AssertionError(f"{name}: max |kernel - plain| = {err:.3e} "
                             f"beyond atol=rtol={tol}")
    return err


# ------------------------------------------------------------ phase 3


def _gmm_inputs(gen, e, c, d, f, dtype, gs, fused):
    dev = "cuda"
    x = torch.randn((e, c, d), generator=gen, device=dev).to(dtype)
    scale = 1.0 / math.sqrt(d)
    wg = (torch.randn((e, d, f), generator=gen, device=dev, dtype=dtype)
          .mul_(scale))
    wu = (torch.randn((e, d, f), generator=gen, device=dev, dtype=dtype)
          .mul_(scale)) if fused else None
    return x, wg, wu, torch.tensor(gs, dtype=torch.int32, device=dev)


def _gmm_bytes_flops(x, wg, wu, gs):
    """Bytes and operations this call's data needs: weights of experts
    with rows, x rows inside their group, every output element."""
    e, c, d = x.shape
    f = wg.shape[2]
    isz = x.element_size()
    g = gs.clamp(0, c).cpu()
    rows = int(g.sum())
    n_w = 2 if wu is not None else 1
    live = int((g > 0).sum())
    nbytes = (rows * d + n_w * live * d * f + e * c * f) * isz + 4 * e
    return nbytes, 2.0 * n_w * rows * d * f


def _gmm_run(name, fused, x, wg, wu, g, path=None):
    """The kernel on `path` (None: its plan's; else a key of MG.PATHS,
    forced to time one path against another)."""
    return MG._launch(name, fused, x, wg, wu if fused else None, g,
                      path=path)


def _gmm_check(name, fused, label, x, wg, wu, g, dtype, path=None):
    """The kernel (on `path`) against its plain version, rows past the
    group size exactly 0; returns the largest error."""
    got = _gmm_run(name, fused, x, wg, wu, g, path)
    want = (MG.fused_gate_up_ref(x, wg, wu, g) if fused
            else MG.gmm_ref(x, wg, g))
    torch.cuda.synchronize()
    err = check(f"{name} [{label}, {dtype}]", got, want, dtype)
    zero = torch.arange(x.shape[1], device="cuda")[None] >= g[:, None]
    if got[zero].abs().sum() != 0:
        raise AssertionError(f"{name} [{label}]: rows past the group size "
                             "are not zero")
    return err


def _alternate(fn_a, fn_b, timer=None) -> tuple[float, float]:
    """Times of two versions taken in turns (a, b, b, a) by `timer`
    (default time_ms): the mean of each."""
    timer = timer or time_ms
    ta1, tb1, tb2, ta2 = timer(fn_a), timer(fn_b), timer(fn_b), timer(fn_a)
    return (ta1 + ta2) / 2, (tb1 + tb2) / 2


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call: `iters` calls of `fn` captured once in
    a CUDA graph, each replay timed by CUDA events, over the count; the
    median of `reps` replays after a warm-up replay. Unlike time_ms, the
    host's cost of a call is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    del graph
    return float(np.median(times))


def one_launch(name: str, fn, kernel: str = "decode_attn",
               n: int = 4) -> None:
    """Fail unless each call of `fn` runs exactly one device operation,
    a kernel whose name holds `kernel`, in a torch.profiler trace of `n`
    calls after a warm-up. A trace that misses some of the kernel's
    events (and shows nothing else) is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ops = {e.key: e.count / n for e in prof.key_averages()
               if "cuda" in str(getattr(e, "device_type", "")).lower()}
        if len(ops) != 1 or kernel not in next(iter(ops)) \
                or next(iter(ops.values())) > 1:
            break
        if next(iter(ops.values())) == 1:
            log(f"  {name:<22} one launch a call: "
                f"{next(iter(ops))[:72]}")
            return
    raise AssertionError(f"{name}: a call should run one kernel launch; "
                         f"the profiler saw {ops}")


def host_us(fn, n: int = 50) -> float:
    """Host microseconds per call of `fn`, `n` calls enqueued back to back
    (far fewer than the launch queue holds, so the host never waits on
    the card), from the host clock."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def check_gmm_kernels(gen, shapes) -> dict:
    """fused_gate_up and gmm against their plain versions at adversarial
    shapes (both dtypes; bf16 with D, F multiples of 8 takes wgmma), then
    at the main path's decode and prefill shapes (bf16), which must take
    the wgmma path, timed beside the bound, the plain version and the
    library call, and at decode in turns against the simt path. Returns
    the per-kernel records."""
    rec = {}
    cases = [  # (label, E, C, D, F, group sizes)
        ("C7/D96/F40", 3, 7, 96, 40, [7, 3, 0]),
        ("all-zero gs", 2, 16, 96, 40, [0, 0]),
        ("one partial expert", 4, 33, 64, 72, [0, 0, 17, 0]),
        ("E=1", 1, 40, 128, 136, [40]),
        ("odd F=37", 2, 12, 40, 37, [12, 5]),
        ("C9 D40 F72 gs 9/1/0", 3, 9, 40, 72, [9, 1, 0]),
        ("C64 D200 F136", 2, 64, 200, 136, [64, 33]),
        ("C65 F200", 2, 65, 64, 200, [65, 0]),
        ("C160 E=1", 1, 160, 128, 256, [160]),
        ("C200: 2 row groups", 2, 200, 96, 136, [200, 161]),
        ("long D: C24 D4104", 2, 24, 4104, 136, [24, 7]),
        ("C300", 2, 300, 64, 72, [300, 257]),
        ("C40 D4104 F200", 3, 40, 4104, 200, [1, 40, 0]),
    ]
    for name, fused in (("fused_gate_up", True), ("gmm", False)):
        for label, e, c, d, f, gs in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x, wg, wu, g = _gmm_inputs(gen, e, c, d, f, dtype, gs, fused)
                err = _gmm_check(name, fused, label, x, wg, wu, g, dtype)
                path, info = MG.kernel_path(x, wg, fused)
                tma = dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0
                if path != ("wgmma" if tma else "simt"):
                    raise AssertionError(f"{name} [{label}]: path {path}")
                log(f"  {name:<16} {label:<20} {str(dtype):<15} "
                    f"{path:<5} N={info['rows']:<3} max_abs_err={err:.3e}")
                if not tma:
                    continue
                # the forced path timed below holds at every shape too
                err = _gmm_check(name, fused, f"{label}, simt", x, wg, wu, g,
                                 dtype, "simt")
                log(f"  {name:<16} {label:<20} forced simt "
                    f"max_abs_err={err:.3e}")
        # x 2 bytes past an aligned buffer: no tensor map takes it
        e, c, d, f, gs = 2, 64, 96, 136, [64, 30]
        x, wg, wu, g = _gmm_inputs(gen, e, c, d, f, torch.bfloat16, gs,
                                   fused)
        buf = torch.zeros(x.numel() + 8, dtype=x.dtype, device="cuda")
        xm = buf[1:1 + x.numel()].view(x.shape)
        xm.copy_(x)
        path = MG.kernel_path(xm, wg, fused)[0]
        if path != "simt" or xm.data_ptr() % 16 != 2:
            raise AssertionError(f"{name}: misaligned x took {path}")
        err = _gmm_check(name, fused, "x misaligned by 2 B", xm, wg, wu, g,
                         torch.bfloat16)
        log(f"  {name:<16} {'x misaligned by 2 B':<20} torch.bfloat16  "
            f"{path:<5} max_abs_err={err:.3e}")
        for phase in ("decode", "prefill"):
            e, c, d, f, gs = shapes[name][phase]
            dtype = torch.bfloat16
            x, wg, wu, g = _gmm_inputs(gen, e, c, d, f, dtype, gs, fused)
            path, info = MG.kernel_path(x, wg, fused)
            if path != "wgmma":
                raise AssertionError(f"{name}: the {phase} shape took "
                                     f"{path}, not wgmma")
            alt = "simt" if phase == "decode" else None
            run = lambda: _gmm_run(name, fused, x, wg, wu, g)  # noqa: E731
            mask = torch.arange(c, device="cuda")[None, :, None] \
                < g[:, None, None]
            if fused:
                plain = lambda: MG.fused_gate_up_ref(x, wg, wu, g)  # noqa

                def library():
                    return torch.where(mask, F.silu(torch.bmm(x, wg))
                                       * torch.bmm(x, wu), 0.0)
            else:
                plain = lambda: MG.gmm_ref(x, wg, g)  # noqa: E731

                def library():
                    return torch.where(mask, torch.bmm(x, wg), 0.0)
            err = _gmm_check(name, fused, f"{phase} {e}x{c}x{d}x{f}", x, wg,
                             wu, g, dtype)
            if alt is None:
                ms, alt_ms = time_ms(run), None
            else:
                alt_err = _gmm_check(name, fused, f"{phase}, {alt}", x, wg,
                                     wu, g, dtype, alt)
                run_alt = lambda: _gmm_run(  # noqa: E731
                    name, fused, x, wg, wu, g, alt)
                ms, alt_ms = _alternate(run, run_alt)
                if phase == "decode":   # the host cost of each path a call
                    us, alt_us = _alternate(run, run_alt, host_us)
                    log(f"  {name:<16} {phase:<8} host us a call, in turns: "
                        f"{path} {us:.1f}, {alt} {alt_us:.1f}")
            plain_ms = time_ms(plain)
            lib_ms = time_ms(library)
            nbytes, flops = _gmm_bytes_flops(x, wg, wu, g)
            b_ms, b_by = bound(nbytes, flops, dtype)
            log(f"  {name:<16} {phase:<8} E={e} C={c} D={d} F={f} bf16 "
                f"({path}, N={info['rows']}, {info['stages']} stages, "
                f"{info['smem']} B shared a CTA) max_abs_err={err:.3e} "
                f"ms={ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f}")
            if alt is not None:
                log(f"  {name:<16} {phase:<8} in turns with the plan's: "
                    f"{alt} ms={alt_ms:.4f} (max_abs_err={alt_err:.3e})")
            if phase == "decode":
                rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib_ms, path=path,
                                 **{f"decode_{alt}_ms": alt_ms})
            else:
                rec[name].update(
                    prefill_ms=ms, prefill_bound_ms=b_ms,
                    prefill_plain_ms=plain_ms, prefill_library_ms=lib_ms,
                    prefill_max_abs_err=err, prefill_path=path)
            del x, wg, wu
            torch.cuda.empty_cache()
    return rec


def _quant_inputs(gen, e, c, d, f, dtype, gs, fused):
    """x, per-slot quantized weights (int8 values, f32 row scales: the
    slot-bank layout, one slot at a time so no float bank exists), gs."""
    from repro_torch.kernels import quant as QT
    dev = gen.device
    x = torch.randn((e, c, d), generator=gen, device=dev).to(dtype)
    ws = []
    for _ in range(2 if fused else 1):
        q = torch.empty((e, d, f), dtype=torch.int8, device=dev)
        sc = torch.empty((e, d), dtype=torch.float32, device=dev)
        for i in range(e):
            w = torch.randn((d, f), generator=gen, device=dev,
                            dtype=dtype).mul_(1.0 / math.sqrt(d))
            q[i], sc[i] = QT.quantize_rows(w)
        ws += [q, sc]
    return x, ws, torch.tensor(gs, dtype=torch.int32, device=dev)


def _quant_bytes_flops(x, ws, gs):
    """Bytes and operations this call's data needs: int8 weights and f32
    scales of slots with rows, x rows inside their group, every output
    element; two operations per multiply-add of the rows in groups."""
    e, c, d = x.shape
    f = ws[0].shape[2]
    isz = x.element_size()
    g = gs.clamp(0, c).cpu()
    rows = int(g.sum())
    n_w = len(ws) // 2
    live = int((g > 0).sum())
    nbytes = (rows * d + e * c * f) * isz + n_w * live * (d * f + 4 * d) \
        + 4 * e
    return nbytes, 2.0 * n_w * rows * d * f


def _quant_run(name, fused, x, ws, g, max_active=0, path=None):
    """The int8 kernel on `path` (None: its plan's; else a key of
    MG.PATHS, forced to time one path against another)."""
    qs = [(ws[i], ws[i + 1]) for i in range(0, len(ws), 2)]
    return MG._launch_quant(name, fused, x, qs, g, max_active, path=path)


def _quant_check(name, fused, label, x, ws, g, dtype, max_active=0,
                 path=None):
    """The int8 kernel (on `path`) against its plain version, in x's
    dtype, rows past the group size exactly 0; returns the largest
    error."""
    got = _quant_run(name, fused, x, ws, g, max_active, path)
    want = (MG.fused_gate_up_quant_ref(x, *ws, g) if fused
            else MG.gmm_quant_ref(x, *ws, g))
    torch.cuda.synchronize()
    err = check(f"{name} [{label}, {dtype}]", got, want, dtype)
    zero = torch.arange(x.shape[1], device=x.device)[None] >= g[:, None]
    if got.dtype != dtype or got[zero].abs().sum() != 0:
        raise AssertionError(f"{name} [{label}]: wrong dtype or rows past "
                             "the group size not zero")
    return err


def check_quant_kernels(gen, shapes) -> dict:
    """fused_gate_up_quant and gmm_quant against their plain versions at
    adversarial shapes (f32 and bf16; bf16 with D % 8 == 0 and F % 16 ==
    0 takes wgmma, the rest simt; the path is asserted and logged), then
    at the EP slot plane's decode and prefill shapes (bf16, 16 of 64
    slots active), which must take wgmma in one launch with no workspace,
    timed in turns against the simt path, beside the bound, the plain
    version and the library composition (dequantize the active slots to
    x's dtype, ``bmm``, silu, mask). Returns the per-kernel records."""
    rec = {}
    active16 = [(i % 3) + 1 if i % 4 == 1 else 0 for i in range(64)]
    cases = [  # (label, E, C, D, F, group sizes)
        ("C7/D96/F40", 3, 7, 96, 40, [7, 3, 0]),
        ("all-zero gs", 2, 16, 96, 40, [0, 0]),
        ("E=1", 1, 7, 96, 40, [5]),
        ("odd F=37", 2, 12, 40, 37, [12, 5]),
        ("split D, F%16=0", 4, 3, 1024, 64, [3, 0, 1, 2]),
        ("C=40", 3, 40, 96, 48, [40, 17, 0]),
        ("C=70 D=200", 2, 70, 200, 64, [70, 65]),
        ("C=1", 2, 1, 96, 48, [1, 0]),
        ("C=8 F=144", 2, 8, 128, 144, [8, 5]),
        ("C=9 D=200", 3, 9, 200, 64, [9, 1, 0]),
        ("C=160", 1, 160, 128, 256, [160]),
        ("C=161 D=200 F=144", 2, 161, 200, 144, [161, 9]),
        ("C=320", 2, 320, 64, 48, [320, 161]),
        ("C=160, rows 100/70/33", 3, 160, 64, 48, [100, 70, 33]),
        ("E=64, 16 active", 64, 3, 128, 144, active16),
        ("all-zero gs, F=48", 2, 16, 96, 48, [0, 0]),
    ]
    for name, fused in (("fused_gate_up_quant", True), ("gmm_quant", False)):
        run_k = MG.fused_gate_up_quant if fused else MG.gmm_quant
        run_p = MG.fused_gate_up_quant_ref if fused else MG.gmm_quant_ref
        for label, e, c, d, f, gs in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x, ws, g = _quant_inputs(gen, e, c, d, f, dtype, gs, fused)
                path, info = MG.quant_plan(x, ws[0], scale=ws[1])
                tma = dtype == torch.bfloat16 and d % 8 == 0 and f % 16 == 0
                if path != ("wgmma" if tma else "simt"):
                    raise AssertionError(f"{name} [{label}]: path {path}")
                err = _quant_check(name, fused, label, x, ws, g, dtype)
                log(f"  {name:<20} {label:<18} {str(dtype):<15} "
                    f"{path:<5} N={info['rows']:<3} D split "
                    f"{info['ksplit']:<2} max_abs_err={err:.3e}")
        # x 2 bytes past an aligned buffer: no tensor map takes it
        e, c, d, f, gs = 2, 64, 96, 144, [64, 30]
        x, ws, g = _quant_inputs(gen, e, c, d, f, torch.bfloat16, gs, fused)
        xm = _offset_copy(x)
        path = MG.quant_plan(xm, ws[0], scale=ws[1])[0]
        if path != "simt":
            raise AssertionError(f"{name}: misaligned x took {path}")
        err = _quant_check(name, fused, "x misaligned by 2 B", xm, ws, g,
                           torch.bfloat16)
        log(f"  {name:<20} {'x misaligned by 2 B':<18} torch.bfloat16  "
            f"{path:<5} max_abs_err={err:.3e}")
        for phase in ("decode", "prefill"):
            e, c, d, f, gs = shapes[name][phase]
            ma = shapes["max_active"][phase]
            dtype = torch.bfloat16
            x, ws, g = _quant_inputs(gen, e, c, d, f, dtype, gs, fused)
            path, info = MG.quant_plan(x, ws[0], ma, scale=ws[1])
            work = MG._qplan(fused, x, ws, f, ma)[1][4]
            if path != "wgmma" or work != 0:
                raise AssertionError(f"{name}: the {phase} shape took "
                                     f"{path} with {work} floats of "
                                     "workspace, not wgmma with none")
            simt_split = MG._qplan(fused, x, ws, f, ma, "simt")[1][0]
            run = lambda: run_k(x, *ws, g, max_active=ma)  # noqa: E731
            run_simt = lambda: _quant_run(  # noqa: E731
                name, fused, x, ws, g, ma, "simt")
            plain = lambda: run_p(x, *ws, g)  # noqa: E731
            one_launch(name, run, "wgmma_q_kernel")
            idx = torch.nonzero(g > 0).flatten()
            rows = g[idx].long()
            mask = torch.arange(c, device=x.device)[None, :, None] \
                < rows[:, None, None]

            def library():
                xa = x[idx]
                deq = [ws[i][idx].to(dtype) * ws[i + 1][idx, :, None]
                       .to(dtype) for i in range(0, len(ws), 2)]
                y = torch.bmm(xa, deq[0])
                if fused:
                    y = F.silu(y) * torch.bmm(xa, deq[1])
                out = torch.zeros((e, c, f), dtype=dtype, device=x.device)
                out[idx] = torch.where(mask, y, 0.0)
                return out
            err = _quant_check(name, fused, f"{phase} {e}x{c}x{d}x{f}", x,
                               ws, g, dtype, ma)
            simt_err = _quant_check(name, fused, f"{phase}, simt", x, ws, g,
                                    dtype, ma, "simt")
            want = plain()
            lib_err = float((library().float() - want.float()).abs().max())
            # the simt path at prefill takes ~10x the wgmma's time a call
            timer = None if phase == "decode" else \
                (lambda fn: time_ms(fn, iters=5, reps=3))
            ms, simt_ms = _alternate(run, run_simt, timer)
            if phase == "decode":   # the host cost of each path a call
                us, simt_us = _alternate(run, run_simt, host_us)
                log(f"  {name:<20} {phase:<8} host us a call, in turns: "
                    f"wgmma {us:.1f}, simt {simt_us:.1f}")
                # the same active slots packed into a bank of their own:
                # what the bank's empty slots cost a call
                xp, gp = x[idx].contiguous(), g[idx].contiguous()
                wsp = [w[idx].contiguous() for w in ws]
                run_packed = lambda: run_k(  # noqa: E731
                    xp, *wsp, gp, max_active=ma)
                sparse_ms, packed_ms = _alternate(run, run_packed)
                log(f"  {name:<20} {phase:<8} in turns: E={e} with "
                    f"{len(idx)} active ms={sparse_ms:.4f}, the same slots "
                    f"packed as E={len(idx)} ms={packed_ms:.4f}")
                del xp, gp, wsp
            plain_ms = time_ms(plain, iters=5, reps=3)
            lib_ms = time_ms(library, iters=5, reps=3)
            nbytes, flops = _quant_bytes_flops(x, ws, g)
            b_ms, b_by = bound(nbytes, flops, dtype)
            log(f"  {name:<20} {phase:<8} E={e} C={c} D={d} F={f} bf16 x, "
                f"int8 W, {len(idx)} active slots ({path}, N="
                f"{info['rows']}, {info['stages']} stages, {info['smem']} B "
                f"shared a CTA) max_abs_err={err:.3e} ms={ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e9:.3f} GB) "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"(library max err {lib_err:.3e})")
            log(f"  {name:<20} {phase:<8} in turns with the plan's: simt "
                f"ms={simt_ms:.4f} (D split {simt_split}, max_abs_err="
                f"{simt_err:.3e})")
            if phase == "decode":
                rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib_ms, path=path,
                                 decode_simt_ms=simt_ms)
            else:
                rec[name].update(
                    prefill_ms=ms, prefill_bound_ms=b_ms,
                    prefill_plain_ms=plain_ms, prefill_library_ms=lib_ms,
                    prefill_max_abs_err=err, prefill_path=path,
                    prefill_simt_ms=simt_ms)
            del x, ws, want
            torch.cuda.empty_cache()
    return rec


def _offset_copy(t):
    """A contiguous copy of `t` starting one element (2 bytes in bf16, 4
    in f32) past a 16-byte-aligned buffer: no 16-byte copy can take it."""
    buf = torch.zeros(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == t.element_size()
    return out


def _attn_inputs(gen, b, h, kvh, hd, s, dtype, kv_len, q_pos, wrap,
                 past=None, offset=False):
    """Seeded inputs; with `past`, k and v hold that value in every lane
    at or past the row's kv_len; with `offset`, k and v start one
    element past an aligned buffer."""
    dev = "cuda"
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dtype)
    kv_len = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    q_pos = torch.tensor(q_pos, dtype=torch.int32, device=dev)
    slot = torch.arange(s, dtype=torch.int32, device=dev)[None]
    if past is not None:
        beyond = (slot >= kv_len[:, None])[:, :, None, None]
        k = torch.where(beyond, past, k).to(dtype)
        v = torch.where(beyond, past, v).to(dtype)
    if offset:
        k, v = _offset_copy(k), _offset_copy(v)
    if wrap:
        # ring holding the last s positions up to q_pos: slot i holds the
        # largest position p <= q_pos with p % s == i
        qp = q_pos[:, None]
        pos = qp - torch.remainder(qp - slot, s)
    else:
        pos = slot.expand(b, s)
    return q, k, v, pos.contiguous().to(torch.int32), kv_len, q_pos


def _path_label(q, k, v, tables=None) -> str:
    path, info = DA.kernel_path(q, k, v, block_tables=tables)
    return f"{path}, cluster {info['nsplit']}"


# rows with no visible lane: kv_len = 0; every lane below kv_len hidden
# by position (q_pos = -1); under a window of 16, every lane older than
# it (q_pos = 100, positions 0..19); beside a partial and a full row
HIDDEN_LEN = [0, 10, 23, 40, 20]
HIDDEN_QPOS = [5, -1, 22, 39, 100]


def check_decode_attention(gen, shape) -> dict:
    """The contiguous kernel against its plain version: GQA groups 1-8,
    hd 18/32/64/128, kv_len < S, wrapped rings, windows, rows with no
    visible lane, lanes past kv_len holding 1e4, an unsplit grid, the
    largest cluster and k/v one element off alignment, in float32 and
    bfloat16, each with its path; then the main path's shape: its path
    ("mma"), one launch a call, and its time eager and in a CUDA graph
    beside its bound, the plain version and SDPA."""
    cases = [  # (label, B, H, KV, hd, S, kv_len, q_pos, wrap, window,
        #          past, offset)
        ("GQA 1", 2, 4, 4, 64, 96, [96, 50], [95, 49], False, 0, None,
         False),
        ("GQA 2", 3, 8, 4, 128, 70, [70, 1, 33], [69, 0, 32], False, 0,
         None, False),
        ("GQA 4, kv_len<S", 2, 8, 2, 128, 130, [77, 130], [76, 129],
         False, 0, None, False),
        ("wrapped ring", 2, 8, 2, 64, 64, [64, 64], [150, 64], True, 0,
         None, False),
        ("window 16", 2, 8, 2, 64, 100, [100, 60], [99, 59], False, 16,
         None, False),
        ("ring + window", 2, 4, 2, 32, 48, [48, 48], [200, 90], True, 20,
         None, False),
        ("hd=18 (scalar loads)", 2, 4, 2, 18, 50, [50, 31], [49, 30],
         False, 0, None, False),
        ("B=40, S unsplit", 40, 8, 8, 64, 40,
         [40 - i % 7 for i in range(40)], [39 - i % 7 for i in range(40)],
         False, 0, None, False),
        ("no visible lane", 5, 8, 2, 128, 40, HIDDEN_LEN, HIDDEN_QPOS, False,
         16, 1e4, False),
        ("no visible lane, G 1", 5, 2, 2, 64, 40, HIDDEN_LEN, HIDDEN_QPOS,
         False, 16, 1e4, False),
        ("no visible lane, G 8", 5, 16, 2, 64, 40, HIDDEN_LEN, HIDDEN_QPOS,
         False, 16, 1e4, False),
        ("no visible lane, hd 18", 5, 8, 2, 18, 40, HIDDEN_LEN, HIDDEN_QPOS,
         False, 16, 1e4, False),
        ("past kv_len 1e4", 3, 32, 8, 128, 561, [560, 301, 17],
         [559, 300, 16], False, 0, 1e4, False),
        ("B*KV 288, unsplit", 36, 32, 8, 128, 40,
         [40 - i % 9 for i in range(36)], [39 - i % 9 for i in range(36)],
         False, 0, 1e4, False),
        ("one group, cluster 8", 1, 4, 1, 128, 2000, [1777], [1776], False,
         300, 1e4, False),
        ("k/v off alignment", 5, 8, 2, 64, 40, HIDDEN_LEN, HIDDEN_QPOS, False,
         16, 1e4, True),
    ]
    for label, b, h, kvh, hd, s, kl, qp, wrap, win, past, off in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, pos, kv_len, q_pos = _attn_inputs(
                gen, b, h, kvh, hd, s, dtype, kl, qp, wrap, past, off)
            got = DA.decode_attention(q, k, v, pos, kv_len, q_pos,
                                      window=win)
            want = DA.decode_attention_ref(q, k, v, pos, kv_len, q_pos,
                                           window=win)
            torch.cuda.synchronize()
            err = check(f"decode_attention [{label}, {dtype}]", got, want,
                        dtype)
            log(f"  {'decode_attention':<16} {label:<22} {str(dtype):<15} "
                f"{_path_label(q, k, v):<16} max_abs_err={err:.3e}")
    b, h, kvh, hd, s, kl = shape
    dtype = torch.bfloat16
    q, k, v, pos, kv_len, q_pos = _attn_inputs(
        gen, b, h, kvh, hd, s, dtype, kl, [x - 1 for x in kl], False)
    path, info = DA.kernel_path(q, k, v)
    if path != "mma":
        raise AssertionError(f"decode_attention: the main shape took "
                             f"{path!r}, not 'mma'")
    run = lambda: DA.decode_attention(q, k, v, pos, kv_len, q_pos)  # noqa
    plain = lambda: DA.decode_attention_ref(q, k, v, pos, kv_len,  # noqa
                                            q_pos)
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = check("decode_attention [decode]", got, want, dtype)
    one_launch("decode_attention", run)
    g = h // kvh
    kr = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vr = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    slot = torch.arange(s, device="cuda")[None]
    vis = (slot < kv_len[:, None]) & (pos <= q_pos[:, None])
    amask = torch.where(vis, 0.0, DA.NEG_INF).to(dtype)[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, kr, vr, attn_mask=amask)
    ms, plain_ms, lib_ms = time_ms(run), time_ms(plain), time_ms(library)
    dev_ms, lib_dev_ms = _alternate(run, library, graph_ms)
    n_vis = int(kv_len.clamp(max=s).sum())
    isz = q.element_size()
    nbytes = (2 * b * h * hd + 2 * n_vis * kvh * hd) * isz \
        + 4 * (n_vis + 2 * b)
    flops = 4.0 * n_vis * h * hd
    b_ms, b_by = bound(nbytes, flops, dtype)
    log(f"  {'decode_attention':<16} decode   B={b} H={h} KV={kvh} hd={hd} "
        f"S={s} bf16 path={path} cluster={info['nsplit']} "
        f"stages={info['stages']} smem={info['smem']} B "
        f"max_abs_err={err:.3e} ms={ms:.4f} device_ms={dev_ms:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}) plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} library_device_ms={lib_dev_ms:.4f} "
        f"(SDPA; device times in a CUDA graph, in turns)")
    return {"decode_attention": dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
        library_device_ms=lib_dev_ms, path=path)}


def _paged_inputs(gen, b, h, kvh, hd, blk, nbs, kv_len, dtype, share=0,
                  q_pos=None, past=None, offset=False):
    """A shuffled pool: each row's chain is a random choice of pool
    blocks (not contiguous), rows 0 and 1 share their first `share`
    blocks, unassigned table entries point at trash block 0, and every
    pool lane not on a chain holds a random position. q_pos defaults to
    kv_len - 1 (at least 0); with `past`, k and v hold that value in
    block 0 and in every chain lane at or past the row's kv_len; with
    `offset`, k and v start one element past an aligned buffer."""
    dev = gen.device
    nb = 1 + b * nbs
    order = torch.randperm(nb - 1, generator=gen, device=dev).cpu() + 1
    tables = torch.zeros((b, nbs), dtype=torch.int32)
    used = [-(-n // blk) for n in kv_len]
    at = 0
    for r in range(b):
        tables[r, :used[r]] = order[at:at + used[r]]
        at += used[r]
    tables[1, :share] = tables[0, :share]
    kv_pos = torch.randint(-50, 1000, (nb, blk), generator=gen, device=dev,
                           dtype=torch.int32)
    for r in range(b):
        ids = tables[r, :used[r]].long().to(dev)
        kv_pos[ids] = (torch.arange(used[r] * blk, dtype=torch.int32,
                                    device=dev).reshape(used[r], blk))
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((nb, blk, kvh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((nb, blk, kvh, hd), generator=gen, device=dev).to(dtype)
    if past is not None:
        for t in (k, v):
            t[0] = past
            for r, n in enumerate(kv_len):
                if n % blk:
                    t[int(tables[r, n // blk]), n % blk:] = past
    if offset:
        k, v = _offset_copy(k), _offset_copy(v)
    q_pos = (torch.tensor(kv_len, dtype=torch.int32, device=dev) - 1).clamp(
        min=0) if q_pos is None else torch.tensor(q_pos, dtype=torch.int32,
                                                  device=dev)
    kv_len = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return q, k, v, kv_pos, tables.to(dev), kv_len, q_pos


def _paged_bytes_flops(q, k, tables, kv_len, window, kv_pos, q_pos):
    """Bytes and operations these inputs need: K, V and positions of each
    distinct visible pool lane (a shared block counts once), V of every
    lane of a fully hidden row (it averages them), the tables, q, the
    output and the lengths; two products per visible (row, lane, head)
    and the hidden rows' averaging."""
    b, h, hd = q.shape
    blk, kvh = k.shape[1], k.shape[2]
    nbs = tables.shape[1]
    s = nbs * blk
    slot = torch.arange(s, device=q.device)
    lane = tables.long().repeat_interleave(blk, dim=1) * blk + slot % blk
    pos = kv_pos.reshape(-1)[lane]
    vis = (slot[None] < kv_len[:, None]) & (pos <= q_pos[:, None])
    if window:
        vis = vis & (pos > q_pos[:, None] - window)
    hidden = ~vis.any(dim=1)
    n_vis = int(vis.sum())
    lanes_vis = int(torch.unique(lane[vis]).numel())
    lanes_hidden = int(torch.unique(lane[hidden]).numel())
    isz = q.element_size()
    row = kvh * hd * isz
    nbytes = (lanes_vis * (2 * row + 4) + lanes_hidden * row
              + 2 * b * h * hd * isz + 4 * (b * nbs + 2 * b))
    flops = 4.0 * n_vis * h * hd + 2.0 * int(hidden.sum()) * s * h * hd
    return nbytes, flops


def check_decode_attention_paged(gen, shape) -> dict:
    """The paged kernel against its plain version: adversarial block
    sizes (1, 3, 16, 32), rows with no visible lane beside lanes past
    kv_len and a trash block holding 1e4, k/v one element off alignment,
    then the main path's shape with shuffled tables, two rows sharing
    prefix blocks, a kv_len = 0 row and a full row, with and without a
    window, in float32 and bfloat16, each with its path; timed at the
    main path's shape, eager and in a CUDA graph, beside its bound, the
    plain version and the nearest library composition (gather then
    SDPA: two calls)."""
    cases = [  # (label, B, H, KV, hd, blk, nbs, kv_len, share, window,
        #          q_pos, past, offset)
        ("blk 1", 3, 8, 2, 64, 1, 40, [40, 17, 0], 10, 0, None, None,
         False),
        ("blk 3", 3, 8, 4, 32, 3, 13, [39, 20, 5], 4, 0, None, None, False),
        ("blk 16, GQA 4", 4, 8, 2, 128, 16, 6, [96, 50, 0, 33], 3, 0, None,
         None, False),
        ("blk 32 > tile", 2, 4, 2, 64, 32, 3, [96, 70], 2, 0, None, None,
         False),
        ("blk 16, window 12", 3, 8, 2, 64, 16, 5, [80, 61, 30], 3, 12, None,
         None, False),
        ("hd=18 (scalar loads)", 2, 4, 2, 18, 3, 7, [21, 10], 3, 0, None,
         None, False),
    ]
    for cblk in (1, 3, 16, 32):
        cnbs = -(-40 // cblk)
        kl = [0, 10, 23, cnbs * cblk, 20]
        qp = [5, -1, 22, cnbs * cblk - 1, 100]
        cases.append((f"no visible lane, blk {cblk}", 5, 8, 2, 128, cblk,
                      cnbs, kl, 0, 16, qp, 1e4, False))
    cases.append(("k/v off alignment", 3, 8, 2, 64, 16, 3, [40, 0, 17], 0, 0,
                  None, 1e4, True))
    b, h, kvh, hd, blk, nbs = shape
    full = nbs * blk
    main_len = [full, full - blk, 0, full - 3 * blk - 5, 2 * full // 3,
                full // 2 + 3, full // 4 + 1, 17][:b]
    share = max(full // blk - 3, 0)
    cases += [("main shape", b, h, kvh, hd, blk, nbs, main_len, share, 0,
               None, 1e4, False),
              ("main shape, window 64", b, h, kvh, hd, blk, nbs, main_len,
               share, 64, None, 1e4, False)]
    for (label, cb, ch, ckv, chd, cblk, cnbs, kl, sh, win, qp, past,
         off) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = _paged_inputs(gen, cb, ch, ckv, chd, cblk, cnbs, kl,
                                 dtype, sh, qp, past, off)
            got = DA.decode_attention_paged(*args, window=win)
            want = DA.decode_attention_paged_ref(*args, window=win)
            torch.cuda.synchronize()
            err = check(f"decode_attention_paged [{label}, {dtype}]", got,
                        want, dtype)
            log(f"  {'decode_attention_paged':<22} {label:<22} "
                f"{str(dtype):<15} "
                f"{_path_label(*args[:3], args[4]):<16} "
                f"max_abs_err={err:.3e}")
    dtype = torch.bfloat16
    args = _paged_inputs(gen, b, h, kvh, hd, blk, nbs, main_len, dtype,
                         share)
    q, k, v, kv_pos, tables, kv_len, q_pos = args
    path, info = DA.kernel_path(q, k, v, block_tables=tables)
    if path != "mma":
        raise AssertionError(f"decode_attention_paged: the main shape took "
                             f"{path!r}, not 'mma'")
    run = lambda: DA.decode_attention_paged(*args)  # noqa: E731
    plain = lambda: DA.decode_attention_paged_ref(*args)  # noqa: E731
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = check("decode_attention_paged [decode]", got, want, dtype)
    one_launch("decode_attention_paged", run)
    g = h // kvh
    tab = tables.long()
    slot = torch.arange(full, device=q.device)
    gpos = kv_pos[tab].reshape(b, full)
    vis = (slot[None] < kv_len[:, None]) & (gpos <= q_pos[:, None])
    amask = torch.where(vis, 0.0, DA.NEG_INF).to(dtype)[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():   # two calls: the gather, then SDPA over repeated KV
        gk = k[tab].reshape(b, full, kvh, hd)
        gv = v[tab].reshape(b, full, kvh, hd)
        return F.scaled_dot_product_attention(
            q4, gk.repeat_interleave(g, dim=2).transpose(1, 2),
            gv.repeat_interleave(g, dim=2).transpose(1, 2), attn_mask=amask)
    lib_err = float((library()[:, :, 0].float() - want.float())[
        vis.any(dim=1)].abs().max())
    ms, plain_ms, lib_ms = time_ms(run), time_ms(plain), time_ms(library)
    dev_ms, lib_dev_ms = _alternate(run, library, graph_ms)
    nbytes, flops = _paged_bytes_flops(q, k, tables, kv_len, 0, kv_pos,
                                       q_pos)
    b_ms, b_by = bound(nbytes, flops, dtype)
    log(f"  {'decode_attention_paged':<22} decode B={b} H={h} KV={kvh} "
        f"hd={hd} blk={blk} nbs={nbs} NB={k.shape[0]} bf16 path={path} "
        f"cluster={info['nsplit']} stages={info['stages']} "
        f"smem={info['smem']} B max_abs_err={err:.3e} ms={ms:.4f} "
        f"device_ms={dev_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, "
        f"{nbytes / 1e6:.2f} MB) plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} library_device_ms={lib_dev_ms:.4f} "
        f"(gather + SDPA, 2 calls; its max err on rows with a visible lane "
        f"{lib_err:.3e}; device times in a CUDA graph, in turns)")
    return {"decode_attention_paged": dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
        library_device_ms=lib_dev_ms, path=path)}


def main_path_shapes(cfg, slots: int, bucket: int, max_len: int):
    """Kernel shapes the full-width serving runs give each wrapper."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cf = cfg.moe.capacity_factor
    d, f = cfg.d_model, cfg.moe.d_ff
    cap_dec = max(1, math.ceil(cf * k * slots / e))
    cap_pre = max(1, math.ceil(cf * k * bucket / e))
    rng = np.random.default_rng(0)
    gs_dec = rng.integers(1, cap_dec + 1, e).tolist()
    gs_pre = rng.integers(cap_pre // 2, cap_pre + 1, e).tolist()
    # the EP slot plane of phase 4c: 64 slots (8 devices x 8), each with
    # the per-expert capacity; at decode at most slots * k of them get
    # rows, the bound the EP layer hands the kernels (prefill: all)
    n_slots = EP_DEVICES * EP_SLOTS_PER_DEVICE
    active = rng.choice(n_slots, 2 * e, replace=False)
    q_dec, q_pre = [0] * n_slots, [0] * n_slots
    for i in active:
        q_dec[i] = int(rng.integers(1, cap_dec + 1))
        q_pre[i] = int(rng.integers(cap_pre // 4, cap_pre + 1))
    return {
        "fused_gate_up": {"decode": (e, cap_dec, d, f, gs_dec),
                          "prefill": (e, cap_pre, d, f, gs_pre)},
        "gmm": {"decode": (e, cap_dec, f, d, gs_dec),
                "prefill": (e, cap_pre, f, d, gs_pre)},
        "fused_gate_up_quant": {"decode": (n_slots, cap_dec, d, f, q_dec),
                                "prefill": (n_slots, cap_pre, d, f, q_pre)},
        "gmm_quant": {"decode": (n_slots, cap_dec, f, d, q_dec),
                      "prefill": (n_slots, cap_pre, f, d, q_pre)},
        "max_active": {"decode": min(n_slots, slots * k),
                       "prefill": min(n_slots, bucket * k)},
        "decode_attention": (slots, cfg.num_heads, cfg.num_kv_heads,
                             cfg.resolved_head_dim, max_len,
                             [max_len - 1 - 37 * i for i in range(slots)]),
        "decode_attention_paged": (slots, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.resolved_head_dim, PAGED_BLOCK,
                                   -(-max_len // PAGED_BLOCK)),
    }


# ------------------------------------------------------------ phase 4


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def make_requests(cfg, lens, gens, n, seed=0, sampled=False):
    """`n` requests at t=0 with random prompts; with `sampled`, every
    odd request samples (temperature 0.9, top-p 0.9, top-k 40 on every
    other one, its own seed)."""
    from repro_torch.serving.scheduler import GenRequest, SamplingParams
    rng = np.random.default_rng(seed)
    return [GenRequest(rid=i, arrival=0.0,
                       prompt=rng.integers(0, cfg.vocab_size,
                                           size=lens[i % len(lens)],
                                           dtype=np.int32),
                       max_new_tokens=gens[i % len(gens)],
                       sampling=SamplingParams(
                           temperature=0.9, top_p=0.9,
                           top_k=40 * (i % 4 == 1), seed=100 + i)
                       if sampled and i % 2 else SamplingParams())
            for i in range(n)]


def serve_timed(engine, reqs, slots: int, control=None):
    """Serve `reqs` to completion (with `control` as the session control
    plane), timing every model call (prefill by bucket, batched decode)
    between host syncs. Returns (result, launch counts of this run,
    prefill seconds by bucket, decode seconds, decode tokens, wall
    seconds)."""
    prefill_s: dict[int, list[float]] = {}
    decode_s: list[float] = []
    decode_tok = [0]
    inner = engine._step

    def timed(batch, cache, cache_len, collect, ep=None):
        t = time.perf_counter()
        out = inner(batch, cache, cache_len, collect, ep=ep)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if isinstance(cache_len, int):
            prefill_s.setdefault(batch["tokens"].shape[1], []).append(dt)
        else:
            decode_s.append(dt)
            decode_tok[0] += int(batch["active"].sum())
        return out

    engine._step = timed
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        engine.start(num_slots=slots, control=control)
        for r in reqs:
            engine.submit(r)
        res = engine.run()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        engine.close()
    finally:
        del engine._step
    return res, launches, prefill_s, decode_s, decode_tok[0], wall


def compare_logits(name, got, want, loads_got, loads_want) -> dict:
    """Kernel-path logits against plain-path logits from the same state:
    max |diff|, the relative L2 error, the share of elements outside
    the bf16 elementwise tolerance, argmax agreement per row, and
    whether every MoE layer routed the same expert loads (a near-tied
    router choice flips on a last-bit difference, and a token sent to
    another expert changes its logits by far more than rounding)."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel-path logits")
    tol = TOL[torch.bfloat16]
    out = {
        "max_abs_err": float((g - w).abs().max()),
        "rel_l2": float((g - w).norm() / w.norm()),
        "outside_elementwise_tol": float(
            (~torch.isclose(g, w, atol=tol, rtol=tol)).float().mean()),
        "argmax_equal": float((g.argmax(-1) == w.argmax(-1)).float().mean()),
        "same_expert_loads": bool(torch.equal(loads_got, loads_want)),
    }
    log(f"  logits {name}: " + ", ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in out.items()))
    return out


def sublayer_check(name, cfg, params, tokens, cache, cache_len,
                   token_mask, block_tables=None, ep=None) -> dict:
    """Every layer's attention and MoE sublayer through the kernels and
    through the plain path, both from the same input (the plain path's
    hidden state), so both route identically: each output pair must
    agree elementwise within the bf16 tolerance. With `block_tables` the
    cache is the paged pool and every row writes one token. With `ep` =
    (EPContext, ep_state) the MoE sublayers run through the EP slot
    plane on the runtime's tables and banks. Returns the largest error
    of each sublayer kind."""
    from repro_torch.distributed.ep import moe_ep_ffn
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    pattern = T.layer_pattern(cfg)
    assert [sub.ffn for sub in pattern] == ["moe"], pattern
    b, s = tokens.shape
    steps = torch.arange(s, dtype=torch.int32, device=tokens.device)
    if isinstance(cache_len, int):
        pos = (cache_len + steps)[None].expand(b, s)
    else:
        pos = cache_len[:, None] + steps[None]
    errs = {"attention": 0.0, "moe": 0.0}
    x = params["embed"][tokens.long()]
    for i in range(cfg.num_layers):
        p = T._period(params["layers"][0], i)
        c = T._period(cache[0], i)["attn"]
        h = L.norm(x, p["norm1"], cfg.norm)
        outs = []
        for impl in ("auto", "ref"):
            own = {k: v.clone() for k, v in c.items()}
            outs.append(L.attention_block(p["attn"], cfg, h, pos,
                                          cache=own, cache_len=cache_len,
                                          impl=impl,
                                          block_tables=block_tables)[0])
        errs["attention"] = max(errs["attention"], check(
            f"{name}, layer {i} attention", outs[0], outs[1],
            torch.bfloat16))
        x = x + outs[1]
        h = L.norm(x, p["norm2"], cfg.norm)
        if ep is not None:
            ctx, state = ep
            outs = [moe_ep_ffn(p["moe"], h, T._period(state[0], i), ctx,
                               cfg.with_(impl=impl),
                               token_mask=token_mask)[0]
                    for impl in ("auto", "ref")]
        else:
            outs = [MOE.dispatch_moe(
                p["moe"], h, top_k=cfg.moe.top_k,
                num_experts=cfg.moe.num_experts,
                capacity_factor=cfg.moe.capacity_factor, act=cfg.act,
                groups=T._moe_groups(h), token_mask=token_mask,
                impl=impl)[0]
                for impl in ("auto", "ref")]
        errs["moe"] = max(errs["moe"], check(
            f"{name}, layer {i} MoE", outs[0], outs[1], torch.bfloat16))
        x = x + outs[1]
    log(f"  {name}: every layer's sublayers, kernels vs plain from the "
        f"same input: attention max_abs_err={errs['attention']:.3e}, MoE "
        f"max_abs_err={errs['moe']:.3e} (atol=rtol={TOL[torch.bfloat16]})")
    return errs


def logits_check(cfg, params, prompts, max_len: int, slots: int):
    """The longest prompt's prefill and one batched decode step from a
    pool of `slots` prefilled prompts, through the kernels and through
    the plain path from the same state: per-sublayer checks with the
    same inputs, then the full-model logits compared and reported."""
    from repro_torch.models import transformer as T
    ref_cfg = cfg.with_(impl="ref")
    dev = params["embed"].device
    res = {}
    with torch.no_grad():
        longest = max(prompts, key=len)
        toks = torch.from_numpy(longest[None].astype(np.int64)).to(dev)
        res["prefill sublayers"] = sublayer_check(
            f"prefill of {len(longest)} tokens", cfg, params, toks,
            T.init_cache(cfg, params, 1, max_len), 0, None)
        outs = []
        for c in (cfg, ref_cfg):
            cache = T.init_cache(c, params, 1, max_len)
            lg, _, m = T.decode_step(c, params, {"tokens": toks}, cache, 0)
            outs.append((lg[0, -1], m["expert_load"]))
        res["prefill logits"] = compare_logits(
            "prefill, last position", outs[0][0], outs[1][0], outs[0][1],
            outs[1][1])
        # a batched state: `slots` prompts prefilled (plain path) into
        # one pool at per-row lengths, then one decode step
        lens = [min(len(p), 128 + 16 * i) for i, p in
                enumerate(prompts[:slots])]
        plen = max(lens)
        batch_toks = torch.from_numpy(np.stack(
            [np.pad(p[:n], (0, plen - n)) for p, n in
             zip(prompts[:slots], lens)]).astype(np.int64)).to(dev)
        pool = T.init_cache(ref_cfg, params, slots, max_len)
        lg, _, _ = T.decode_step(ref_cfg, params, {"tokens": batch_toks},
                                 pool, 0)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        nxt = lg[torch.arange(slots, device=dev), lengths - 1] \
            .argmax(-1)[:, None]
        active = torch.ones(slots, dtype=torch.bool, device=dev)
        res["decode sublayers"] = sublayer_check(
            "batched decode step", cfg, params, nxt, pool, lengths,
            active[:, None])
        outs = []
        for c in (cfg, ref_cfg):
            state = [{"attn": {k: v.clone() for k, v in d["attn"].items()}}
                     for d in pool]
            lg, _, m = T.decode_step(c, params, {"tokens": nxt,
                                                 "active": active},
                                     state, lengths)
            outs.append((lg[:, -1], m["expert_load"]))
        res["decode logits"] = compare_logits(
            "batched decode step", outs[0][0], outs[1][0], outs[0][1],
            outs[1][1])
    return res


# ------------------------------------------------------------ phase 4b


def serve_waves(engine, waves, slots: int):
    """Serve each wave of requests to completion in ONE session (start,
    submit, run, submit, run), timing every model call between host
    syncs by kind: mixed (prompt chunks in the step) or decode-only.
    Returns (launch counts of this run, mixed seconds, decode seconds,
    wall seconds)."""
    mixed_s: list[float] = []
    decode_s: list[float] = []
    inner = engine._step

    def timed(batch, cache, cache_len, collect, ep=None):
        t = time.perf_counter()
        out = inner(batch, cache, cache_len, collect, ep=ep)
        torch.cuda.synchronize()
        (mixed_s if batch["tokens"].shape[1] > 1 else decode_s).append(
            time.perf_counter() - t)
        return out

    engine._step = timed
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        engine.start(num_slots=slots)
        for wave in waves:
            for r in wave:
                engine.submit(r)
            engine.run()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
    finally:
        del engine._step
    return launches, mixed_s, decode_s, wall


def shared_prefix_waves(cfg, system_len: int, suffixes, gens, seed=1):
    """Two waves of requests that share one system prompt: wave 1 has a
    unique suffix per request; wave 2 repeats wave 1's request
    `repeat[0]` exactly (its length chosen so the prefix match ends
    inside a block: a copy-on-write) and gives the others new suffixes."""
    from repro_torch.serving.scheduler import GenRequest
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size, system_len, dtype=np.int32)
    prompts = []
    for wave in suffixes:
        prompts.append([np.concatenate([system, rng.integers(
            0, cfg.vocab_size, n, dtype=np.int32)]) for n in wave])
    repeat = next(i for i, p in enumerate(prompts[0])
                  if (len(p) - 1) % PAGED_BLOCK)
    prompts[1][0] = prompts[0][repeat].copy()
    waves, rid = [], 0
    for wave in prompts:
        waves.append([])
        for p in wave:
            waves[-1].append(GenRequest(rid=rid, arrival=float("nan"),
                                        prompt=p,
                                        max_new_tokens=gens[rid % len(gens)]))
            rid += 1
    return waves


def paged_phase(cfg, params, max_len: int, slots: int, card: str) -> dict:
    """Phase 4b: the paged pool, chunked prefill and the prefix cache at
    full width, then every layer's paged attention sublayer through the
    kernel against the plain path. Returns this run's launch counts."""
    from repro_torch.configs import ServingSpec
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import MoElessController, ServingEngine
    spec = ServingSpec(kv="paged", kv_block=PAGED_BLOCK,
                       prefill_chunk=PAGED_CHUNK, prefix_cache=True)
    log(f"  serving: {spec}, {slots} slots, max_len {max_len}, "
        f"MoElessController(num_devices=8)")
    ctrl = MoElessController(cfg, num_devices=8)
    engine = ServingEngine(cfg, params, max_len=max_len, controller=ctrl,
                           serving=spec)
    waves = shared_prefix_waves(
        cfg, 256, [[64 + 27 * i for i in range(slots)],
                   [0] + [100 + 19 * i for i in range(slots - 1)]],
        (16, 32, 48))
    torch.cuda.reset_peak_memory_stats()
    launches, mixed_s, decode_s, wall = serve_waves(engine, waves, slots)
    peak = torch.cuda.max_memory_allocated()
    kv = engine._session.kv
    reqs = [r for w in waves for r in w]
    for r in reqs:
        if r.finish_reason != "length" or \
                len(r.tokens) != r.max_new_tokens:
            raise AssertionError(f"paged request {r.rid}: {len(r.tokens)} of "
                                 f"{r.max_new_tokens} tokens "
                                 f"({r.finish_reason!r})")
    nodes = list(kv.prefix._walk())
    log(f"  served 2 waves x {slots} requests, "
        f"{sum(len(r.tokens) for r in reqs)} tokens in "
        f"{len(mixed_s)} mixed + {len(decode_s)} decode-only steps; prefix "
        f"hits {kv.prefix.hits}, tokens saved {kv.prefix.tokens_saved}, "
        f"copy-on-write blocks {kv.cow_blocks}; pool {kv.num_blocks} blocks "
        f"of {kv.block_bytes} B, {kv.used_blocks} in use after the run, "
        f"{len(nodes)} held by the prefix cache")
    log(f"  launches in this run: {launches}")
    if kv.prefix.hits < slots or kv.prefix.tokens_saved <= 0:
        raise AssertionError("the second wave did not hit the prefix cache")
    if kv.cow_blocks < 1:
        raise AssertionError("the exact repeat made no copy-on-write")
    if kv.used_blocks != len(nodes) or kv.num_active or any(
            kv.refcount[n.block] != 1 for n in nodes):
        raise AssertionError(f"leaked blocks: {kv.used_blocks} in use, "
                             f"{len(nodes)} cached")
    for k_name in ("decode_attention_paged", "fused_gate_up", "gmm"):
        if launches[k_name] <= 0:
            raise AssertionError(f"{k_name} was never launched on the paged "
                                 "path")
    n_tok = sum(len(r.tokens) for r in reqs)
    log(f"  wall times on {card}:")
    log(f"    mixed step: median {np.median(mixed_s) * 1e3:.2f} ms over "
        f"{len(mixed_s)}; decode-only step: median "
        f"{np.median(decode_s) * 1e3:.2f} ms over {len(decode_s)}; "
        f"decode_attention_paged launches per decode-only step "
        f"{launches['decode_attention_paged'] / len(decode_s):.1f}, per "
        f"mixed step 0 (chunked attention over the gathered view)")
    log(f"    whole run: {wall:.2f} s, {n_tok / wall:.1f} tokens/s; "
        f"max_memory_allocated {peak / 1e9:.2f} GB")
    del engine, ctrl, kv
    torch.cuda.empty_cache()
    # every layer's paged attention sublayer from one batched state: the
    # wave-1 prompts prefilled (plain path) through shuffled tables into
    # a fresh pool, rows 0 and 1 sharing their system-prompt blocks,
    # then one decode step with every row writing one token
    ref_cfg = cfg.with_(impl="ref")
    dev = params["embed"].device
    nbs = -(-max_len // PAGED_BLOCK)
    prompts = [r.prompt for r in waves[0]]
    lens = [len(p) for p in prompts]
    gen = torch.Generator().manual_seed(3)
    order = (torch.randperm(slots * nbs, generator=gen) + 1).tolist()
    tables = torch.zeros((slots, nbs), dtype=torch.int32)
    for r, n in enumerate(lens):
        need = -(-(n + 1) // PAGED_BLOCK)
        tables[r, :need] = torch.tensor(order[:need], dtype=torch.int32)
        del order[:need]
    tables[1, :256 // PAGED_BLOCK] = tables[0, :256 // PAGED_BLOCK]
    tables = tables.to(dev)
    pool = T.init_paged_cache(cfg, params, 1 + slots * nbs, PAGED_BLOCK)
    toks = torch.from_numpy(np.stack([np.pad(p, (0, max(lens) - len(p)))
                                      for p in prompts]).astype(np.int64))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    with torch.no_grad():
        lg, _, _ = T.decode_step(
            ref_cfg, params, {"tokens": toks.to(dev), "block_tables": tables,
                              "new_counts": lengths},
            pool, torch.zeros(slots, dtype=torch.int32, device=dev))
        nxt = lg[torch.arange(slots, device=dev), lengths - 1] \
            .argmax(-1)[:, None]
        errs = sublayer_check("paged batched decode step", cfg, params, nxt,
                              pool, lengths,
                              torch.ones((slots, 1), dtype=torch.bool,
                                         device=dev), block_tables=tables)
    del pool, lg
    torch.cuda.empty_cache()
    return {"launches": launches, "sublayers": errs}


# ------------------------------------------------------------ phase 6

SYSTEM_LEN, GATEWAY_GEN = 256, 32   # phase 6: shared system prompt, budget


class HostedGateway:
    """A ``GatewayServer`` on 127.0.0.1 (a free port) on an asyncio loop
    in a background thread, over `router`; ``close`` stops the server,
    the loop, the thread and the router's replica threads."""

    def __init__(self, router):
        import asyncio
        import threading

        from repro_torch.serving.gateway import GatewayServer
        self.router = router
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.srv = GatewayServer(router, host="127.0.0.1", port=0)
        _, self.port = asyncio.run_coroutine_threadsafe(
            self.srv.start(), self.loop).result(60)

    def close(self) -> None:
        import asyncio
        try:
            asyncio.run_coroutine_threadsafe(self.srv.close(),
                                             self.loop).result(60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=60)
            self.router.stop()
        alive = [d.replica_id for d in self.router.replicas.values()
                 if d._thread is not None and d._thread.is_alive()]
        if self.thread.is_alive() or alive:
            raise AssertionError(f"gateway threads still running (replicas "
                                 f"{alive})")


def _choice_tokens(choice: dict) -> list[int]:
    if "tokens" in choice:
        return choice["tokens"]
    return choice.get("message", choice.get("delta", {})).get("content", [])


def http_completion(port: int, body: dict, chat: bool) -> dict:
    """POST one completion to the gateway; SSE when body['stream']. Returns
    the tokens, the finish reason, the send time and each token's
    arrival time (host clock; unary: all at the response)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/chat/completions" if chat else
                 "/v1/completions", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    toks, times, reason = [], [], None
    try:
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status}: {resp.read()[:300]}")
        if body.get("stream"):
            while line := resp.readline():
                if not line.startswith(b"data: ") or \
                        line.strip() == b"data: [DONE]":
                    continue
                ch = json.loads(line[6:])["choices"][0]
                got = _choice_tokens(ch)
                toks += got
                times += [time.perf_counter()] * len(got)
                reason = ch.get("finish_reason") or reason
        else:
            ch = json.loads(resp.read())["choices"][0]
            toks, reason = _choice_tokens(ch), ch["finish_reason"]
            times = [time.perf_counter()] * len(toks)
    finally:
        conn.close()
    return {"tokens": toks, "finish": reason, "t0": t0, "times": times}


def gateway_traffic(cfg, n: int = 16, seed: int = 6):
    """`n` requests sharing a SYSTEM_LEN-token system prompt, with
    128-384-token tails and a budget of GATEWAY_GEN: odd ones sample
    (temperature 0.8, top-k 50, top-p 0.95, a seed each), requests 2-3
    of every 4 stream (SSE), 4-7 of every 8 use the chat endpoint.
    Returns [(GenRequest, HTTP body, chat)]."""
    from repro_torch.serving.scheduler import GenRequest, SamplingParams
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size, SYSTEM_LEN).tolist()
    out = []
    for i in range(n):
        tail = rng.integers(0, cfg.vocab_size, 128 + 16 * i).tolist()
        samp = SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                              seed=1000 + i) if i % 2 else SamplingParams()
        body = {"max_tokens": GATEWAY_GEN, "stream": i % 4 >= 2,
                "temperature": samp.temperature, "top_k": samp.top_k,
                "top_p": samp.top_p, "seed": samp.seed}
        chat = i % 8 >= 4
        if chat:
            body["messages"] = [{"role": "system", "content": system},
                                {"role": "user", "content": tail}]
        else:
            body["prompt"] = system + tail
        req = GenRequest(rid=i, arrival=0.0,
                         prompt=np.asarray(system + tail, np.int32),
                         max_new_tokens=GATEWAY_GEN,
                         sampling=samp)
        out.append((req, body, chat))
    return out


def _stop_cut(tokens: list[int], stop: list[int]) -> list[int]:
    """`tokens` cut where they first end with `stop`, as the scheduler
    ends a request on a stop sequence (the stop tokens kept)."""
    for j in range(len(stop), len(tokens) + 1):
        if tokens[j - len(stop):j] == stop:
            return tokens[:j]
    raise ValueError(f"{stop} is not in {tokens}")


def _latencies(t0: float, times: list[float]) -> tuple[float, float, float]:
    """(TTFT, TPOT, E2E) seconds of one request from its token times."""
    ttft, e2e = times[0] - t0, times[-1] - t0
    tpot = (times[-1] - times[0]) / (len(times) - 1) if len(times) > 1 \
        else float("nan")
    return ttft, tpot, e2e


def _medians_ms(rows) -> str:
    a = np.asarray(rows, float) * 1e3
    return (f"TTFT {np.nanmedian(a[:, 0]):.1f} ms, TPOT "
            f"{np.nanmedian(a[:, 1]):.2f} ms, E2E {np.nanmedian(a[:, 2]):.1f} "
            f"ms")


def offline_latencies(cfg, params, spec, max_len, slots, traffic):
    """The same requests through two offline engines (the gateway's two
    replicas' shapes; request i on engine i % 2), stepped in turns in
    this thread, every request submitted at once: per request (TTFT,
    TPOT, E2E) from host-clock token times, and its tokens."""
    from repro_torch.serving.engine import ServingEngine
    engines = [ServingEngine(cfg, params, max_len=max_len, serving=spec)
               for _ in range(2)]
    times: dict[int, list[float]] = {}

    def hook(events):
        now = time.perf_counter()
        for ev in events:
            times.setdefault(ev.rid, []).append(now)

    reqs = [r for r, _, _ in traffic]
    t0 = time.perf_counter()
    for i, eng in enumerate(engines):
        eng.add_step_hook(hook)
        eng.start(num_slots=slots)
        for r in reqs[i::2]:
            eng.submit(r)
    while any(e.has_work for e in engines):
        for e in engines:
            e.step()
    for e in engines:
        e.close()
    return {r.rid: _latencies(t0, times[r.rid]) for r in reqs}, \
        {r.rid: list(r.tokens) for r in reqs}


def gateway_phase(cfg, params, card: str) -> dict:
    """Phase 6: the OpenAI-compatible gateway at full width. A
    ``GatewayServer`` (127.0.0.1, a free port, its own thread) over a
    ``Router`` of 2 replicas that share `params`, each on the paged
    spec of phase 4b (16-token blocks, 256-token chunked prefill, prefix
    cache), drop-free (capacity factor = experts), 8 slots, with a
    session ``MoElessController``; telemetry on. Checks, each fatal: a
    greedy and a sampled request, each sent alone, give the tokens of
    ``engine.serve`` of the same request alone; the sampled one sent
    again (SSE) gives them again; each sent again with a stop sequence
    from its own answer (greedy: one token, unary; sampled: two, SSE)
    ends where its output first ends with it, finish "stop"; 16
    concurrent clients all end with their budget; /metrics is
    Prometheus text with the router, scheduler, KV and control
    families; the paged kernel and both bf16 ``moe_gmm`` kernels
    launched. Returns this phase's launch counts."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import ServingSpec
    from repro_torch.launch.profile_decode import trace_sampler
    from repro_torch.obs import Telemetry
    from repro_torch.serving.engine import MoElessController, ServingEngine
    from repro_torch.serving.gateway import (AutoscalerConfig, EngineDriver,
                                             Router)
    from repro_torch.serving.scheduler import GenRequest, SamplingParams
    cfg = cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    spec = ServingSpec(kv="paged", kv_block=PAGED_BLOCK,
                       prefill_chunk=PAGED_CHUNK, prefix_cache=True)
    slots, max_len = 8, SYSTEM_LEN + 128 + 16 * 15 + GATEWAY_GEN + 1
    tel = Telemetry()
    # host seconds of each replica step, and of each submission the
    # event loop makes (routing, subscribing and submitting take the
    # replicas' engine locks)
    step_s: list[float] = []
    submit_s: list[float] = []

    def timed(fn, out):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                out.append(time.perf_counter() - t)
        return run

    def factory(i: int):
        eng = ServingEngine(cfg, params, max_len=max_len, serving=spec,
                            telemetry=tel, name=f"replica{i}")
        eng.step = timed(eng.step, step_s)
        ctrl = MoElessController(cfg, num_devices=8, telemetry=tel,
                                 track=f"replica{i}/control")
        return EngineDriver(eng, replica_id=i, num_slots=slots,
                            max_pending=64, control=ctrl)

    log(f"  2 replicas sharing the weights: {spec}, {slots} slots each, "
        f"max_len {max_len}, capacity factor {cfg.moe.capacity_factor} "
        "(drop-free), a session MoElessController each, telemetry on")
    traffic = gateway_traffic(cfg)
    K.reset_launch_counts()
    router = Router(factory, threaded=True, telemetry=tel,
                    scaler=AutoscalerConfig(min_replicas=2, max_replicas=2))
    router.submit = timed(router.submit, submit_s)
    hosted = HostedGateway(router)
    try:
        # alone: a greedy and a sampled request (prompts of their own,
        # sharing no prefix) against engine.serve of the same request
        rng = np.random.default_rng(7)
        alone = []
        for samp in (SamplingParams(),
                     SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                    seed=77)):
            prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
            body = {"prompt": prompt, "max_tokens": GATEWAY_GEN,
                    "temperature": samp.temperature, "top_k": samp.top_k,
                    "top_p": samp.top_p, "seed": samp.seed}
            got = http_completion(hosted.port, body, chat=False)
            req = GenRequest(rid=0, arrival=0.0,
                             prompt=np.asarray(prompt, np.int32),
                             max_new_tokens=GATEWAY_GEN, sampling=samp)
            ServingEngine(cfg, params, max_len=max_len, serving=spec).serve(
                [req], num_slots=slots)
            if got["tokens"] != list(req.tokens):
                raise AssertionError(
                    f"alone, temperature {samp.temperature}: HTTP "
                    f"{got['tokens']} != engine.serve {list(req.tokens)}")
            alone.append((body, got["tokens"]))
        body, want = alone[1]
        again = http_completion(hosted.port, {**body, "stream": True},
                                chat=False)
        if again["tokens"] != want:
            raise AssertionError(f"the sampled request sent again (SSE) gave "
                                 f"{again['tokens']}, first {want}")
        # the stop path: each again with a stop sequence taken from its
        # own answer (greedy: one token, unary; sampled: two, SSE) ends
        # where its output first ends with it, finish "stop"
        for body, want, at, n, stream in ((*alone[0], 8, 1, False),
                                          (*alone[1], 12, 2, True)):
            stop = want[at:at + n]
            cut = _stop_cut(want, stop)
            got = http_completion(hosted.port, {**body, "stop": [stop],
                                                "stream": stream},
                                  chat=False)
            if got["finish"] != "stop" or got["tokens"] != cut:
                raise AssertionError(
                    f"stop {stop} (temperature {body['temperature']}): "
                    f"{got['tokens']} finish {got['finish']!r}, want {cut}")
            log(f"  stop {stop} (temperature {body['temperature']}, "
                f"{'SSE' if stream else 'unary'}): finish 'stop' after "
                f"{len(cut)} of {GATEWAY_GEN} tokens, ending with it")
        log(f"  alone: greedy and sampled (temperature 0.8, top-k 50, top-p "
            f"0.95, seed 77) requests over HTTP == engine.serve of each "
            f"alone ({GATEWAY_GEN} tokens each); the sampled one again over "
            f"SSE == its first answer")
        # 16 concurrent clients
        del submit_s[:], step_s[:]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(traffic)) as ex:
            futs = [ex.submit(http_completion, hosted.port, body, chat)
                    for _, body, chat in traffic]
            results = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        # /metrics as Prometheus text
        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", hosted.port,
                                          timeout=60)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        text = resp.read().decode()
        conn.close()
        router_m = hosted.router.metrics()
    finally:
        hosted.close()
    launches = K.launch_counts()
    families = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
        elif line and not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])
    missing = [p for p in ("router_", "scheduler_", "kv_", "control_")
               if not any(f.startswith(p) for f in families)]
    if resp.status != 200 or missing:
        raise AssertionError(f"/metrics: HTTP {resp.status}, families "
                             f"missing {missing}")
    for (req, body, chat), got in zip(traffic, results):
        if got["finish"] != "length" or len(got["tokens"]) != GATEWAY_GEN:
            raise AssertionError(f"request {req.rid}: {len(got['tokens'])} "
                                 f"tokens, finish {got['finish']!r}")
    for k_name in ("decode_attention_paged", "fused_gate_up", "gmm"):
        if launches[k_name] <= 0:
            raise AssertionError(f"{k_name} was never launched through the "
                                 "gateway")
    streamed = [i for i, (_, body, _) in enumerate(traffic)
                if body["stream"]]
    http_lat = [_latencies(results[i]["t0"], results[i]["times"])
                for i in streamed]
    off, off_tokens = offline_latencies(cfg, params, spec, max_len, slots,
                                        traffic)
    n_tok = sum(len(r["tokens"]) for r in results)
    log(f"  16 clients (8 greedy, 8 sampled; 8 SSE; 8 chat): {n_tok} "
        f"tokens in {wall:.2f} s "
        f"({n_tok / wall:.1f} tokens/s), finish reasons "
        f"{sorted(set(r['finish'] for r in results))}; router admitted "
        f"{router_m['router']['admitted']}, completed "
        f"{router_m['router']['completed']}, by replica "
        f"{[r['completed'] for r in router_m['replicas']]}")
    log(f"  /metrics: {len(families)} families, router/scheduler/kv/control "
        "present")
    log(f"  the event loop blocked in Router.submit (route, subscribe, "
        f"submit: the replicas' engine locks) {np.median(submit_s) * 1e3:.1f}"
        f" ms median, {max(submit_s) * 1e3:.1f} ms max, {sum(submit_s):.2f} s "
        f"in all over {len(submit_s)} submissions; a replica step took "
        f"{np.median(step_s) * 1e3:.1f} ms median over {len(step_s)} steps")
    log(f"  launches in this phase (HTTP and the two engine.serve runs of "
        f"the alone checks): {launches}")
    log(f"  wall latencies on {card}, medians over the 8 SSE requests:")
    log(f"    over HTTP:                    {_medians_ms(http_lat)}")
    log(f"    offline engines (2, in turns): "
        f"{_medians_ms([off[i] for i in streamed])}")
    same = sum(off_tokens[i] == results[i]["tokens"]
               for i in range(len(traffic)))
    log(f"    offline tokens equal to HTTP's for {same} of {len(traffic)} "
        "requests (batch composition and prefix-cache timing differ "
        "between the runs; not a check)")
    s_launch, s_kern = trace_sampler(cfg.padded_vocab, rows=slots)
    log(f"  sampler: {s_launch:.1f} kernel launches a sampled step (8 rows x "
        f"{cfg.padded_vocab}), device busy "
        f"{sum(ms for _, ms in s_kern):.4f} ms a call (torch.profiler)")
    return launches


# ------------------------------------------------------------ phase 4c


def runtime_phase(full, max_len: int, slots: int, card: str) -> dict:
    """Phase 4c: the expert runtime on the EP slot plane at full width
    with int8 slot banks (4 of 32 layers: the quantized padded bank, one
    64-slot bank and the layer's own experts take ~15.7 GB a layer),
    then every layer's EP MoE sublayer through the kernels against the
    plain path from the same input and the runtime's tables and banks.
    Returns this run's launch counts."""
    from repro_torch.core.costmodel import param_bytes
    from repro_torch.models import transformer as T
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import MoElessController, ServingEngine
    cfg = full.with_(num_layers=RUNTIME_LAYERS, moe=dataclasses.replace(
        full.moe, slot_dtype="int8"))
    log(f"  reduced: num_layers {full.num_layers}->{cfg.num_layers}; "
        f"slot_dtype int8; {slots} slots, contiguous KV, session "
        f"MoElessController(num_devices={EP_DEVICES}, slots_per_device="
        f"{EP_SLOTS_PER_DEVICE})")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  params made on the card in {time.perf_counter() - t0:.1f} s")
    ctrl = MoElessController(cfg, num_devices=EP_DEVICES,
                             slots_per_device=EP_SLOTS_PER_DEVICE)
    engine = ServingEngine(cfg, params, max_len=max_len,
                           expert_runtime="on", runtime_double_buffer=False)
    reqs = make_requests(cfg, (128, 256, 384, 512), (16, 32, 48), 12)
    torch.cuda.reset_peak_memory_stats()
    res, launches, pre_s, dec_s, dec_tok, wall = serve_timed(
        engine, reqs, slots, control=ctrl)
    peak = torch.cuda.max_memory_allocated()
    for r in reqs:
        if r.finish_reason != "length" or \
                len(r.tokens) != r.max_new_tokens:
            raise AssertionError(f"runtime request {r.rid}: {len(r.tokens)} "
                                 f"of {r.max_new_tokens} tokens "
                                 f"({r.finish_reason!r})")
    rt = res.runtime
    st = rt.stats
    log(f"  served {len(reqs)} requests, {res.generated_tokens} tokens in "
        f"{res.iterations} decode steps + {res.prefills} prefills (the "
        f"wall time includes the session start: int8 quantization of the "
        f"bank and the bootstrap load)")
    log(f"  launches in this run: {launches}")
    for k_name in ("fused_gate_up_quant", "gmm_quant", "decode_attention"):
        if launches[k_name] <= 0:
            raise AssertionError(f"{k_name} was never launched on the "
                                 "runtime path")
    for k_name in ("fused_gate_up", "gmm"):
        if launches[k_name] != 0:
            raise AssertionError(f"{k_name} launched {launches[k_name]} "
                                 "times: a MoE layer bypassed the slot plane")
    by_path = {k: dict(v) for k, v in MG.QUANT_PATH_LAUNCHES.items()}
    log(f"  int8 launches by path in this run: {by_path}")
    for k_name, paths in by_path.items():
        if paths["wgmma"] != launches[k_name] or paths["simt"] != 0:
            raise AssertionError(f"{k_name}: {paths} launches by path; every "
                                 "one of the bf16 run should take wgmma")
    row = param_bytes(cfg)
    if st.bytes_moved != st.transfers * row or \
            st.rank_bytes != {"rank0": st.bytes_moved}:
        raise AssertionError(f"runtime bytes {st.bytes_moved} != "
                             f"{st.transfers} transfers x {row} B, or rank "
                             f"bytes {st.rank_bytes}")
    bank_bytes = sum(t.numel() * t.element_size()
                     for j in rt.moe_positions
                     for bank in (rt.banks[j], rt.padded[j])
                     for t in bank.values())
    log(f"  runtime: cold/warm/prewarmed {st.counts()}, {st.transfers} "
        f"transfers, {st.bytes_moved:.0f} B moved ({row:.0f} B a copy), "
        f"rank bytes {st.rank_bytes}, evictions {st.evictions}, overlap "
        f"{st.overlap_eligible_copies} eligible / {st.exposed_copies} "
        f"exposed; by phase {st.by_phase}")
    log(f"  slot banks: {rt.phys_slots} slots a layer, single-buffered; "
        f"slot bank + padded quantized bank {bank_bytes / 1e9:.2f} GB over "
        f"{rt.n_layers} layers")
    med_dec = float(np.median(dec_s)) * 1e3
    log(f"  wall times on {card}:")
    for bucket in sorted(pre_s):
        log(f"    prefill bucket {bucket}: median "
            f"{np.median(pre_s[bucket]) * 1e3:.2f} ms over "
            f"{len(pre_s[bucket])}")
    log(f"    decode step: median {med_dec:.2f} ms over {len(dec_s)} "
        f"steps; {dec_tok / sum(dec_s):.1f} decode tokens/s")
    log(f"    whole run: {wall:.2f} s, {res.generated_tokens / wall:.1f} "
        f"tokens/s; max_memory_allocated {peak / 1e9:.2f} GB")
    del engine
    # every layer's EP MoE sublayer, kernels vs plain, on the runtime's
    # final tables and banks: the longest prompt's prefill, then one
    # batched decode step over `slots` prefilled prompts
    ep = (rt.ctx, rt.ep_state())
    dev = params["embed"].device
    ref_cfg = cfg.with_(impl="ref")
    prompts = [r.prompt for r in reqs]
    with torch.no_grad():
        longest = max(prompts, key=len)
        toks = torch.from_numpy(longest[None].astype(np.int64)).to(dev)
        sublayer_check(f"EP prefill of {len(longest)} tokens", cfg, params,
                       toks, T.init_cache(cfg, params, 1, max_len), 0, None,
                       ep=ep)
        lens = [min(len(p), 128 + 16 * i) for i, p in
                enumerate(prompts[:slots])]
        plen = max(lens)
        batch_toks = torch.from_numpy(np.stack(
            [np.pad(p[:n], (0, plen - n)) for p, n in
             zip(prompts[:slots], lens)]).astype(np.int64)).to(dev)
        pool = T.init_cache(ref_cfg, params, slots, max_len)
        lg, _, _ = T.decode_step(ref_cfg, params, {"tokens": batch_toks},
                                 pool, 0)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        nxt = lg[torch.arange(slots, device=dev), lengths - 1] \
            .argmax(-1)[:, None]
        active = torch.ones((slots, 1), dtype=torch.bool, device=dev)
        sublayer_check("EP batched decode step", cfg, params, nxt, pool,
                       lengths, active, ep=ep)
    del params, rt, res, ep, pool, lg
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 5


def capacity_identity(small, sp) -> None:
    """Float32 smoke config at its own capacity factor, where the MoE
    dispatch drops tokens: greedy tokens through the kernels on the
    contiguous cache equal the plain path's, request by request."""
    from repro_torch.serving.engine import MoElessController, ServingEngine
    sreqs = {}
    for impl in ("auto", "ref"):
        eng = ServingEngine(small, sp, max_len=64 + 24 + 1, impl=impl,
                            controller=MoElessController(small))
        rs = make_requests(small, (64, 17, 40, 9, 33), (24, 7, 16), 10)
        eng.serve(rs, num_slots=4)
        sreqs[impl] = {r.rid: list(r.tokens) for r in rs}
    if sreqs["auto"] != sreqs["ref"]:
        bad = [i for i in sreqs["ref"] if sreqs["auto"][i] != sreqs["ref"][i]]
        raise AssertionError(f"float32 tokens differ for requests {bad}")
    log(f"  capacity factor {small.moe.capacity_factor}: "
        f"{len(sreqs['ref'])} requests, "
        f"{sum(map(len, sreqs['ref'].values()))} tokens: contiguous "
        "impl=auto == impl=ref")


def token_identity(small, sp) -> None:
    """Float32 smoke config at a drop-free capacity factor: greedy tokens
    through the kernels on the contiguous cache, the paged pool (solo),
    chunked prefill and a prefix-warm pool equal the plain path's on the
    contiguous cache, request by request; and so do the tokens of a
    trace where half the requests sample (temperature 0.9, top-p 0.9,
    seeded), which differ from that trace's greedy tokens."""
    from repro_torch.configs import ServingSpec
    from repro_torch.serving.engine import MoElessController, ServingEngine
    max_len = 64 + 24 + 1
    runs = [("contiguous", "ref", ServingSpec()),
            ("contiguous", "auto", ServingSpec()),
            ("paged solo", "auto", ServingSpec(kv="paged", kv_block=5)),
            ("paged chunked", "auto", ServingSpec(kv="paged", kv_block=5,
                                                  prefill_chunk=7)),
            ("paged chunked prefix-warm", "auto",
             ServingSpec(kv="paged", kv_block=4, prefill_chunk=8,
                         prefix_cache=True))]
    greedy = None
    for trace in ("random prompts", "shared system prompt, two waves",
                  "random prompts, half sampled"):
        got = {}
        for label, impl, spec in runs:
            eng = ServingEngine(small, sp, max_len=max_len, impl=impl,
                                controller=MoElessController(small),
                                serving=spec)
            if trace.startswith("random prompts"):
                waves = [make_requests(small, (64, 17, 40, 9, 33),
                                       (24, 7, 16), 10,
                                       sampled=trace.endswith("sampled"))]
            else:
                waves = shared_prefix_waves(small, 21, [[9, 30, 3, 17, 40],
                                                        [0, 5, 22, 11, 36]],
                                            (24, 7, 16))
            eng.start(num_slots=4)
            for wave in waves:
                for r in wave:
                    eng.submit(r)
                eng.run()
            kv = eng._session.kv
            eng.close()
            got[(label, impl)] = {r.rid: list(r.tokens)
                                  for w in waves for r in w}
            extra = ""
            if getattr(kv, "prefix", None) is not None:
                extra = (f" (prefix hits {kv.prefix.hits}, copy-on-write "
                         f"{kv.cow_blocks})")
                if trace.startswith("shared") and (kv.prefix.hits < 5
                                                   or kv.cow_blocks < 1):
                    raise AssertionError("prefix-warm run had no warm hits")
            base = got[("contiguous", "ref")]
            if got[(label, impl)] != base:
                bad = [i for i in base if got[(label, impl)][i] != base[i]]
                raise AssertionError(f"{trace}: {label} impl={impl} tokens "
                                     f"differ for requests {bad}")
            log(f"  {trace}: {label} impl={impl}: "
                f"{sum(map(len, base.values()))} tokens == contiguous "
                f"impl=ref{extra}")
        if trace == "random prompts":
            greedy = got[("contiguous", "ref")]
        elif trace.endswith("sampled"):
            base = got[("contiguous", "ref")]
            if any(base[i] == greedy[i] for i in base if i % 2) or \
                    any(base[i] != greedy[i] for i in base if i % 2 == 0):
                raise AssertionError("sampled requests gave their greedy "
                                     "tokens, or greedy ones did not")


def sampled_batching(small, sp) -> None:
    """Float32 smoke config at a drop-free capacity factor, through the
    kernels: a trace where half the requests sample gives, served in
    one batch, the tokens of serving each request alone (keys fold per
    request, not per slot), contiguous and paged with chunked prefill."""
    from repro_torch.configs import ServingSpec
    from repro_torch.serving.engine import ServingEngine
    for label, spec in (("contiguous", ServingSpec()),
                        ("paged chunked", ServingSpec(kv="paged",
                                                      kv_block=5,
                                                      prefill_chunk=7))):
        eng = ServingEngine(small, sp, max_len=64 + 24 + 1, serving=spec)
        alone = make_requests(small, (64, 17, 40, 9, 33), (24, 7, 16), 10,
                              sampled=True)
        for r in alone:
            eng.serve([r], num_slots=4)
        batch = make_requests(small, (64, 17, 40, 9, 33), (24, 7, 16), 10,
                              sampled=True)
        res = eng.serve(batch, num_slots=4)
        if [r.tokens for r in batch] != [r.tokens for r in alone] or \
                res.mean_batch_occupancy <= 1.0:
            bad = [r.rid for r, q in zip(batch, alone) if r.tokens != q.tokens]
            raise AssertionError(f"{label}: sampled batched tokens differ "
                                 f"from sequential for requests {bad}")
        log(f"  half sampled, {label} impl=auto: batched (occupancy "
            f"{res.mean_batch_occupancy:.2f}) == one request at a time "
            f"({sum(len(r.tokens) for r in batch)} tokens)")


def runtime_identity(small, sp) -> None:
    """Float32 smoke config with the expert runtime on (a session MoEless
    controller): greedy tokens through the kernels equal the plain
    path's with float32 and with int8 slot banks, at the config's own
    capacity factor, and a single-buffered slot bank (phase 4c's) gives
    the double-buffered one's tokens and runtime meters; at the drop-free
    factor the runtime's tokens equal the runtime-off engine's (capacity
    dispatch, same session controller)."""
    from repro_torch.serving.engine import MoElessController, ServingEngine
    max_len = 64 + 24 + 1

    def serve(cfg, impl, runtime, double_buffer=True):
        eng = ServingEngine(cfg, sp, max_len=max_len, impl=impl,
                            expert_runtime=runtime,
                            runtime_double_buffer=double_buffer)
        rs = make_requests(cfg, (64, 17, 40, 9, 33), (24, 7, 16), 10)
        K.reset_launch_counts()
        res = eng.serve(rs, num_slots=4, control=MoElessController(cfg))
        return {r.rid: list(r.tokens) for r in rs}, res, K.launch_counts()

    for sd in ("fp32", "int8"):
        cfg = small.with_(moe=dataclasses.replace(small.moe, slot_dtype=sd))
        got = {impl: serve(cfg, impl, "on") for impl in ("auto", "ref")}
        quant = got["auto"][2]["fused_gate_up_quant"]
        plain = got["auto"][2]["fused_gate_up"]
        if (quant > 0) != (sd == "int8") or (plain > 0) != (sd == "fp32"):
            raise AssertionError(f"{sd} banks launched {got['auto'][2]}")
        if got["auto"][0] != got["ref"][0]:
            bad = [i for i in got["ref"][0]
                   if got["auto"][0][i] != got["ref"][0][i]]
            raise AssertionError(f"runtime on, {sd} banks: tokens differ for "
                                 f"requests {bad}")
        st = got["auto"][1].runtime.stats
        one = serve(cfg, "auto", "on", double_buffer=False)
        if one[0] != got["auto"][0] or \
                dataclasses.asdict(one[1].runtime.stats) != \
                dataclasses.asdict(st):
            raise AssertionError(f"runtime on, {sd} banks: the single-"
                                 "buffered bank's tokens or meters differ "
                                 "from the double-buffered one's")
        n_tok = sum(map(len, got["ref"][0].values()))
        log(f"  runtime on, {sd} banks, capacity factor "
            f"{cfg.moe.capacity_factor}: {n_tok} tokens impl=auto == "
            f"impl=ref == single-buffered bank (runtime c/w/p "
            f"{st.counts()}, {st.transfers} transfers, "
            f"{st.bytes_moved:.0f} B)")
    free = small.with_(moe=dataclasses.replace(
        small.moe, capacity_factor=float(small.moe.num_experts)))
    on, off = serve(free, "auto", "on")[0], serve(free, "auto", "off")[0]
    if on != off:
        bad = [i for i in off if on[i] != off[i]]
        raise AssertionError(f"drop-free: runtime on tokens differ from off "
                             f"for requests {bad}")
    log(f"  drop-free capacity factor: runtime on == runtime off "
        f"({sum(map(len, off.values()))} tokens)")


# ------------------------------------------------------------ main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    # float32 products in full float32 (TF32 off), stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import MoElessController, ServingEngine

    log("[1] card")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(card)
    log(f"  torch: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); TF32 matmul/cudnn: off")

    log("[2] build")
    fresh = [n for n in KB.SOURCES if not KB.library_path(n).is_file()]
    t0 = time.perf_counter()
    KB.build()
    log(f"  built {', '.join(fresh) or 'nothing'} from kernels/csrc "
        f"(one nvcc each, in parallel) in {time.perf_counter() - t0:.1f} s; "
        f"libraries in {KB.BUILD_DIR.relative_to(ROOT)}")

    log("[3] kernels against their plain versions")
    full = get_config("mixtral-8x7b")
    slots, max_len = 8, 512 + 48 + 1
    shapes = main_path_shapes(full, slots, 512, max_len)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = check_gmm_kernels(gen, shapes)
    rec.update(check_decode_attention(gen, shapes["decode_attention"]))
    rec.update(check_decode_attention_paged(
        gen, shapes["decode_attention_paged"]))
    rec.update(check_quant_kernels(gen, shapes))

    log("[4] mixtral-8x7b at full width through ServingEngine")
    cfg = full.with_(num_layers=8)
    log(f"  reduced: num_layers {full.num_layers}->{cfg.num_layers}")
    log(f"  widths: d_model {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} kv, head_dim {cfg.resolved_head_dim}, "
        f"{cfg.moe.num_experts} experts x d_ff {cfg.moe.d_ff}, top-"
        f"{cfg.moe.top_k}, vocab {cfg.vocab_size}, {cfg.dtype}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    log(f"  params: {n_par / 1e9:.2f} B, {n_par * 2 / 1e9:.1f} GB, made on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    ctrl = MoElessController(cfg, num_devices=8)
    engine = ServingEngine(cfg, params, max_len=max_len, controller=ctrl)
    reqs = make_requests(cfg, (128, 256, 384, 512), (16, 32, 48), 12)
    torch.cuda.reset_peak_memory_stats()
    res, launches, pre_s, dec_s, dec_tok, wall = serve_timed(
        engine, reqs, slots)
    peak = torch.cuda.max_memory_allocated()
    for r in reqs:
        if r.finish_reason != "length" or \
                len(r.tokens) != r.max_new_tokens:
            raise AssertionError(f"request {r.rid}: {len(r.tokens)} of "
                                 f"{r.max_new_tokens} tokens "
                                 f"({r.finish_reason!r})")
    log(f"  served {len(reqs)} requests, {res.generated_tokens} tokens in "
        f"{res.iterations} decode steps + {res.prefills} prefills "
        f"(mean occupancy {res.mean_batch_occupancy:.2f})")
    log(f"  launches in this run: {launches}")
    for k_name in ("fused_gate_up", "gmm", "decode_attention"):
        if launches[k_name] <= 0:
            raise AssertionError(f"{k_name} was never launched on the main "
                                 "path")
    n_moe = cfg.num_layers // cfg.moe.every_n_layers
    if len(ctrl.plans) != n_moe or len(ctrl.last_plans) != n_moe:
        raise AssertionError(f"controller planned {len(ctrl.plans)} of "
                             f"{n_moe} MoE layers")
    log(f"  controller: {ctrl.iterations} iterations, a plan for each of "
        f"{n_moe} MoE layers (replicas/layer "
        f"{[p.total_replicas for p in ctrl.plans]})")
    logits_check(cfg, params, [r.prompt for r in reqs], max_len, slots)
    med_dec = float(np.median(dec_s)) * 1e3
    log(f"  wall times on {card}:")
    for bucket in sorted(pre_s):
        log(f"    prefill bucket {bucket}: median "
            f"{np.median(pre_s[bucket]) * 1e3:.2f} ms over "
            f"{len(pre_s[bucket])}")
    log(f"    decode step: median {med_dec:.2f} ms over {len(dec_s)} "
        f"steps; {dec_tok / sum(dec_s):.1f} decode tokens/s")
    log(f"    whole run: {wall:.2f} s, {res.generated_tokens / wall:.1f} "
        f"tokens/s; max_memory_allocated {peak / 1e9:.2f} GB")
    del engine, ctrl
    torch.cuda.empty_cache()

    log("[4b] paged KV, chunked prefill and the prefix cache at full width "
        "(same weights)")
    paged = paged_phase(cfg, params, max_len, slots, card)

    log("[6] the OpenAI-compatible gateway at full width (phase 4's "
        "weights; run before 4c, whose slot banks cannot sit beside them)")
    gateway_phase(cfg, params, card)
    del params
    # the phase's replicas, drivers and timing wrappers reference one
    # another (and the weights): collect the cycles before 4c allocates
    gc.collect()
    torch.cuda.empty_cache()

    log("[4c] the expert runtime on the EP slot plane at full width, int8 "
        "slot banks")
    ep_launches = runtime_phase(full, max_len, slots, card)

    log("[5] token identity at float32 (smoke config): kernels vs plain")
    small = get_config("mixtral-8x7b", smoke=True).with_(dtype="float32")
    sp = init_params(small, seed=0, device="cuda")
    capacity_identity(small, sp)
    log("  drop-free capacity factor: contiguous and paged layouts")
    free = small.with_(moe=dataclasses.replace(
        small.moe, capacity_factor=float(small.moe.num_experts)))
    token_identity(free, sp)
    sampled_batching(free, sp)
    log("  expert runtime on (EP slot plane): float32 and int8 slot banks")
    runtime_identity(small, sp)

    # each kernel's launches come from the run of the path it serves
    launches["decode_attention_paged"] = \
        paged["launches"]["decode_attention_paged"]
    for k_name in ("fused_gate_up_quant", "gmm_quant"):
        launches[k_name] = ep_launches[k_name]
    line = {"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n][0],
         "replaces": SOURCES[n][1], "launches": launches[n], **rec[n]}
        for n in SOURCES]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
