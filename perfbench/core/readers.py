"""Arithmetic the metric readers share (``perfbench/metrics/*.py``)."""
from __future__ import annotations

import numpy as np

from perfbench.core import roofline as RF
from perfbench.core import stats as ST


# ------------------------------------------------------------ host clock


def ttft_ms(ctx):
    """Due to first token of every request the window measures; an
    unfinished one is missing."""
    done = [r for r in ctx.window if r.handle.finish_reason and r.times]
    return [(r.times[0] - r.due) * 1e3 for r in done], \
        len(ctx.window) - len(done)


def itl_ms(ctx):
    """Every gap between consecutive tokens of the window's requests;
    an unfinished request's missing tokens' gaps are missing."""
    gaps, missing = [], 0
    for r in ctx.window:
        t = np.asarray(r.times)
        gaps.extend(np.diff(t) * 1e3)
        if not r.handle.finish_reason:
            missing += max(0, r.req.max_new - max(len(t), 1))
    return gaps, missing


def percentile(values, missing: int, q: float):
    return ST.percentile(values, q, missing)


def summary(ctx) -> dict:
    """Medians, tails and sample counts of the window, for the run's
    earlier lines (none of them is a metric)."""
    out = {"requests": len(ctx.window),
           "steps": len(window_steps(ctx)),
           "tokens": window_tokens(ctx)}
    for name, (vals, missing) in (("ttft_ms", ttft_ms(ctx)),
                                  ("itl_ms", itl_ms(ctx))):
        out[name] = {"n": len(vals), "missing": missing, **{
            f"p{q:g}": percentile(vals, missing, q)
            for q in (50, 90, 95, 99)}}
    return out


def window_steps(ctx):
    return [s for s in ctx.steps if s.t0 >= ctx.t_open
            and s.t1 <= ctx.t_close]


# ------------------------------------------------------------ telemetry


def step_ms(ctx, phase: str):
    n = ctx.tel.get(f"steps.{phase}", 0)
    return ctx.tel[f"step_s.{phase}"] / n * 1e3 if n else None


# ------------------------------------------------------- traced stretch


def _firsts(ctx):
    """Host time of each request's first token -> its prompt lengths,
    and of each later token -> the keys its decode step attended."""
    pro, dec = {}, {}
    t_a, t_b = ctx.stretch[0].t1, ctx.stretch[-1].t1
    for r in ctx.recs:
        p = len(r.req.prompt)
        for k, t in enumerate(r.times):
            if t < t_a or t > t_b:
                continue
            if k == 0:
                pro.setdefault(t, []).append(p)
            else:
                dec.setdefault(t, []).append(p + k)
    return pro, dec


def _kept(call, layer: int) -> np.ndarray:
    """A layer's routed rows per expert, scaled to the assignments the
    layer kept where it dropped some."""
    loads = call.loads[layer].astype(np.float64)
    if call.dropped is not None and loads.sum() > 0:
        loads = loads * max(0.0, 1.0 - float(call.dropped[layer])
                            / loads.sum())
    return loads


def expert_bound_s(ctx) -> float:
    """Sum over the traced steps' MoE layers of the expert FFN's bound."""
    cfg = ctx.cfg
    fmt = "int8" if ctx.runtime and cfg.moe.slot_dtype == "int8" \
        else "bf16"
    tot = 0.0
    for st in ctx.stretch:
        for c in st.calls:
            for li in range(c.loads.shape[0]):
                b, f = RF.expert_ffn(_kept(c, li), cfg.d_model,
                                     cfg.moe.d_ff, fmt)
                tot += RF.bound_s(b, f)
    return tot


def attn_bound_s(ctx) -> float:
    cfg = ctx.cfg
    _, dec = _firsts(ctx)
    tot = 0.0
    for keys in dec.values():
        b, f = RF.decode_attn(keys, cfg.num_heads, cfg.num_kv_heads,
                              cfg.resolved_head_dim)
        tot += cfg.num_layers * RF.bound_s(b, f)
    return tot


def family_s(ctx, name: str) -> float:
    return sum(b - a for _, a, b in ctx.trace.kernels(RF.family(name))) \
        / 1e6


def roofline(ctx, name: str, bound):
    """Percent of the family's bound (`bound(ctx)`, seconds) over its
    kernels' device time; None where the stretch ran none of them."""
    if ctx.trace is None or not ctx.stretch:
        return None
    t = family_s(ctx, name)
    return 100.0 * bound(ctx) / t if t > 0 else None


def flops(ctx, phases=("prefill", "decode")) -> float:
    """Useful operations of the traced steps: every prompt token and
    generated token through every layer with its context, the experts'
    kept rows, and the head at each position whose logits were used."""
    cfg = ctx.cfg
    pro, dec = _firsts(ctx)
    tok, L = RF.token_flops(cfg), cfg.num_layers
    expert = 6.0 * cfg.d_model * cfg.moe.d_ff
    tot = 0.0
    for st in ctx.stretch:
        for i, c in enumerate(st.calls):
            ph = "prefill" if i < st.first else "decode"
            if ph in phases:
                tot += expert * sum(_kept(c, li).sum()
                                    for li in range(c.loads.shape[0]))
        if "prefill" in phases:
            for p in pro.get(st.t1, []):
                tot += L * (p * tok + RF.context_flops(cfg, p * (p + 1) / 2))
                tot += RF.head_flops(cfg)
        if "decode" in phases:
            keys = dec.get(st.t1, [])
            tot += L * (len(keys) * tok + RF.context_flops(cfg, sum(keys)))
            tot += len(keys) * RF.head_flops(cfg)
    return tot


def window_tokens(ctx) -> int:
    return sum(s.first + s.decode for s in window_steps(ctx))


def occupancy(ctx):
    dec = [s.decode for s in window_steps(ctx) if s.decode]
    return float(np.mean(dec)) if dec else None


def launches(ctx):
    if ctx.trace is None or not ctx.stretch:
        return None
    return (len(ctx.trace.kernels()) - ctx.trace.probe_kernels) \
        / len(ctx.stretch)


def mfu(ctx):
    if ctx.trace is None or not ctx.stretch:
        return None
    return 100.0 * flops(ctx) / (ctx.trace.window_s
                                 * RF.PEAK_FLOPS["bfloat16"])


def idle_share(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def copy_gb_s(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return ctx.tel["runtime_bytes"] / 1e9 / ctx.trace.window_s


def probe(ctx) -> dict:
    """The harness probe's own cost in the traced stretch, an engine
    iteration: kernels it launched, their device ms, and its host ms."""
    n = max(len(ctx.stretch), 1)
    tr = ctx.trace
    host = sum(b - a for name, a, b in tr.spans if name == "probe")
    return {"launches": tr.probe_kernels / n,
            "device_ms": tr.probe_us / 1e3 / n, "host_ms": host / 1e3 / n}
