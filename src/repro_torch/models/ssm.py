"""Recurrent sequence mixers: Mamba (selective SSM, arXiv:2312.00752 as used
by Jamba arXiv:2403.19887) and xLSTM's sLSTM / mLSTM blocks
(arXiv:2405.04517), in plain torch as the reference has them in plain jnp.

Each mixer exposes:
  init_*                -> params
  *_seq(p, x, state)    -> (y, final_state)    # prefill over (B, S, D)
  *_step(p, x, state)   -> (y, new_state)      # single-token decode
  init_*_state          -> the zero state

``*_seq`` starts from `state` when one is given (a prompt prefilled into
a cache that already holds a recurrent state) and from the zero state
otherwise, which is the reference's ``*_seq``. The recurrent states stay
float32 in a bfloat16 model, as do ``a_log``, ``d_skip``, ``b_i``,
``b_f`` and the sLSTM ``bias``.

The reference's Mamba levers (``MAMBA_OPTS``, ``set_mamba_opts``) are
ported as they are: ``fused_y`` (the output contraction inside the chunk
body, so the (B, T, di, N) states are never stored), ``chunk_remat``
(the chunk body recomputed in backward, ``torch.utils.checkpoint``) and
``inline_ab`` (``_inline_chunk_scan``: abar and bbar built inside the
chunk body from the N-times smaller dt, b, c and xc). All are off by
default, which is the path of the serving and training code; they
change the float order, not the function.

Every loop over time (the Mamba chunks, the x-LSTM tokens) runs through
``_time_loop``, the port's ``lax.scan``: one place where a counter can
cut the loops short (``launch.dryrun``).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as C

# the reference's levers (its ssm.py: MAMBA_OPTS), all off by default
MAMBA_OPTS = {"fused_y": False, "chunk_remat": False, "inline_ab": False}


def set_mamba_opts(**kw) -> None:
    unknown = set(kw) - set(MAMBA_OPTS)
    if unknown:
        raise ValueError(f"unknown Mamba options {sorted(unknown)}; known: "
                         f"{sorted(MAMBA_OPTS)}")
    MAMBA_OPTS.update(kw)


def _time_loop(step, n: int, carry):
    """(carry, [y_0, ..., y_{n-1}]) of ``carry, y_i = step(i, carry)``
    for i in range(n)."""
    ys = []
    for i in range(n):
        carry, y = step(i, carry)
        ys.append(y)
    return carry, ys


def _lead(batch) -> tuple:
    return (batch,) if isinstance(batch, int) else tuple(batch)


def _normal(gen, shape, dtype, device, scale):
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(scale)


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); F.softplus turns linear above
    # x = 20, a difference below 2e-9 there
    return torch.logaddexp(x, torch.zeros_like(x))


# ================================================================ Mamba


def init_mamba(gen, d: int, spec, dtype, device, lead=()):
    """Mamba parameters with the reference's shapes, dtypes and scales,
    each leaf with the leading shape `lead` (e.g. the layer periods)."""
    lead = _lead(lead)
    di = spec.expand * d
    dt_rank = max(1, math.ceil(d / 16))
    a = torch.arange(1, spec.d_state + 1, dtype=torch.float32,
                     device=device)[None].expand(di, spec.d_state)
    return {
        "in_proj": _normal(gen, (*lead, d, 2 * di), dtype, device,
                           1.0 / math.sqrt(d)),
        "conv_w": _normal(gen, (*lead, spec.d_conv, di), dtype, device, 0.1),
        "conv_b": torch.zeros((*lead, di), dtype=dtype, device=device),
        "x_proj": _normal(gen, (*lead, di, dt_rank + 2 * spec.d_state),
                          dtype, device, 1.0 / math.sqrt(di)),
        "dt_proj": _normal(gen, (*lead, dt_rank, di), dtype, device,
                           1.0 / math.sqrt(dt_rank)),
        # softplus^-1 of the U(1e-3, 1e-1) midpoint, in float32
        "dt_bias": torch.log(torch.expm1(torch.full(
            (*lead, di), 0.01, dtype=torch.float32, device=device))).to(dtype),
        "a_log": torch.log(a).expand(*lead, di, spec.d_state).contiguous(),
        "d_skip": torch.ones((*lead, di), dtype=torch.float32,
                             device=device),
        "out_proj": _normal(gen, (*lead, di, d), dtype, device,
                            1.0 / math.sqrt(di)),
    }


def _mamba_ssm_params(p, xc, spec):
    """xc: (..., di) conv output -> (dt, b, c) input-dependent SSM
    params, float32."""
    dt_rank = p["dt_proj"].shape[0]
    proj = xc @ p["x_proj"]
    dt = _softplus(proj[..., :dt_rank] @ p["dt_proj"]
                   + p["dt_bias"]).float()
    b = proj[..., dt_rank:dt_rank + spec.d_state].float()
    c = proj[..., dt_rank + spec.d_state:].float()
    return dt, b, c


def _combine(x, y):
    (ax, bx), (ay, by) = x, y
    return ax * ay, bx * ay + by


def _interleave(even, odd):
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a, b):
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t over axis 1, combining
    in ``jax.lax.associative_scan``'s order: adjacent pairs first, the
    odd prefixes recursively, then the even ones from them."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                         (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _chunk(t: int, chunk: int) -> int:
    """min(chunk, t) shrunk to a divisor of t, as the reference's."""
    chunk = min(chunk, t)
    while t % chunk:
        chunk -= 1
    return chunk


def _scan_linear_recurrence(a, b, h0, chunk: int = 128, c_proj=None):
    """h_t = a_t * h_{t-1} + b_t over axis 1 (time). a/b: (B, T, di, N),
    h0: (B, di, N). Chunked as the reference: the associative scan
    within a chunk of ``_chunk(T, chunk)``, a loop across chunks. Returns
    (hs (B, T, di, N), h_T); with `c_proj` (B, T, N) and ``fused_y`` on,
    (y = einsum(hs, c) (B, T, di), h_T), the states never stored. Under
    ``chunk_remat`` the chunk body is recomputed in backward."""
    t = a.shape[1]
    chunk = _chunk(t, chunk)
    fused = MAMBA_OPTS["fused_y"] and c_proj is not None

    def outer(h, ac, bc, cc):
        aa, bb = _associative_scan(ac, bc)
        hc = aa * h[:, None] + bb
        if fused:
            return hc[:, -1], torch.einsum("bsdn,bsn->bsd", hc, cc)
        return hc[:, -1], hc

    if MAMBA_OPTS["chunk_remat"]:
        outer = functools.partial(C.checkpoint, outer, use_reentrant=False)

    def step(i, h):
        s = i * chunk
        return outer(h, a[:, s:s + chunk], b[:, s:s + chunk],
                     c_proj[:, s:s + chunk] if fused else None)

    h, ys = _time_loop(step, t // chunk, h0)
    return torch.cat(ys, dim=1), h


def _inline_chunk_scan(a, dt, b, c, xc, h0, chunk: int = 128):
    """Selective scan with abar/bbar built INSIDE the chunk body (the
    reference's lever ``inline_ab``): the loop's inputs are dt (B, T,
    di), b/c (B, T, N) and xc (B, T, di), N times smaller than the
    (B, T, di, N) tensors; the chunk body is recomputed in backward.
    Returns (y (B, T, di), h_T)."""
    t = dt.shape[1]
    chunk = _chunk(t, chunk)

    def outer(h, dtc, bc, cc, xcc):
        abar = torch.exp(dtc[..., None] * a)            # (B, chunk, di, N)
        bbar = dtc[..., None] * bc[..., None, :] * xcc[..., None]
        aa, bb = _associative_scan(abar, bbar)
        hc = aa * h[:, None] + bb
        return hc[:, -1], torch.einsum("bsdn,bsn->bsd", hc, cc)

    def step(i, h):
        sl = slice(i * chunk, (i + 1) * chunk)
        return C.checkpoint(outer, h, dt[:, sl], b[:, sl], c[:, sl],
                            xc[:, sl], use_reentrant=False)

    h, ys = _time_loop(step, t // chunk, h0)
    return torch.cat(ys, dim=1), h


def mamba_seq(p, x, spec, state=None):
    """x: (B, S, D) -> (y, state) with state = {conv (B, dc-1, di) in x's
    dtype, ssm (B, di, N) float32}, starting from `state` (zero when
    None)."""
    bsz, s, _ = x.shape
    di = p["in_proj"].shape[1] // 2
    xz = x @ p["in_proj"]
    xin, z = xz[..., :di], xz[..., di:]
    # causal depthwise conv over time, shifted products summed left to
    # right; the window before the first token is the state's
    dc = p["conv_w"].shape[0]
    if state is None:
        state = init_mamba_state(p, spec, bsz)
    xpad = torch.cat([state["conv"].to(xin.dtype), xin], dim=1)
    xc = sum(xpad[:, i:i + s] * p["conv_w"][i] for i in range(dc))
    xc = F.silu(xc + p["conv_b"])

    dt, b, c = _mamba_ssm_params(p, xc, spec)
    a = -torch.exp(p["a_log"])                            # (di, N)
    xf = xc.float()
    if MAMBA_OPTS["inline_ab"]:
        y, h_t = _inline_chunk_scan(a, dt, b, c, xf, state["ssm"])
    else:
        abar = torch.exp(dt[..., None] * a)
        bbar = dt[..., None] * b[..., None, :] * xf[..., None]
        if MAMBA_OPTS["fused_y"]:
            y, h_t = _scan_linear_recurrence(abar, bbar, state["ssm"],
                                             c_proj=c)
        else:
            hs, h_t = _scan_linear_recurrence(abar, bbar, state["ssm"])
            y = torch.einsum("bsdn,bsn->bsd", hs, c)
    y = y + xf * p["d_skip"]
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return y, {"conv": xpad[:, xpad.shape[1] - (dc - 1):].to(x.dtype),
               "ssm": h_t}


def mamba_step(p, x, state, spec):
    """x: (B, 1, D) single decode token."""
    di = p["in_proj"].shape[1] // 2
    xz = x[:, 0] @ p["in_proj"]
    xin, z = xz[..., :di], xz[..., di:]
    window = torch.cat([state["conv"].to(xin.dtype), xin[:, None]], dim=1)
    xc = F.silu(torch.einsum("bcd,cd->bd", window, p["conv_w"])
                + p["conv_b"])
    dt, b, c = _mamba_ssm_params(p, xc, spec)
    a = -torch.exp(p["a_log"])
    xf = xc.float()
    abar = torch.exp(dt[..., None] * a)                   # (B, di, N)
    bbar = dt[..., None] * b[..., None, :] * xf[..., None]
    h = abar * state["ssm"] + bbar
    y = torch.einsum("bdn,bn->bd", h, c) + xf * p["d_skip"]
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return y[:, None], {"conv": window[:, 1:], "ssm": h}


def init_mamba_state(p, spec, batch):
    """Zero state; `batch` is an int or a leading shape (periods,
    batch)."""
    di = p["in_proj"].shape[-1] // 2
    dc = p["conv_w"].shape[-2]
    dev = p["in_proj"].device
    lead = _lead(batch)
    return {"conv": torch.zeros((*lead, dc - 1, di),
                                dtype=p["in_proj"].dtype, device=dev),
            "ssm": torch.zeros((*lead, di, spec.d_state),
                               dtype=torch.float32, device=dev)}


# ================================================================ mLSTM


def init_mlstm(gen, d: int, num_heads: int, expand: int, dtype, device,
               lead=()):
    lead = _lead(lead)
    di = expand * d
    sd, sdi = 1.0 / math.sqrt(d), 1.0 / math.sqrt(di)
    return {
        "up_proj": _normal(gen, (*lead, d, 2 * di), dtype, device, sd),
        "wq": _normal(gen, (*lead, di, di), dtype, device, sdi),
        "wk": _normal(gen, (*lead, di, di), dtype, device, sdi),
        "wv": _normal(gen, (*lead, di, di), dtype, device, sdi),
        "w_if": _normal(gen, (*lead, di, 2 * num_heads), dtype, device, sdi),
        "b_i": torch.full((*lead, num_heads), -3.0, dtype=torch.float32,
                          device=device),
        "b_f": torch.full((*lead, num_heads), 3.0, dtype=torch.float32,
                          device=device),
        "down_proj": _normal(gen, (*lead, di, d), dtype, device, sdi),
    }


def _mlstm_gates(p, xi, num_heads: int):
    g = (xi @ p["w_if"]).float()
    log_i = g[..., :num_heads] + p["b_i"]            # pre-activation i
    log_f = F.logsigmoid(g[..., num_heads:] + p["b_f"])
    return log_i, log_f


def _mlstm_recurrence(q, k, v, log_i, log_f, state):
    """Stabilized mLSTM recurrence over one step.
    q,k,v: (B,H,hd); gates: (B,H); state = (C (B,H,hd,hd), n (B,H,hd),
    m (B,H))."""
    c, n, m = state
    m_new = torch.maximum(log_f + m, log_i)
    i_ = torch.exp(log_i - m_new)
    f_ = torch.exp(log_f + m - m_new)
    c = f_[..., None, None] * c + i_[..., None, None] * \
        (k[..., :, None] * v[..., None, :])
    n = f_[..., None] * n + i_[..., None] * k
    num = torch.einsum("bhij,bhi->bhj", c, q)
    den = torch.maximum(torch.einsum("bhi,bhi->bh", n, q).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], (c, n, m_new)


def _mlstm_qkv(p, xi, num_heads: int):
    di = xi.shape[-1]
    hd = di // num_heads
    shp = tuple(xi.shape[:-1]) + (num_heads, hd)
    q = (xi @ p["wq"]).reshape(shp).float() / math.sqrt(hd)
    k = (xi @ p["wk"]).reshape(shp).float() / math.sqrt(hd)
    v = (xi @ p["wv"]).reshape(shp).float()
    return q, k, v


def mlstm_seq(p, x, num_heads: int, state=None):
    """x: (B, S, D) -> (y, (C, n, m)), one recurrence step a token from
    `state` (zero, m = -1e30, when None)."""
    bsz, s, _ = x.shape
    di = p["up_proj"].shape[1] // 2
    u = x @ p["up_proj"]
    xi, z = u[..., :di], u[..., di:]
    q, k, v = _mlstm_qkv(p, xi, num_heads)
    log_i, log_f = _mlstm_gates(p, xi, num_heads)
    st = state if state is not None else \
        _mlstm_zero(bsz, num_heads, di // num_heads, x.device)

    def step(t, st):
        h, st = _mlstm_recurrence(q[:, t], k[:, t], v[:, t], log_i[:, t],
                                  log_f[:, t], st)
        return st, h

    st, hs = _time_loop(step, s, st)
    h = torch.stack(hs, dim=1).reshape(bsz, s, di).to(x.dtype)
    return (h * F.silu(z)) @ p["down_proj"], st


def mlstm_step(p, x, state, num_heads: int):
    di = p["up_proj"].shape[1] // 2
    u = x[:, 0] @ p["up_proj"]
    xi, z = u[..., :di], u[..., di:]
    q, k, v = _mlstm_qkv(p, xi, num_heads)
    log_i, log_f = _mlstm_gates(p, xi, num_heads)
    h, state = _mlstm_recurrence(q, k, v, log_i, log_f, state)
    h = h.reshape(x.shape[0], di).to(x.dtype)
    return ((h * F.silu(z)) @ p["down_proj"])[:, None], state


def _mlstm_zero(lead, h: int, hd: int, device):
    lead = _lead(lead)
    f32 = torch.float32
    return (torch.zeros((*lead, h, hd, hd), dtype=f32, device=device),
            torch.zeros((*lead, h, hd), dtype=f32, device=device),
            torch.full((*lead, h), -1e30, dtype=f32, device=device))


def init_mlstm_state(cfg, batch, expand: int, device):
    """Zero (C, n, m) state; `batch` is an int or a leading shape."""
    di = expand * cfg.d_model
    return _mlstm_zero(batch, cfg.num_heads, di // cfg.num_heads, device)


# ================================================================ sLSTM


def init_slstm(gen, d: int, num_heads: int, dtype, device, lead=()):
    lead = _lead(lead)
    sd = 1.0 / math.sqrt(d)
    hd = d // num_heads
    return {
        "w_in": _normal(gen, (*lead, d, 4 * d), dtype, device, sd),  # z,i,f,o
        "r": _normal(gen, (*lead, num_heads, hd, 4 * hd), dtype, device,
                     1.0 / math.sqrt(hd)),
        "bias": torch.zeros((*lead, 4 * d), dtype=torch.float32,
                            device=device),
        "w_ff": _normal(gen, (*lead, d, 2 * d), dtype, device, sd),
        "w_ff_out": _normal(gen, (*lead, d, d), dtype, device,
                            1.0 / math.sqrt(d)),
    }


def _slstm_cell(p, xt, state, num_heads: int):
    """One sLSTM step with exponential gating + stabilizer (xLSTM eq. 8-16).
    xt: (B, D); state = (c, n, m, h) each (B, D) (m: (B, H))."""
    c, n, m, h = state
    bsz, d = xt.shape
    hd = d // num_heads
    hh = h.reshape(bsz, num_heads, hd)
    # float32 state times the recurrent weight promotes to float32
    rec = torch.einsum("bhk,hkj->bhj", hh, p["r"].float()).reshape(bsz, 4 * d)
    pre = (xt @ p["w_in"]).float() + rec + p["bias"]
    z, gi, gf, go = torch.split(pre, d, dim=-1)
    z = torch.tanh(z)
    # per-head stabilizer over the head's scalar gates (mean-pooled)
    gi_h = gi.reshape(-1, num_heads, hd)
    gf_h = F.logsigmoid(gf).reshape(-1, num_heads, hd)
    m_new = torch.maximum(gf_h.mean(-1) + m, gi_h.mean(-1))
    i_ = torch.exp(gi_h - m_new[..., None]).reshape(gi.shape)
    f_ = torch.exp(gf_h + (m - m_new)[..., None]).reshape(gf.shape)
    c = f_ * c + i_ * z
    n = f_ * n + i_
    h_new = torch.sigmoid(go) * c / torch.clamp(n.abs(), min=1.0)
    return h_new, (c, n, m_new, h_new)


def _slstm_ffn(p, h):
    # jax.nn.gelu defaults to the tanh approximation
    d = h.shape[-1]
    ff = h @ p["w_ff"]
    return (F.gelu(ff[..., :d], approximate="tanh") * ff[..., d:]) \
        @ p["w_ff_out"]


def slstm_seq(p, x, num_heads: int, state=None):
    """x: (B, S, D) -> (y, (c, n, m, h)), one cell step a token from
    `state` (zero, m = -1e30, when None)."""
    bsz, s, d = x.shape
    st = state if state is not None else \
        init_slstm_state(d, num_heads, bsz, x.device)

    def step(t, st):
        h, st = _slstm_cell(p, x[:, t], st, num_heads)
        return st, h

    st, hs = _time_loop(step, s, st)
    return _slstm_ffn(p, torch.stack(hs, dim=1).to(x.dtype)), st


def slstm_step(p, x, state, num_heads: int):
    h, state = _slstm_cell(p, x[:, 0], state, num_heads)
    return _slstm_ffn(p, h[:, None].to(x.dtype)), state


def init_slstm_state(d: int, num_heads: int, batch, device):
    """Zero (c, n, m, h) state; `batch` is an int or a leading shape."""
    lead = _lead(batch)
    f32 = torch.float32
    return (torch.zeros((*lead, d), dtype=f32, device=device),
            torch.zeros((*lead, d), dtype=f32, device=device),
            torch.full((*lead, num_heads), -1e30, dtype=f32, device=device),
            torch.zeros((*lead, d), dtype=f32, device=device))
