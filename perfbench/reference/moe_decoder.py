"""Plain float32 reference of the served MoE decoders (mixtral-8x7b and
phi-3.5-moe as the port runs them), written from the published layer
equations in plain torch. It imports nothing of the program: it reads
the weights the benchmark made (the same tensors it hands the program)
and the prompts and served tokens, and recomputes every logit.

One decoder layer, pre-norm:

    x += attn(rmsnorm(x)) @ wo       RoPE (half-split), causal GQA
    x += moe(rmsnorm(x))             softmax over the top-k router
                                     logits, SwiGLU experts
    logits = rmsnorm(x) @ head       the vocabulary's first V columns

A request is recomputed as it was served: its prompt right-padded to
its prefill bucket, then every served token but the last at its
position, attending to the prompt's keys and its own. The logits of the
last prompt position and of those tokens are the ones each served token
was chosen from. Each token goes to the experts the program sent it to,
where those are given, and an assignment is dropped where the capacity
rule of its call drops it (``keep_gshard`` for the GShard dispatch,
``keep_slots`` for the EP slot plane, whose replica counts come from the
control plane's plans); the combine weights are the softmax over the
reference's own router logits of those experts.

``Precision`` makes the same computation at a lower precision: the
control that the comparison must fail.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Arch:
    """The sizes the reference needs, read from a configuration file."""
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    num_experts: int
    top_k: int
    d_ff: int
    vocab_size: int
    rope_theta: float
    norm_eps: float
    capacity_factor: float
    expert_format: str = "bf16"      # "bf16" or "int8" (slot banks)


# ------------------------------------------------------------ quant rules


def quantize_rows(w, levels: int = 127):
    """The slot banks' symmetric per-row rule: (..., R, C) -> (values,
    scales (..., R)), s = max|w[r, :]| / levels (1 for an all-zero row),
    q = round-half-even(w / s) clipped to [-levels, levels]."""
    w = w.float()
    amax = w.abs().amax(dim=-1)
    s = torch.where(amax > 0, amax / levels, torch.ones_like(amax))
    q = torch.round(w / s[..., None]).clamp_(-levels, levels)
    return q, s


def dequantize_rows(w, levels: int = 127):
    """w as its per-row quantized copy holds it, in float32."""
    q, s = quantize_rows(w, levels)
    return q * s[..., None]


def fp8_rows(x, dim: int = -1):
    """x rounded to float8 e4m3 with one scale per slice along `dim`
    (amax / 448), back in float32."""
    x = x.float()
    amax = x.abs().amax(dim=dim, keepdim=True)
    s = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / s).to(torch.float8_e4m3fn).float() * s


@dataclass(frozen=True)
class Precision:
    """How weights and activations enter every product. The default is
    float32 throughout. ``control(...)`` rounds them to the next
    precision below the configuration's: float8 e4m3 for the bfloat16
    weights and for every product's activations, and the expert banks
    one step below their stated format (int4 rows under int8 banks)."""
    lowered: bool = False
    expert_levels: int = 0          # >0: experts per-row at this many levels

    def weight(self, w):
        """A (D_in, D_out) weight as x @ w reads it (scales per column)."""
        return fp8_rows(w, dim=-2) if self.lowered else w.float()

    def act(self, x):
        return fp8_rows(x, dim=-1) if self.lowered else x

    def expert(self, w, fmt: str):
        """One expert's (R, C) leaf as the bank holds it."""
        if self.expert_levels:
            return dequantize_rows(w, self.expert_levels)
        if fmt == "int8":
            return dequantize_rows(w, 127)
        return self.weight(w) if self.lowered else w.float()


FP32 = Precision()


def control_precision(arch: Arch) -> Precision:
    """The control: float8 for bfloat16, int4 rows for int8 banks."""
    return Precision(lowered=True,
                     expert_levels=7 if arch.expert_format == "int8" else 0)


# ------------------------------------------------------------ routing


def _rank_within(keys):
    """Position of each element among the elements with its key, in
    their original order (keys: (N,) int64 >= 0)."""
    n = keys.shape[0]
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    counts = torch.bincount(sk)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(keys)
    pos[order] = torch.arange(n, device=keys.device) - starts[sk]
    return pos


def keep_gshard(top_i, num_experts: int, cf: float, groups: int):
    """GShard capacity: tokens split into `groups` equal groups (fewer if
    they do not divide), each expert holds ceil(cf * k * Tg / E)
    assignments a group, priority to k-slot 0 of every token, then
    k-slot 1, ..., each in token order. Returns keep (T, k)."""
    t, k = top_i.shape
    groups = max(1, min(groups, t))
    while t % groups:
        groups -= 1
    tg = t // groups
    cap = max(1, math.ceil(cf * k * tg / num_experts))
    g = torch.arange(t, device=top_i.device) // tg
    key = (g[:, None] * num_experts + top_i).T.reshape(-1)    # k-major
    pos = _rank_within(key.long()).reshape(k, t).T
    return pos < cap


def keep_slots(top_i, slots, cf: float, num_experts: int):
    """The EP slot plane's capacity over one batch of T tokens: token i's
    k-th assignment to expert e goes to e's replica (i + k) mod n_e,
    whose slot is slots[e, r] (slots (E, R), -1 past e's n_e replicas;
    an expert with none keeps a slot of its own); every slot holds
    ceil(cf * k * T / E) assignments, priority k-slot 0 of every token
    first, each in token order. Returns keep (T, k)."""
    t, k = top_i.shape
    dev = top_i.device
    slots = torch.as_tensor(slots, device=dev).long()
    e = slots.shape[0]
    own = (torch.arange(e, device=dev) + int(slots.max()) + 1)[:, None]
    slots = torch.where(slots.max(dim=1, keepdim=True).values < 0,
                        torch.cat([own, slots[:, 1:]], 1), slots)
    nrep = (slots >= 0).sum(dim=1).clamp(min=1)
    r = torch.remainder(torch.arange(t, device=dev)[:, None]
                        + torch.arange(k, device=dev)[None], nrep[top_i])
    slot = slots[top_i, r]
    cap = max(1, math.ceil(cf * k * t / num_experts))
    pos = _rank_within(slot.T.reshape(-1)).reshape(k, t).T
    return pos < cap


# ------------------------------------------------------------ layers


def rms_norm(x, scale, eps: float):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, pos, theta: float):
    """Half-split rotary embedding of x (S, H, hd) at positions (S,)."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = pos.float()[:, None] * inv[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attend(q, k, v, qpos, kpos, block: int = 512):
    """Causal GQA attention: q (Sq, H, hd) over k/v (Sk, KV, hd), a key
    visible where its position is at most the query's. (Sq, H*hd)."""
    sq, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty((sq, h, hd), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    for a in range(0, sq, block):
        s = torch.einsum("qhd,khd->hqk", q[a:a + block], k) * scale
        vis = kpos[None, :] <= qpos[a:a + block, None]
        s = s.masked_fill(~vis[None], float("-inf"))
        out[a:a + block] = torch.einsum("hqk,khd->qhd",
                                        torch.softmax(s, dim=-1), v)
    return out.reshape(sq, h * hd)


def moe(h, lw, arch: Arch, prec: Precision, experts, given=None,
        keep=None):
    """Sum over each token's kept assignments of weight x SwiGLU expert,
    the weights the softmax over the router logits of the experts it
    was sent to. Those experts are `given` ((T, k), with their keep
    flags `keep` (T, k)), or the reference's own top-k, kept as `keep`
    (a function of the routed experts, or None: every one). `experts`
    gives the experts' weights as the bank holds them. Returns (y, the
    router logits (T, E), the own top-k (T, k))."""
    logits = prec.act(h) @ prec.weight(lw["router"])
    own = torch.sort(logits, dim=-1, descending=True,
                     stable=True)[1][:, :arch.top_k]
    idx = own if given is None else given.long()
    if given is None:
        kept = torch.ones_like(idx, dtype=torch.bool) if keep is None \
            else keep(idx)
    else:
        kept = keep
    w = torch.softmax(logits.gather(1, idx), dim=-1)
    y = torch.zeros_like(h)
    for e in range(arch.num_experts):
        t_i, k_i = torch.nonzero((idx == e) & kept, as_tuple=True)
        if t_i.numel() == 0:
            continue
        wg, wu, wd = experts(e)
        x = prec.act(h[t_i])
        a = F.silu(x @ wg) * (x @ wu)
        y.index_add_(0, t_i, (prec.act(a) @ wd) * w[t_i, k_i, None])
    return y, logits, own


@dataclass
class Request:
    """One served request as the reference recomputes it: its prompt,
    the tokens served for it, its prefill bucket, and the program's
    routing: the experts each MoE layer sent each token to and whether
    it kept the assignment, for the prefill's bucket (`routes_a`,
    `keep_a`: (L, bucket, k)) and for each served token but the last
    (`routes_b`, `keep_b`: (L, n - 1, k))."""
    prompt: torch.Tensor
    served: torch.Tensor
    bucket: int
    routes_a: torch.Tensor
    keep_a: torch.Tensor
    routes_b: torch.Tensor
    keep_b: torch.Tensor


def served_logits(arch: Arch, weights: dict, req: Request,
                  prec: Precision = FP32) -> dict:
    """Float32 logits (n, V) of the positions each of the request's n
    served tokens was chosen at, and at every prompt and served
    position (prompt first, then the served tokens but the last) each
    MoE layer's router logits (L, N, E) and own top-k (L, N, k).
    `weights` is the benchmark's tree in the port's layout (stacked over
    layers)."""
    dev = weights["embed"].device
    p, n = int(req.prompt.shape[0]), int(req.served.shape[0])
    h_, kv_, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    toks_a = torch.zeros(req.bucket, dtype=torch.long, device=dev)
    toks_a[:p] = req.prompt.to(dev)
    toks_b = req.served[:-1].to(dev).long()
    pos_a = torch.arange(req.bucket, device=dev)
    pos_b = p + torch.arange(n - 1, device=dev)
    emb = weights["embed"]
    xa, xb = emb[toks_a].float(), emb[toks_b].float()
    lay = weights["layers"][0]
    n_layers = lay["attn"]["wq"].shape[0]
    rlog, rown = [], []
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for li in range(n_layers):
            at = {k: prec.weight(v[li]) for k, v in lay["attn"].items()}
            eps = arch.norm_eps
            ha = rms_norm(xa, lay["norm1"]["scale"][li], eps)
            hb = rms_norm(xb, lay["norm1"]["scale"][li], eps)

            def qkv(h, pos):
                h = prec.act(h)
                q = rope((h @ at["wq"]).reshape(-1, h_, hd), pos,
                         arch.rope_theta)
                k = rope((h @ at["wk"]).reshape(-1, kv_, hd), pos,
                         arch.rope_theta)
                return q, k, (h @ at["wv"]).reshape(-1, kv_, hd)
            qa, ka, va = qkv(ha, pos_a)
            qb, kb, vb = qkv(hb, pos_b)
            oa = attend(qa, ka, va, pos_a, pos_a)
            ob = attend(qb, torch.cat([ka[:p], kb]),
                        torch.cat([va[:p], vb]), pos_b,
                        torch.cat([pos_a[:p], pos_b]))
            xa = xa + prec.act(oa) @ at["wo"]
            xb = xb + prec.act(ob) @ at["wo"]
            mw = lay["moe"]
            lw = {"router": mw["router"]["w_gate"][li]}
            bank, cache = mw["experts"], {}

            def experts(e, li=li, bank=bank, cache=cache):
                if e not in cache:
                    cache[e] = tuple(
                        prec.expert(bank[k][li, e], arch.expert_format)
                        for k in ("w_gate", "w_up", "w_down"))
                return cache[e]
            ha = rms_norm(xa, lay["norm2"]["scale"][li], eps)
            hb = rms_norm(xb, lay["norm2"]["scale"][li], eps)
            ya, la, oa_ = moe(ha, lw, arch, prec, experts,
                              req.routes_a[li].to(dev),
                              req.keep_a[li].to(dev))
            yb, lb, ob_ = moe(hb, lw, arch, prec, experts,
                              req.routes_b[li].to(dev),
                              req.keep_b[li].to(dev))
            xa, xb = xa + ya, xb + yb
            rlog.append(torch.cat([la[:p], lb]))
            rown.append(torch.cat([oa_[:p], ob_]))
            del cache
        x = torch.cat([xa[p - 1:p], xb])
        x = rms_norm(x, weights["final_norm"]["scale"], arch.norm_eps)
        head = weights["head"]
        return {"logits": (prec.act(x) @ prec.weight(head))
                [:, :arch.vocab_size],
                "router_logits": torch.stack(rlog),
                "own_routes": torch.stack(rown)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def route_shortfall(router_logits, routes):
    """How far each chosen expert's logit lies below the k-th best one
    (0 where it is among the top k): (L, N, k) for logits (L, N, E) and
    chosen experts (L, N, k)."""
    k = routes.shape[-1]
    kth = torch.sort(router_logits, dim=-1, descending=True)[0][..., k - 1]
    got = router_logits.gather(-1, routes.long().to(router_logits.device))
    return (kth[..., None] - got).clamp(min=0)


def gaps(logits, served):
    """For each served token, how far its logit lies below the best one
    (0 where it is the reference's first choice). (n,) float32."""
    served = served.to(logits.device).long()
    return logits.max(dim=-1).values - logits.gather(
        1, served[:, None])[:, 0]
