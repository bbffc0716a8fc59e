"""Core layers: norms, rotary embeddings, grouped-query attention
(chunked online softmax, and decode against a contiguous ring cache or
a paged block pool), and the dense FFN.

Parameters are plain dicts of tensors. Shape conventions:
x: (B, S, D)   q/k/v: (B, S, H, hd)   cache: (B, Smax, KV, hd)
paged pool: (NB, block, KV, hd) addressed by block tables (B, nbs)

A contiguous cache may be one rank's shard of the whole cache of a
decode step sharded over a process mesh (``CacheShard``): its sequence
split over ranks, each attending its own slots and merging the results
by their softmax statistics, or its heads or head dims split, gathered
at use. A recurrent state leaf's splits (``StateShard``) are all
gathered at use (``update_at_use``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as TP

# ---------------------------------------------------------------- norms


def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * weight).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(dt)


def norm(x, p, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def init_norm(d, kind: str, dtype, device):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


# ---------------------------------------------------------------- rotary


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin (..., head_dim//2) in f32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (B, S, hd//2) -> rotated x (half-split)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def mrope_cos_sin(positions3, head_dim: int, theta: float,
                  sections=(1, 1, 2)):
    """Multimodal RoPE (Qwen2-VL, arXiv:2409.12191).

    positions3: (B, S, 3) = (temporal, height, width) position ids. The
    rotary spectrum is split among the three axes in the ratio
    `sections`; text tokens carry identical ids on all three axes, which
    makes M-RoPE equal 1-D RoPE exactly.
    """
    half = head_dim // 2
    dev = positions3.device
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=dev) / half))
    total = sum(sections)
    sec_of_freq = torch.zeros((half,), dtype=torch.long, device=dev)
    prev = acc = 0
    for i, sec in enumerate(sections):
        acc += sec
        bound = half * acc // total
        sec_of_freq[prev:bound] = i
        prev = bound
    # the per-frequency position id: (B, S, half)
    idx = sec_of_freq.expand(*positions3.shape[:2], half)
    pos = torch.gather(positions3.float(), -1, idx)
    ang = pos * freqs
    return torch.cos(ang), torch.sin(ang)


# ---------------------------------------------------------------- attention

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _repeat_kv(k, num_groups: int):
    # (B, S, KV, hd) -> (B, S, KV*G, hd)
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, num_groups, hd) \
        .reshape(b, s, kv * num_groups, hd)


def attention(q, k, v, q_positions, kv_positions, *, causal: bool = True,
              window: int = 0, kv_len=None, chunk: int = 1024,
              return_stats: bool = False):
    """Chunked online-softmax GQA attention (flash-style in plain torch,
    as the reference computes it in plain jnp).

    q: (B, Sq, H, hd), k/v: (B, Sk, KV, hd). Positions give the absolute
    token index of every slot (enables caches / ring buffers). `window`>0
    masks keys older than `q_pos - window + 1` (sliding window). `kv_len`
    (scalar or (B,)) masks unwritten cache slots. Returns the float32
    output (B, Sq, H, hd); with `return_stats` also its softmax
    statistics (B, Sq, H): the running max m of the scaled scores and
    the sum l of exp(score - m), which it keeps anyway.
    """
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    dev = q.device
    groups = h // kv
    k = _repeat_kv(k, groups).float()
    v = _repeat_kv(v, groups).float()
    q = q.float() * (1.0 / math.sqrt(hd))

    if kv_len is None:
        kv_len = sk
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=dev) \
        .expand(b)

    nblk = max(1, -(-sk // chunk))
    pad = nblk * chunk - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=-(10 ** 9))
    slot = torch.arange(nblk * chunk, device=dev).reshape(nblk, chunk)
    valid = slot[None] < kv_len[:, None, None]           # (B, nblk, C)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=dev)
    qp = q_positions[:, None, :, None]
    for i in range(nblk):
        sl = slice(i * chunk, (i + 1) * chunk)
        kc, vc, pc = k[:, sl], v[:, sl], kv_positions[:, sl]
        s = torch.einsum("bqhd,bchd->bhqc", q, kc)
        msk = valid[:, i][:, None, None, :]
        if causal:
            msk = msk & (pc[:, None, None, :] <= qp)
        if window:
            msk = msk & (pc[:, None, None, :] > qp - window)
        s = torch.where(msk, s, torch.full((), NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqc,bchd->bhqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    if return_stats:
        return out.transpose(1, 2), m.transpose(1, 2), l.transpose(1, 2)
    return out.transpose(1, 2)  # (B, Sq, H, hd)


@dataclass(frozen=True)
class CacheShard:
    """This rank's part of one attention sublayer's contiguous cache in
    a decode step sharded over a process mesh (``transformer.
    decode_step(data_mesh=, cache_shardings=)``). The rank's k/v (B,
    n, KV', hd') and pos (B, n') hold its batch rows whole; `seq` are
    the mesh axes that split the sequence of k, v and pos alike (the
    merge's axes; () where no such split), `lo` the first global slot
    the rank holds, `smax` the whole cache's slots. `gather_kv` and
    `gather_pos` are (dim, axes, lo, hi) of each other split of the
    period slices (k/v dims 1-3, pos dim 1), gathered at use: every
    such step moves the layer's K/V over the wire, which partial-score
    attention over an hd split would not (ROADMAP, parked)."""
    mesh: object
    smax: int
    seq: tuple = ()
    lo: int = 0
    gather_kv: tuple = ()
    gather_pos: tuple = ()


@dataclass(frozen=True)
class StateShard:
    """This rank's part of one recurrent state leaf (a Mamba ``conv`` or
    ``ssm``, an mLSTM or sLSTM tensor) in a decode step sharded over a
    process mesh. The rank holds its batch rows whole; `splits` are the
    (dim, axes, lo, hi) of each other split of the leaf's period slice,
    every one gathered at use (``update_at_use``): a state is read whole
    by its mixer (Mamba's ``x_proj`` takes all of d_inner)."""
    mesh: object
    splits: tuple = ()


def update_at_use(held, splits, mesh, write):
    """Update the rank's shards `held` (a list of tensors) of whole
    tensors split as `splits` says (for each, its (dim, axes, lo, hi)
    splits): each gathered whole at use over its splits, `write(wholes)`
    returns the updated wholes (the same tensors written in place, or
    new ones), and this rank's slice of each is copied back into its
    shard. Returns the updated wholes."""
    wholes = [_gather_at_use(t, mesh, s) for t, s in zip(held, splits)]
    new = write(wholes)
    for t, n, s in zip(held, new, splits):
        for dim, _, a, e in s:
            n = n.narrow(dim, a, e - a)
        if n is not t:
            t.copy_(n)
    return new


def _ring_slots(cache_len, b: int, s: int, smax: int, device):
    """(global slot (B, s) of each new token, valid slots (B,) after the
    write) of the contiguous ring: an int `cache_len` (uniform batch)
    writes one window from its ring slot, clamped so that it fits (as
    the reference's ``dynamic_update_slice`` does); per-row lengths (B,)
    write each row at its own ring offset."""
    steps = torch.arange(s, dtype=torch.int32, device=device)
    if isinstance(cache_len, int):
        start = min(max(cache_len % smax, 0), smax - s)
        return (start + steps)[None].expand(b, s), torch.full(
            (b,), min(cache_len + s, smax), dtype=torch.int32,
            device=device)
    idx = torch.remainder(cache_len[:, None] + steps[None], smax)
    return idx, torch.clamp(cache_len + s, max=smax).to(torch.int32)


def _write_slots(t, idx, new, lo=None):
    """Write token j of row b, new[b, j], at global slot idx[b, j] of a
    cache tensor t (B, n, ...) in place: with `lo` None t holds every
    slot; else only [lo, lo + n), and tokens outside it are dropped.
    A dropped token rewrites the value t holds at (slot - lo) mod n, a
    slot that no other token of its chunk of n writes, so the write
    needs no host sync (a masked index would)."""
    new = new.to(t.dtype)
    rows = torch.arange(idx.shape[0], device=t.device)[:, None] \
        .expand_as(idx)
    if lo is None:
        t[rows, idx] = new
        return
    n = t.shape[1]
    for j in range(0, idx.shape[1], n):
        ix, r = idx[:, j:j + n], rows[:, j:j + n]
        at = torch.remainder(ix - lo, n)
        mine = ((ix >= lo) & (ix < lo + n)).reshape(
            ix.shape + (1,) * (t.dim() - 2))
        t[r, at] = torch.where(mine, new[:, j:j + n], t[r, at])


def _gather_at_use(t, mesh, dims):
    from repro_torch.distributed import tensor_parallel as TP
    for dim, axes, _, _ in dims:
        t = TP.gather_over(t, mesh, dim, axes, tag="cache")
    return t


def _ring_attention(q, k, v, pos1, cache, cache_len, window: int,
                    impl: str, shard=None):
    """Write this step's k/v into the contiguous ring cache (in place)
    and attend: (B, S, H, hd), the decode-attention kernel's output type
    for one new token on the kernel path, else float32. With `shard`
    (a ``CacheShard``) the cache is this rank's shard: the leaves split
    other than on the sequence are gathered at use and this rank's slice
    written back; over a sequence split (``shard.seq``) each rank
    attends its own slots and the results merge by their softmax
    statistics (``tensor_parallel.merge_softmax``), rounded once, as one
    process rounds."""
    b, s = q.shape[:2]
    held = [cache["k"], cache["v"], cache["pos"]]
    if shard is None:
        shard = CacheShard(None, held[0].shape[1])
    mesh = shard.mesh
    idx, n_valid = _ring_slots(cache_len, b, s, shard.smax, q.device)
    lo = shard.lo if shard.seq else None

    def write(wholes):
        for t, new in zip(wholes, (k, v, pos1)):
            _write_slots(t, idx, new, lo)
        return wholes
    gk, gv, gp = update_at_use(
        held, (shard.gather_kv, shard.gather_kv, shard.gather_pos), mesh,
        write)
    stats = bool(shard.seq)
    kv_len = torch.clamp(n_valid - shard.lo, 0, gk.shape[1]) \
        .to(torch.int32) if stats else n_valid
    # kernels.ops is imported here so the plain model paths never pull in
    # the kernel wrappers
    from repro_torch.kernels import ops as KOPS
    if s == 1 and KOPS.use_kernel(impl, q):
        # q_pos as its own (B,) tensor: a view of 3-axis or broadcast
        # positions is strided, and the kernel takes contiguous inputs
        got = KOPS.decode_attention_impl(
            q[:, 0], gk, gv, gp, kv_len, pos1[:, 0].contiguous(),
            window=window, impl=impl, return_stats=stats)
        if not stats:
            return got[:, None]
        out, m, l = (t[:, None] for t in got)
        dtype = q.dtype   # the one-process kernel's output type
    else:
        got = attention(q, gk, gv, pos1, gp, causal=True, window=window,
                        kv_len=kv_len, return_stats=stats)
        if not stats:
            return got
        out, m, l = got
        dtype = torch.float32
    from repro_torch.distributed import tensor_parallel as TP
    return TP.merge_softmax(out, m, l, mesh, shard.seq, dtype=dtype)


def attention_block(p, cfg, x, positions, *, cache=None, cache_len=None,
                    window: int = 0, impl: str = "ref",
                    block_tables=None, new_counts=None, shard=None):
    """Full attention sublayer: qkv proj -> rope -> attention -> out proj.

    Without a cache this is a prefill pass over x: (B, S, D). With
    cache={k, v, pos} of shape (B, Smax, KV, hd) plus cache_len it is a
    decode step: x is (B, S_new, D), the new k/v are written at
    `cache_len % Smax` (ring buffer). `cache_len` may be a scalar (an
    int: uniform batch) or a (B,) int32 tensor of per-row lengths — the
    continuous-batching slot pool. The cache is written IN PLACE (the
    reference returns a functionally updated copy); the returned
    new_cache holds the same tensors.

    With `block_tables` (B, nbs) int32 the cache is a PAGED pool instead:
    k/v/pos are (NB, block, ...) global block pools and row b's positions
    [i*block, (i+1)*block) live in pool block ``block_tables[b, i]``.
    `new_counts` (B,) gives how many of this step's S tokens are real
    per row (default 1): row b writes its first ``new_counts[b]`` tokens
    at positions ``cache_len[b] + j`` through the table and sends the
    rest to reserved trash block 0, offset 0. Those trash writes collide
    (which one lands is unspecified); every lane that reads block 0 is
    masked, except in a fully hidden row, whose output is ignored.
    Attention then reads each row's dense (nbs*block)-wide view through
    the table; lanes >= cache_len + new_counts are masked with the same
    NEG_INF as the contiguous path.

    `impl` selects the backend of the single-new-token decode hot spot
    (kernels.ops): on CUDA tensors with impl auto/cuda and S_new == 1
    the decode-attention kernel (contiguous or paged) runs; otherwise
    the chunked attention does. Returns (out, new_cache).

    With `shard` (a ``CacheShard``) the cache is this rank's shard of a
    contiguous cache sharded over a process mesh, written in place at
    the global slots that it holds (``_ring_attention``).
    """
    b, s, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.rope == "rope":
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    elif cfg.rope == "mrope":
        # positions may be (B, S) text-only: repeat to 3 identical axes
        pos3 = positions if positions.ndim == 3 else \
            positions[..., None].expand(*positions.shape, 3)
        cos, sin = mrope_cos_sin(pos3, hd, cfg.rope_theta)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    elif cfg.rope != "none":
        raise ValueError(f"unknown rope {cfg.rope!r}")
    pos1 = positions[..., 0] if positions.ndim == 3 else positions

    if cache is None:
        out = attention(q, k, v, pos1, pos1, causal=True, window=window)
        new_cache = None
    elif block_tables is not None:
        out = _paged_attention(q, k, v, pos1, cache, cache_len,
                               block_tables, new_counts, window, impl)
        new_cache = cache
    else:
        out = _ring_attention(q, k, v, pos1, cache, cache_len, window,
                              impl, shard)
        new_cache = cache
    # f32 attention output times a bf16 projection promotes to f32, as
    # in the reference
    out = out.reshape(b, s, h * hd)
    wo = p["wo"]
    dt = torch.promote_types(out.dtype, wo.dtype)
    out = out.to(dt) @ wo.to(dt)
    return out.to(x.dtype), new_cache


def _paged_attention(q, k, v, pos1, cache, cache_len, block_tables,
                     new_counts, window: int, impl: str):
    """Write this step's k/v through the block tables into the pool (in
    place) and attend over each row's chain. Returns (B, S, H, hd)."""
    b, s = q.shape[:2]
    kvh, hd = k.shape[2], k.shape[3]
    ck, cv, kv_pos = cache["k"], cache["v"], cache["pos"]
    blk = ck.shape[1]
    nbs = block_tables.shape[1]
    dev = q.device
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=dev) \
        .expand(b)
    n_new = torch.ones((b,), dtype=torch.int32, device=dev) \
        if new_counts is None else new_counts.to(torch.int32)
    j = torch.arange(s, dtype=torch.int32, device=dev)[None]    # (1, s)
    wpos = cl[:, None] + j                                      # (B, s)
    valid = j < n_new[:, None]
    tab = block_tables.long()
    bidx = torch.gather(tab, 1, torch.clamp(wpos // blk, 0, nbs - 1).long())
    bidx = torch.where(valid, bidx, 0)
    off = torch.where(valid, wpos % blk, 0).long()
    ck[bidx, off] = k.to(ck.dtype)
    cv[bidx, off] = v.to(cv.dtype)
    kv_pos[bidx, off] = pos1.to(torch.int32)
    n_valid = torch.clamp(cl + n_new, max=nbs * blk).to(torch.int32)
    from repro_torch.kernels import ops as KOPS
    if s == 1 and KOPS.use_kernel(impl, q):
        return KOPS.decode_attention_paged_impl(
            q[:, 0], ck, cv, kv_pos, block_tables, n_valid,
            pos1[:, 0].contiguous(), window=window, impl=impl)[:, None]
    # each row's dense view: block i of its table holds positions
    # [i*blk, (i+1)*blk), so the view is position-ordered and masks
    # exactly like the contiguous ring
    gk = ck[tab].reshape(b, nbs * blk, kvh, hd)
    gv = cv[tab].reshape(b, nbs * blk, kvh, hd)
    gpos = kv_pos[tab].reshape(b, nbs * blk)
    return attention(q, gk, gv, pos1, gpos, causal=True, window=window,
                     kv_len=n_valid)


def init_attn_cache(cfg, batch, max_len: int, dtype, device):
    """Empty contiguous KV cache of one attention sublayer. `batch` is the
    leading shape: an int, or (periods, batch) for a cache stacked over
    layer periods. Unwritten slots hold position -10**9."""
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((*lead, max_len, kvh, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((*lead, max_len, kvh, hd), dtype=dtype,
                         device=device),
        "pos": torch.full((*lead, max_len), -(10 ** 9), dtype=torch.int32,
                          device=device),
    }


def init_paged_attn_cache(cfg, lead, num_blocks: int, block: int, dtype,
                          device):
    """Global paged KV pool of one attention sublayer: `num_blocks`
    blocks of `block` tokens shared by every slot through block tables
    (block 0 is the serving layer's reserved trash target). `lead` is
    the leading shape (an int or a tuple, e.g. the layer periods).
    Positions start at the contiguous ring's -10**9 sentinel, so
    unwritten lanes are masked identically."""
    lead = (lead,) if isinstance(lead, int) else tuple(lead)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((*lead, num_blocks, block, kvh, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((*lead, num_blocks, block, kvh, hd), dtype=dtype,
                         device=device),
        "pos": torch.full((*lead, num_blocks, block), -(10 ** 9),
                          dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------- ffn


def init_ffn(gen, d: int, f: int, act: str, dtype, device, lead):
    """An FFN's weights with the leading shape `lead` (an int or a
    tuple: the layer periods, and the experts of an MoE bank), with the
    reference's scales: SwiGLU has w_gate, w_up and w_down; gelu has
    w_up and w_down only."""
    lead = (lead,) if isinstance(lead, int) else tuple(lead)

    def normal(shape, scale):
        return torch.randn((*lead, *shape), generator=gen, dtype=dtype,
                           device=device).mul_(scale)

    sd, sf = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"w_gate": normal((d, f), sd)} if act == "swiglu" else {}
    p["w_up"] = normal((d, f), sd)
    p["w_down"] = normal((f, d), sf)
    return p


def ffn(p, x, act: str, mesh=None):
    """Dense FFN (plain torch: the reference's is plain jnp, no kernel):
    SwiGLU, or gelu in the tanh approximation that ``jax.nn.gelu``
    computes by default. With `mesh` (model > 1) `p` is this rank's
    F-columns of the up products and F-rows of the down product
    (``distributed.tensor_parallel``): x's gradient is summed over the
    model group, and so is the down product's partial, taken in float32
    (exact products, float32 sums) and rounded once after the sum, as
    the one-process product rounds its whole sum."""
    x = TP.copy_to_model(x, mesh)
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    if mesh is None:
        return h @ p["w_down"]
    return TP.reduce_partial(h.float() @ p["w_down"].float(), mesh, h.dtype)
