"""Model assembly: stacked-parameter decoder run as a Python loop over
layer *periods* (the reference scans them with ``lax.scan``).

A "period" is the smallest repeating pattern of sublayers (1 for the
uniform decoders, 2 for llama4's dense/MoE interleave at
``every_n_layers=2`` and for xLSTM's mLSTM/sLSTM alternation, 8 for
Jamba's 1:7 attention:mamba interleave with MoE every 2). Parameters of
sublayer j are stacked over num_periods, exactly as the reference
stores them, so the reference's weights convert leaf for leaf
(``repro_torch.params``).

A prompt prefilled into a cache (``decode_step`` with S_new > 1) runs a
recurrent mixer over every prompt token from the cached state. The
reference runs its one-token ``*_step`` there, which reads the first
token only, so its prefill-into-cache of a recurrent model differs from
its own ``forward``; the port's equals ``forward``.

An encoder-decoder config (whisper-base) runs a bidirectional encoder
over precomputed frame embeddings (``run_encoder``) and gives every
decoder sublayer a cross-attention over its output, in ``forward`` and
in ``decode_step`` alike, with each token's own sinusoidal position.
The reference's ``decode_step`` reads the encoder output but applies no
cross-attention, and gives every token of a multi-token step the
position ``cache_len``; so its prefill into a cache and its decode
differ from its own ``forward``. The port's equal ``forward``.

Entry points:
  init_params(cfg, seed, device)             -> params
  forward(cfg, params, batch, remat=...)     -> (logits, metrics)
  run_encoder(cfg, params, enc_embeds)       -> encoder output (B, T, D)
  init_cache(cfg, params, batch, max_len)    -> cache
  init_paged_cache(cfg, params, num_blocks, block)
                                             -> paged cache
  decode_step(cfg, params, batch, cache, cache_len,
              [data_mesh, cache_shardings])  -> (logits, cache, metrics)
  sample_tokens(logits, temperature, top_k, top_p, seed, step)
                                             -> next tokens (B,)
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import torch
from torch.utils import checkpoint as C

from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import constrain_activations
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import prng
from repro_torch.models import ssm as S


@dataclass(frozen=True)
class SubLayer:
    mixer: str          # attn | mamba | mlstm | slstm
    ffn: str            # dense | moe | none
    cross_attn: bool = False


def layer_pattern(cfg) -> list[SubLayer]:
    """The repeating sublayer pattern (one period) of the decoder stack.
    An encoder-decoder's sublayers carry cross-attention; the
    reference's ``layer_pattern`` leaves it out and only its ``forward``
    and ``init_params`` put it back, so its ``decode_step`` runs
    without it."""
    if cfg.encdec is not None:
        return [SubLayer("attn", "dense", cross_attn=True)]
    if cfg.family == "ssm":                      # xLSTM: mLSTM/sLSTM blocks
        period = cfg.ssm.slstm_every
        return [SubLayer("slstm" if (i % period == period - 1) else "mlstm",
                         "none") for i in range(period)]
    if cfg.family == "hybrid":                   # Jamba
        pa = cfg.attn_every_n
        pm = cfg.moe.every_n_layers if cfg.moe else 1
        period = max(pa, pm)
        while period % pa or period % pm:
            period += 1
        return [SubLayer("attn" if (i % pa == pa // 2) else "mamba",
                         "moe" if (i % pm == pm - 1) else "dense")
                for i in range(period)]
    if cfg.is_moe and cfg.moe.every_n_layers > 1:
        pm = cfg.moe.every_n_layers
        return [SubLayer("attn", "moe" if (i % pm == pm - 1) else "dense")
                for i in range(pm)]
    ffn = "moe" if cfg.is_moe else "dense"
    return [SubLayer("attn", ffn)]


def _sinusoidal_at(pos, d: int):
    """Sinusoidal embeddings (..., d) of integer positions `pos` (a
    tensor of any shape): sines then cosines, in float32."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[..., None] / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoidal(seq_len: int, d: int, device):
    """Positions 0 .. seq_len-1: (seq_len, d) float32."""
    return _sinusoidal_at(torch.arange(seq_len, device=device), d)


# ---------------------------------------------------------------- init


def _normal(gen, shape, dtype, device, scale):
    t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return t.mul_(scale)


def _stacked_norm(cfg, periods: int, dtype, device):
    return {k: v.expand(periods, -1).contiguous() for k, v in
            L.init_norm(cfg.d_model, cfg.norm, dtype, device).items()}


def _init_attention(gen, cfg, periods: int, dtype, device):
    d = cfg.d_model
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    sd = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(gen, (periods, d, h * hd), dtype, device, sd),
        "wk": _normal(gen, (periods, d, kvh * hd), dtype, device, sd),
        "wv": _normal(gen, (periods, d, kvh * hd), dtype, device, sd),
        "wo": _normal(gen, (periods, h * hd, d), dtype, device,
                      1.0 / math.sqrt(h * hd)),
    }
    if cfg.qkv_bias:
        for n, w in (("bq", h * hd), ("bk", kvh * hd), ("bv", kvh * hd)):
            p[n] = torch.zeros((periods, w), dtype=dtype, device=device)
    if cfg.qk_norm:
        for n in ("q_norm", "k_norm"):
            p[n] = torch.ones((periods, hd), dtype=dtype, device=device)
    return p


def _init_sublayer(gen, cfg, sub: SubLayer, periods: int, dtype, device):
    """One pattern position's parameters, stacked over `periods`, with
    the reference's distributions and scales (transformer.py,
    layers.py, moe.py init functions)."""
    d = cfg.d_model
    p = {"norm1": _stacked_norm(cfg, periods, dtype, device)}
    h = cfg.num_heads
    sd = 1.0 / math.sqrt(d)
    if sub.mixer == "mamba":
        p["mamba"] = S.init_mamba(gen, d, cfg.ssm, dtype, device, periods)
    elif sub.mixer == "mlstm":
        p["mlstm"] = S.init_mlstm(gen, d, h, cfg.ssm.expand, dtype, device,
                                  periods)
    elif sub.mixer == "slstm":
        p["slstm"] = S.init_slstm(gen, d, h, dtype, device, periods)
    else:
        p["attn"] = _init_attention(gen, cfg, periods, dtype, device)
    if sub.cross_attn:
        p["norm_x"] = _stacked_norm(cfg, periods, dtype, device)
        p["xattn"] = _init_attention(gen, cfg, periods, dtype, device)
    if sub.ffn != "none":
        p["norm2"] = _stacked_norm(cfg, periods, dtype, device)
        if sub.ffn == "moe":
            e, f = cfg.moe.num_experts, cfg.moe.d_ff
            p["moe"] = {
                "router": {"w_gate": _normal(gen, (periods, d, e), dtype,
                                             device, sd)},
                # the experts as one dense FFN with (E, D, F) leaves
                "experts": L.init_ffn(gen, d, f, cfg.act, dtype, device,
                                      (periods, e)),
            }
        else:
            p["ffn"] = L.init_ffn(gen, d, cfg.d_ff, cfg.act, dtype, device,
                                  periods)
    return p


def init_params(cfg, seed: int, device):
    """Random parameters from a seeded ``torch.Generator`` on `device`,
    laid out as the reference's pytree (layer leaves stacked over
    periods). The numbers differ from the reference's JAX keys; to feed
    both packages the same weights, convert the reference's with
    ``repro_torch.params.from_jax``. On the ``meta`` device (shapes and
    dtypes only, ``models.model.abstract_params``) the generator is a
    CPU one: a meta tensor draws nothing."""
    dtype = getattr(torch, cfg.dtype)
    pattern = layer_pattern(cfg)
    assert cfg.num_layers % len(pattern) == 0, \
        f"{cfg.name}: num_layers={cfg.num_layers} not divisible by " \
        f"period={len(pattern)}"
    np_ = cfg.num_layers // len(pattern)
    device = torch.device(device)
    gen = torch.Generator(device="cpu" if device.type == "meta"
                          else device).manual_seed(seed)
    d = cfg.d_model
    params = {
        "embed": _normal(gen, (cfg.padded_vocab, d), dtype, device, 0.02),
        "layers": [_init_sublayer(gen, cfg, sub, np_, dtype, device)
                   for sub in pattern],
        "final_norm": L.init_norm(d, cfg.norm, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = _normal(gen, (d, cfg.padded_vocab), dtype, device,
                                 1.0 / math.sqrt(d))
    if cfg.encdec is not None:
        params["encoder"] = {
            "layers": [_init_sublayer(gen, cfg, SubLayer("attn", "dense"),
                                      cfg.encdec.num_encoder_layers, dtype,
                                      device)],
            "final_norm": L.init_norm(d, cfg.norm, dtype, device),
        }
    return params


def _period(tree, i: int):
    """Period `i`'s slice of a stacked tree (views, no copies); None
    stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _period(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_period(v, i) for v in tree)
    return tree[i]


def _periods(tree, n: int) -> list:
    """The `n` period slices of a stacked tree, one ``unbind`` a leaf
    (views). Its backward stacks the periods' gradients once, where a
    slice a period (``_period``) builds a zero-filled stacked gradient
    for each period and sums them: bytes quadratic in the depth."""
    if isinstance(tree, dict):
        parts = {k: _periods(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, tuple):
        parts = [_periods(v, n) for v in tree]
        return [tuple(p[i] for p in parts) for i in range(n)]
    return list(torch.unbind(tree, 0))


def _state_leaves(state) -> list:
    """A mixer state's leaves in order: a dict's values, a tuple's
    items."""
    return list(state.values()) if isinstance(state, dict) else list(state)


def _as_state(like, leaves):
    """`leaves` in the structure of the state `like`."""
    return dict(zip(like, leaves)) if isinstance(like, dict) \
        else tuple(leaves)


_SEQ = {"mamba": S.mamba_seq, "mlstm": S.mlstm_seq, "slstm": S.slstm_seq}
_STEP = {"mamba": S.mamba_step, "mlstm": S.mlstm_step,
         "slstm": S.slstm_step}


def _apply_mixer(cfg, sub: SubLayer, p, h, cache, shard=None):
    """A recurrent mixer over h (B, S, D). With no cache, ``*_seq`` from
    the zero state; with a cache, ``*_step`` for one new token and
    ``*_seq`` from the cached state for several (a prompt prefilled into
    the cache), the new state written into the cache slice in place.
    With `shard` (a tuple of ``layers.StateShard``, one a state leaf in
    order) the cache slice is this rank's shard of the state: each leaf
    gathered whole at use, and the rank's slice of the new state
    written back (``layers.update_at_use``)."""
    arg = cfg.ssm if sub.mixer == "mamba" else cfg.num_heads
    mp = p[sub.mixer]
    if cache is None:
        return _SEQ[sub.mixer](mp, h, arg)[0]
    state = cache[sub.mixer]
    held = _state_leaves(state)
    ys = []

    def write(wholes):
        whole = _as_state(state, wholes)
        if h.shape[1] == 1:
            y, new = _STEP[sub.mixer](mp, h, whole, arg)
        else:
            y, new = _SEQ[sub.mixer](mp, h, arg, whole)
        ys.append(y)
        return _state_leaves(new)
    if shard is None:
        L.update_at_use(held, [()] * len(held), None, write)
    else:
        L.update_at_use(held, [r.splits for r in shard], shard[0].mesh,
                        write)
    return ys[0]


# ---------------------------------------------------------------- forward


def _apply_sublayer(cfg, sub: SubLayer, p, x, positions, *, cache=None,
                    cache_len=None, enc_out=None, window=0,
                    collect: bool = False, token_mask=None,
                    block_tables=None, new_counts=None, ep_ctx=None,
                    ep_state=None, data_mesh=None, ffn_mesh=None,
                    cache_shard=None):
    """One sublayer (mixer + optional cross-attention over `enc_out` +
    ffn) with residuals. The layer's cache slice is written in place
    (with `cache_shard`, a ``layers.CacheShard`` for an attention cache
    or a tuple of ``layers.StateShard`` for a recurrent state, it is
    this rank's shard of it).
    With `ep_ctx` and this sublayer's `ep_state` the MoE runs through
    the EP slot data plane; with `data_mesh` (``forward``) its metrics
    and dispatch groups are the data group's; with `ffn_mesh` its FFN
    runs over the model group: a column/row pair (an expert bank or a
    dense one), or an expert bank of this rank's whole experts
    (``forward``). Returns (x, metrics)."""
    metrics = {}
    h = L.norm(x, p["norm1"], cfg.norm)
    if sub.mixer == "attn":
        y, _ = L.attention_block(
            p["attn"], cfg, h, positions,
            cache=None if cache is None else cache["attn"],
            cache_len=cache_len, window=window, impl=cfg.impl,
            block_tables=block_tables, new_counts=new_counts,
            shard=cache_shard)
    else:
        y = _apply_mixer(cfg, sub, p, h, cache, cache_shard)
    x = x + y
    if sub.cross_attn:
        x = x + _cross_attention(cfg, p["xattn"],
                                 L.norm(x, p["norm_x"], cfg.norm), enc_out)
    if sub.ffn != "none":
        h = L.norm(x, p["norm2"], cfg.norm)
        if sub.ffn == "moe":
            if ep_ctx is not None and ep_state is not None:
                # serving hot path with the expert runtime on: the EP slot
                # data plane with the runtime's live tables/weights
                from repro_torch.distributed.ep import moe_ep_ffn
                y, m = moe_ep_ffn(p["moe"], h, ep_state, ep_ctx, cfg,
                                  token_mask=token_mask)
            else:
                y, m = MOE.dispatch_moe(
                    p["moe"], h, top_k=cfg.moe.top_k,
                    num_experts=cfg.moe.num_experts,
                    capacity_factor=cfg.moe.capacity_factor, act=cfg.act,
                    groups=_moe_groups(h, data_mesh),
                    token_mask=token_mask, impl=cfg.impl,
                    data_mesh=data_mesh, model_mesh=ffn_mesh)
            metrics["expert_load"] = m["expert_load"]
            metrics["aux_loss"] = m["aux_loss"]
            metrics["dropped"] = m["dropped"]
            if collect:   # predictor fine-tuning dataset (paper §5)
                metrics["gate_input"] = h
                if "router_logits" in m:
                    metrics["router_logits"] = m["router_logits"].reshape(
                        h.shape[0], h.shape[1], -1)
        else:
            y = L.ffn(p["ffn"], h, cfg.act, mesh=ffn_mesh)
        x = x + y
    return x, metrics


def _attend(pa, q, kv_in):
    """Attention of q (B, Sq, H, hd) over keys and values projected from
    `kv_in` (B, T, D), every one of the T visible to every query (no
    causal mask), then the output projection: (B, Sq, D) in float32
    (the attention output promotes the projection, as in the
    reference)."""
    b, t, _ = kv_in.shape
    sq, hd = q.shape[1], q.shape[-1]
    k = (kv_in @ pa["wk"]).reshape(b, t, -1, hd)
    v = (kv_in @ pa["wv"]).reshape(b, t, -1, hd)
    kv_pos = torch.arange(t, dtype=torch.int32, device=q.device)[None] \
        .expand(b, t)
    q_pos = torch.zeros((b, sq), dtype=torch.int32, device=q.device)
    y = L.attention(q, k, v, q_pos, kv_pos, causal=False)
    return y.reshape(b, sq, -1) @ pa["wo"].float()


def _cross_attention(cfg, pa, h, enc_out):
    """Cross-attention of h (B, S, D) over the encoder output (B, T, D):
    keys and values projected from it at every call, as the reference
    does (plain torch: the reference's is plain jnp, no kernel)."""
    b, s, _ = h.shape
    q = (h @ pa["wq"]).reshape(b, s, cfg.num_heads, cfg.resolved_head_dim)
    return _attend(pa, q, enc_out).to(h.dtype)


def run_encoder(cfg, params, enc_embeds):
    """The reference's ``_run_encoder``: sinusoidal positions added to
    the frame embeddings (B, T, D) of the stub frontend, taken in the
    model's dtype, then bidirectional attention and the dense FFN in
    each encoder layer, and the final norm. Plain torch: the reference's
    is plain jnp, no kernel. Returns (B, T, D)."""
    enc = params["encoder"]
    x = enc_embeds.to(params["embed"].dtype)
    b, t, d = x.shape
    x = x + _sinusoidal(t, d, x.device).to(x.dtype)[None]
    hd, nh = cfg.resolved_head_dim, cfg.num_heads
    for i in range(cfg.encdec.num_encoder_layers):
        lp = _period(enc["layers"][0], i)
        hn = L.norm(x, lp["norm1"], cfg.norm)
        q = (hn @ lp["attn"]["wq"]).reshape(b, t, nh, hd)
        x = x + _attend(lp["attn"], q, hn).to(x.dtype)
        x = x + L.ffn(lp["ffn"], L.norm(x, lp["norm2"], cfg.norm), cfg.act)
    return L.norm(x, enc["final_norm"], cfg.norm)


_MOE_GROUPS = {"groups": 1}


def set_moe_dispatch_groups(n: int) -> None:
    """Global dispatch-group count (= number of data shards) of the
    GShard path; launchers and the dry-run set it to the mesh's
    data-parallel degree."""
    _MOE_GROUPS["groups"] = n


def _moe_groups(h, data_mesh=None):
    """The dispatch groups of h (B, S, D): at least the set count, and
    groups of at most ~2048 tokens (the one-hot dispatch tensor is
    O(t_g^2) a group), as the reference's. Under a data-parallel step
    (`data_mesh`) h is this rank's share of the microbatch: the count is
    the whole microbatch's (as ``dispatch_moe`` would settle it), at
    least one group a data rank, of which this rank holds an equal run
    of whole groups; ValueError where it cannot."""
    dp = 1 if data_mesh is None else data_mesh.shape["data"]
    t = h.shape[0] * h.shape[1] * dp
    if dp == 1:
        return max(_MOE_GROUPS["groups"], t // 2048)
    g = max(_MOE_GROUPS["groups"], dp, t // 2048)
    g = max(1, min(g, t))
    while t % g:
        g -= 1
    if g % dp:
        raise ValueError(f"{g} dispatch groups of {t} tokens do not split "
                         f"into whole groups over {dp} data ranks")
    return g // dp


# the reference's `remat` values (its ``jax.checkpoint`` of one period)
REMATS = ("none", "full", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of the products with no batch
    dimension (``aten.mm``/``aten.addmm``, which ``x @ w`` dispatches to)
    and recompute everything else, ``bmm`` included: what the
    reference's ``dots_with_no_batch_dims_saveable`` keeps."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return C.CheckpointPolicy.MUST_SAVE
    return C.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, remat: str):
    """`body` of one period under `remat`: as it is, or checkpointed
    (non-reentrant) so that backward recomputes it — all of it
    (``"full"``) or all but the unbatched products (``"dots"``)."""
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}; expected one of "
                         f"{REMATS}")
    if remat == "none":
        return body
    kw = {} if remat == "full" else {"context_fn": functools.partial(
        C.create_selective_checkpoint_contexts, _dots_policy)}
    return functools.partial(C.checkpoint, body, use_reentrant=False, **kw)


def forward(cfg, params, batch, *, window: int = 0, collect: bool = False,
            remat: str = "none", last_only: bool = False, ep_ctx=None,
            ep_state=None, token_mask=None, data_mesh=None,
            param_shardings=None, grad_sinks=None):
    """Prefill / training forward over whole sequences, writing no cache.
    batch: {tokens (B, S), [positions (B, S)], [token_mask (B, S)],
    [enc_embeds (B, T, D)]} -> (logits, metrics). An encoder-decoder
    config needs 'enc_embeds': the encoder runs over them, the decoder
    input gains sinusoidal positions and every decoder sublayer attends
    to the encoder output.

    `remat` (``REMATS``) checkpoints each period's sublayers as the
    reference's ``jax.checkpoint`` of its scan body does: ``"full"``
    recomputes the period in backward, ``"dots"`` keeps its unbatched
    products' outputs. `ep_ctx` + `ep_state` (``decode_step``'s layout)
    route every MoE sublayer through the EP slot data plane.
    `token_mask` (B, S), or batch['token_mask'], excludes tokens (padded
    prefill) from the expert-load and dropped metrics. `data_mesh` (a
    ``launch.mesh.ProcessMesh``; the ZeRO-2 train step) makes `batch`
    this rank's share of a data-parallel microbatch: each MoE dispatches
    this rank's dispatch groups and its metrics and aux loss are the
    whole microbatch's (``moe.dispatch_moe``). `last_only` keeps
    only the last position (before the final norm). metrics: 'aux_loss'
    summed over layers, 'expert_load' (Lm, E) and 'dropped' (Lm,); with
    `collect` also 'gate_input' (Lm, B, S, D) and, off the EP plane,
    'router_logits' (Lm, B, S, E), MoE layers in period-major order.

    On a `data_mesh` with model > 1, `params` may be this rank's shards
    (``distributed.sharding.shard_tree``): each leaf split on the one
    dim where its shape differs from ``init_params``' (``_tensor_
    parallel``), or on the dims `param_shardings` (their NamedSharding
    tree) gives it. A column/row FFN runs on the rank's F-slices, an
    expert bank split on its expert dim on the rank's whole experts
    (``params_shardings(ep_experts=True)``), an embedding and a head
    split on V are vocabulary-parallel, every other split leaf is
    gathered at its use (``distributed.tensor_parallel``);
    the logits are then this rank's columns of the vocabulary. Where
    `param_shardings` splits leaves over the data axes too (ZeRO-3,
    ``params_shardings(fsdp=True)``), each such leaf is gathered over
    the data group first (``tensor_parallel.gather_from_data``): the
    leaves outside the layers once a call, a layer's leaves one period
    at a time inside the period's body (again in remat's recompute).
    `grad_sinks` (a tree of `params`' structure: this rank's float32
    accumulator of each data-split leaf, None elsewhere) takes the
    gradient of each such leaf, summed over the data group in float32,
    and the leaf then gets none from autograd (the ZeRO-3 train step)."""
    pattern = layer_pattern(cfg)
    tp = _tp_layout(cfg, params, data_mesh, ep_ctx, param_shardings,
                    grad_sinks)
    params = tp.params
    x = _embed(params, batch, tp.embed_mesh)
    bsz, seq_len = batch["tokens"].shape
    pos = batch.get("positions")    # (B, S), or (B, S, 3) under mrope
    if pos is None:
        pos = torch.arange(seq_len, dtype=torch.int32,
                           device=x.device)[None].expand(bsz, seq_len)
    if token_mask is None:
        token_mask = batch.get("token_mask")
    enc_out = None
    if cfg.encdec is not None:
        if "enc_embeds" not in batch:
            raise ValueError(f"{cfg.name}: forward needs batch"
                             "['enc_embeds'] (an encoder-decoder config)")
        enc_out = run_encoder(cfg, params, batch["enc_embeds"])
        x = x + _sinusoidal(seq_len, cfg.d_model, x.device).to(x.dtype)[None]

    def body(x, layer_params, layer_ep, i):
        x = constrain_activations(x)
        ms = []
        for j, sub in enumerate(pattern):
            # gathered here: at use, under remat
            p, ffn_mesh = tp.sublayer(j, layer_params[j], i)
            x, m = _apply_sublayer(cfg, sub, p, x, pos,
                                   enc_out=enc_out, window=window,
                                   collect=collect,
                                   token_mask=token_mask, ep_ctx=ep_ctx,
                                   ep_state=layer_ep[j],
                                   data_mesh=data_mesh, ffn_mesh=ffn_mesh)
            ms.append(m)
        return x, ms

    body = _remat(body, remat)
    np_ = cfg.num_layers // len(pattern)
    ms = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = [_periods(lp, np_) for lp in params["layers"]]
    for i in range(np_):
        x, m_i = body(x, [lp[i] for lp in layers],
                      [None if ep_state is None or ep_state[j] is None
                       else _period(ep_state[j], i)
                       for j in range(len(pattern))], i)
        for m in m_i:
            if "aux_loss" in m:
                aux = aux + m["aux_loss"]
        ms.extend(m_i)
    if last_only:   # prefill: only the last position feeds sampling
        x = x[:, -1:]
    x = L.norm(x, params["final_norm"], cfg.norm)
    metrics = {"aux_loss": aux, **_stack_metrics(ms, collect, x.device)}
    rl = [m["router_logits"] for m in ms if "router_logits" in m]
    if rl:   # the EP data plane does not emit router logits
        metrics["router_logits"] = torch.stack(rl)
    return _lm_head(cfg, params, x, tp.head_mesh), metrics


@functools.lru_cache(maxsize=16)
def _whole_shapes(cfg):
    """``init_params``' tree of `cfg` on the meta device (shapes only)."""
    return init_params(cfg, 0, torch.device("meta"))


def _tensor_parallel(cfg, params, mesh):
    """(model dims of every leaf of `params`, the mesh) where `mesh` has
    model > 1, else (None, None): a leaf's model dim is the one where
    its shape differs from ``init_params``' (``tensor_parallel.
    model_dims``), None for a leaf held whole."""
    if TP.model_size(mesh) == 1:
        return None, None
    return TP.model_dims(params, _whole_shapes(cfg)), mesh


@dataclass(frozen=True)
class _TPLayout:
    """How a step runs a rank's parameters sharded (``forward`` and
    ``decode_step`` alike): `params` with every split leaf gathered at
    use but the layers' and a vocabulary-parallel embedding's and
    head's, the model group's mesh (None off one), the layers' model
    dims of one period, and the meshes of the vocabulary-parallel
    embedding and head (None where a table is whole); under ZeRO-3 the
    mesh whose data group gathers the layers' data-split leaves (None
    where none is split), their data dims of one period, and the layers'
    gradient sinks (``forward``'s `grad_sinks`, stacked, or None)."""
    params: dict
    mesh: object = None
    layer_dims: list = None
    embed_mesh: object = None
    head_mesh: object = None
    data_mesh: object = None
    layer_data_dims: list = None
    layer_sinks: list = None

    def sublayer(self, j: int, p, i: int):
        """(sublayer j's parameters `p` of period `i` gathered at use:
        over the data group, then over the model group, the mesh of its
        FFN where that runs over the model group (a column/row pair or
        this rank's whole experts), else None)."""
        if self.data_mesh is not None:
            p = TP.gather_data_tree(
                p, self.layer_data_dims[j], self.data_mesh,
                None if self.layer_sinks is None
                else _period(self.layer_sinks[j], i))
        if self.mesh is None:
            return p, None
        return _gather_sublayer(p, self.layer_dims[j], self.mesh)


def _split_dims(cfg, params, mesh, shardings):
    """(data dims, model dims): trees of `params`' structure, each leaf's
    dim split over the data axes and over "model" (None for a leaf held
    whole on them), or None for an axis of size one. From `shardings`
    (a NamedSharding tree: ``sharding.data_dim``, ``model_dim``) where
    given; else no data dims and the model dims inferred from shapes
    (``_tensor_parallel``)."""
    if shardings is None:
        return None, _tensor_parallel(cfg, params, mesh)[0]
    if mesh is None:
        raise ValueError("param_shardings needs the mesh of the ranks "
                         "that hold the shards (data_mesh)")
    return (SH.tree_map(SH.data_dim, shardings)
            if TP.data_size(mesh) > 1 else None,
            SH.tree_map(SH.model_dim, shardings)
            if TP.model_size(mesh) > 1 else None)


def _tp_layout(cfg, params, data_mesh, ep_ctx=None, shardings=None,
               sinks=None) -> _TPLayout:
    """The ``_TPLayout`` of `params` on `data_mesh` (``_split_dims``:
    every leaf split as `shardings` says or, without them, at model > 1
    on the one dim where its shape differs from ``init_params``'; else
    everything as it is). The leaves outside the layers are gathered
    over the data group here, `sinks` taking their gradients."""
    ddims, dims = _split_dims(cfg, params, data_mesh, shardings)
    if ddims is None and dims is None:
        return _TPLayout(params)
    if ep_ctx is not None:
        raise NotImplementedError(
            "the EP slot plane at model > 1 or on parameters split over "
            "data waits in ROADMAP parked (c)4")
    out = _TPLayout(params)
    if ddims is not None:
        out = _TPLayout(
            TP.gather_data_tree(params, ddims, data_mesh, sinks,
                                keep={("layers",)}),
            data_mesh=data_mesh,
            layer_data_dims=[TP.unstack_dims(d) for d in ddims["layers"]],
            layer_sinks=None if sinks is None else sinks["layers"])
    if dims is None:
        return out
    mesh = data_mesh
    embed_mesh = mesh if dims["embed"] == 0 else None
    head_mesh = embed_mesh if cfg.tie_embeddings else \
        mesh if dims["head"] == 1 else None
    keep = {("layers",)} | {(k,) for k, m in (("embed", embed_mesh),
                                              ("head", head_mesh)) if m}
    return dataclasses.replace(
        out, params=TP.gather_tree(out.params, dims, mesh, keep=keep),
        mesh=mesh, layer_dims=[TP.unstack_dims(d) for d in dims["layers"]],
        embed_mesh=embed_mesh, head_mesh=head_mesh)


def _gather_sublayer(p, dims, mesh):
    """(one period's sublayer parameters with every split leaf gathered
    at use but a column/row FFN's and an expert bank split on its expert
    dim, the mesh where its FFN is one of those or None). An expert bank
    is never gathered over "model" where its expert dim is split
    (``tensor_parallel.split_experts`` raises on a bank split so in part
    of its leaves); ``moe.dispatch_moe`` tells the two kinds apart by the
    bank's shape."""
    keep = set()
    if "moe" in p:
        bank, bdims = p["moe"]["experts"], dims["moe"]["experts"]
        if TP.split_experts(bank, bdims) or TP.split_ffn(bank, bdims):
            keep.add(("moe", "experts"))
    elif "ffn" in p and TP.split_ffn(p["ffn"], dims["ffn"]):
        keep.add(("ffn",))
    return TP.gather_tree(p, dims, mesh, keep=keep), \
        mesh if keep else None


def _embed(params, batch, vocab_mesh=None):
    """Token embeddings; a VLM's `vis_embeds` (B, S, D) replace them
    where `vis_mask` (B, S) is set (early fusion of the stub vision
    frontend's patch embeddings). With `vocab_mesh` the table is this
    rank's rows of the vocabulary (``tensor_parallel.vocab_embed``)."""
    if vocab_mesh is not None:
        x = TP.vocab_embed(params["embed"], batch["tokens"], vocab_mesh)
    else:
        x = params["embed"][batch["tokens"].long()]
    if "vis_embeds" in batch:
        x = torch.where(batch["vis_mask"][..., None],
                        batch["vis_embeds"].to(x.dtype), x)
    return x


def _stack_metrics(ms, collect: bool, device):
    """The MoE sublayers' 'expert_load' (Lm, E), 'dropped' (Lm,) and,
    with `collect`, 'gate_input' (Lm, B, S, D), stacked in the order of
    `ms` (period-major)."""
    loads = [m["expert_load"] for m in ms if "expert_load" in m]
    if not loads:
        return {}
    out = {"expert_load": torch.stack(loads),
           "dropped": torch.stack(
               [torch.as_tensor(m["dropped"], dtype=torch.float32,
                                device=device) for m in ms if "dropped" in m])}
    if collect:
        out["gate_input"] = torch.stack(
            [m["gate_input"] for m in ms if "gate_input" in m])
    return out


# ---------------------------------------------------------------- decode


def init_cache(cfg, params, batch: int, max_len: int):
    """Cache tree mirroring params['layers']: per pattern position
    {attn: {k, v, pos}}, {mamba: {conv, ssm}}, {mlstm: (C, n, m)} or
    {slstm: (c, n, m, h)}, leaves stacked over periods, on the
    parameters' device. Recurrent states are float32 (the conv window
    in the model dtype)."""
    pattern = layer_pattern(cfg)
    np_ = cfg.num_layers // len(pattern)
    dtype, dev = getattr(torch, cfg.dtype), params["embed"].device
    lead = (np_, batch)

    def one(sub: SubLayer, p):
        if sub.mixer == "attn":
            return {"attn": L.init_attn_cache(cfg, lead, max_len, dtype,
                                              dev)}
        if sub.mixer == "mamba":
            return {"mamba": S.init_mamba_state(p["mamba"], cfg.ssm, lead)}
        if sub.mixer == "mlstm":
            return {"mlstm": S.init_mlstm_state(cfg, lead, cfg.ssm.expand,
                                                dev)}
        return {"slstm": S.init_slstm_state(cfg.d_model, cfg.num_heads,
                                            lead, dev)}

    return [one(sub, p) for sub, p in zip(pattern, params["layers"])]


def require_paged_kv(cfg) -> list[SubLayer]:
    """`cfg`'s layer pattern, or ValueError if its decode stack cannot
    live in a paged block pool: only attention-only decoders can, since
    recurrent state is per slot, which block tables cannot express, and
    an encoder-decoder's decode takes one scalar length."""
    pattern = layer_pattern(cfg)
    if cfg.encdec is not None or any(sub.mixer != "attn"
                                     for sub in pattern):
        raise ValueError(f"{cfg.name}: paged KV needs an attention-only "
                         "decoder (no SSM state, no enc-dec)")
    return pattern


def _leaf_paths(tree, path=()) -> list:
    """[(path, leaf)] of a cache subtree (dicts and tuples), in leaf
    order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(path, tree)]
    return [pl for k, v in items for pl in _leaf_paths(v, path + (k,))]


def _cache_shards(cache, cache_shardings, mesh):
    """(each pattern position's record, the mesh of the MoE's
    data-parallel metrics or None): this rank's part of every sublayer's
    cache from its shardings (``distributed.sharding.cache_shardings``)
    and the shapes it holds, a ``layers.CacheShard`` for an attention
    cache and a tuple of ``layers.StateShard`` (one a leaf, in order) for
    a recurrent state. The batch rows must split alike in every leaf,
    attention's and recurrent state's (over the data axes, whose ranks
    then sum the MoE metrics), or in none; an attention cache's sequence
    split shared by k, v and pos stays local and merges, and every other
    split is gathered at use."""
    shards, rows = [], set()

    def others(r, first):
        return tuple((d - 1, *r[d]) for d in range(first, len(r))
                     if r[d] is not None)
    for j, c in enumerate(cache):
        (mixer, c), = c.items()
        got = {path: SH.shard_ranges(
            SH.leaf_at(cache_shardings, (j, mixer) + path), t.shape)
            for path, t in _leaf_paths(c)}
        rows.update(r[1] and r[1][0] for r in got.values())
        if mixer != "attn":
            shards.append(tuple(L.StateShard(mesh, others(r, 2))
                                for r in got.values()))
            continue
        kr, pr = got[("k",)], got[("pos",)]
        if kr != got[("v",)]:
            raise ValueError("k and v of a cache must share one layout")
        seq = kr[2] if kr[2] == pr[2] else None
        smax = c["pos"].shape[2] * (1 if pr[2] is None else
                                    SH._axis_size(mesh, pr[2][0]))
        shards.append(L.CacheShard(
            mesh, smax, seq=() if seq is None else seq[0],
            lo=0 if seq is None else seq[1],
            gather_kv=others(kr, 3 if seq else 2),
            gather_pos=others(pr, 3 if seq else 2)))
    if len(rows) > 1:
        raise ValueError(f"the cache's batch rows split differently over "
                         f"its leaves: {rows}")
    split = rows.pop()
    if split and set(split) != {"data"}:
        raise ValueError(f"the cache's batch rows split over {split}; the "
                         "sharded decode step takes them over 'data'")
    return shards, mesh if split else None


def init_paged_cache(cfg, params, num_blocks: int, block: int):
    """Paged-pool cache tree: the same per-period stacking as
    ``init_cache``, but each attention sublayer holds ONE global block
    pool (periods, num_blocks, block, KV, hd) addressed by per-row block
    tables instead of per-slot rows. Attention-only decoders only
    (``require_paged_kv``)."""
    pattern = require_paged_kv(cfg)
    np_ = cfg.num_layers // len(pattern)
    return [{"attn": L.init_paged_attn_cache(cfg, np_, num_blocks, block,
                                             getattr(torch, cfg.dtype),
                                             params["embed"].device)}
            for _ in pattern]


def decode_step(cfg, params, batch, cache, cache_len, *, window: int = 0,
                collect: bool = False, ep_ctx=None, ep_state=None,
                data_mesh=None, cache_shardings=None, param_shardings=None):
    """One decode iteration: batch['tokens'] is (B, S_new) — S_new=1 for
    token-by-token decode, S_new=prompt_len for prefill-into-cache
    (cache_len=0). `cache_len` is an int (uniform batch), a 0-d tensor
    (the same depth for every row, taken as per-row depths) or a (B,)
    int32 tensor of per-row cache depths (the continuous-batching slot
    pool).
    `batch` may carry 'token_mask' (B, S_new) or 'active' (B,) to exclude
    tokens from the expert-load metrics. With a paged cache, `batch`
    carries 'block_tables' (B, nbs) int32 and 'new_counts' (B,) — the
    tokens each row really writes this step (a chunk for prefilling
    rows, 1 for decoding rows, 0 for inactive rows); without a
    'token_mask' the mask is built from 'new_counts'. `ep_ctx`
    (``distributed.ep.EPContext``) + `ep_state` (one entry per sublayer
    pattern position, None for non-MoE positions, else that position's
    slot tables/weights stacked over periods, from
    ``serving.expert_runtime.ExpertRuntime.ep_state``) route every MoE
    sublayer through the EP slot data plane. The cache is updated in
    place and returned.

    An encoder-decoder config takes the encoder output as
    batch['enc_out'] (B, T, D), or batch['enc_embeds'] to run the encoder
    first, and one `cache_len` (an int or a 0-d tensor): every decoder
    sublayer attends to the encoder output, and each new token gains its
    own position's
    sinusoid, so a prefill into a fresh cache and the decode steps after
    it give ``forward``'s logits (the reference's ``decode_step`` does
    neither). Returns (logits (B,S_new,V), cache, metrics).

    On a `data_mesh` (a ``launch.mesh.ProcessMesh``) of more than one
    rank, `cache` is this rank's shards of the whole cache laid out by
    `cache_shardings` (``distributed.sharding.cache_shardings``), and
    `batch` and `cache_len` are this rank's rows of the batch where the
    cache's rows split over data (then the MoE metrics are summed over
    the data group), else the whole batch. `params` are this rank's
    shards as ``forward`` takes them (laid out by `param_shardings`
    where given, ZeRO-3's data splits gathered at use as there), and
    the logits are this rank's
    rows and, where the head splits the vocabulary, its columns
    (``models.model.make_serve_step`` gathers them). Every cache runs so:
    an attention cache split on its sequence merges the ranks' softmax
    statistics, and every other split of an attention cache or of a
    recurrent state leaf is gathered at use and the rank's slice written
    back (``_cache_shards``); an encoder-decoder's `enc_out` (or
    `enc_embeds`, through ``run_encoder`` on the encoder's weights
    gathered at use) holds the rank's rows, as the tokens do."""
    pattern = layer_pattern(cfg)
    shards, moe_mesh = [None] * len(pattern), None
    if data_mesh is not None and data_mesh.size > 1:
        if cache_shardings is None:
            raise ValueError("a decode step on a process mesh needs the "
                             "cache's layout (cache_shardings)")
        shards, moe_mesh = _cache_shards(cache, cache_shardings, data_mesh)
    if "enc_out" in batch and "encoder" in params:
        # the encoder does not run: its weights are not gathered at use
        params = {k: v for k, v in params.items() if k != "encoder"}
    tp = _tp_layout(cfg, params, data_mesh, ep_ctx, param_shardings)
    params = tp.params
    tokens = batch["tokens"]
    x = _embed(params, batch, tp.embed_mesh)
    bsz, s_new = tokens.shape
    steps = torch.arange(s_new, dtype=torch.int32, device=tokens.device)
    enc_out = None
    if cfg.encdec is not None:
        if isinstance(cache_len, torch.Tensor) and cache_len.ndim > 0:
            raise ValueError(f"{cfg.name}: an encoder-decoder decode step "
                             "takes an int cache_len or a 0-d tensor (one "
                             "position for the whole batch), not per-row "
                             "lengths")
        if "enc_out" in batch:
            enc_out = batch["enc_out"].to(x.dtype)
        elif "enc_embeds" in batch:
            enc_out = run_encoder(cfg, params, batch["enc_embeds"])
        else:
            raise ValueError(f"{cfg.name}: an encoder-decoder decode step "
                             "needs batch['enc_out'] or batch['enc_embeds']")
        x = x + _sinusoidal_at(cache_len + steps, cfg.d_model) \
            .to(x.dtype)[None]
    if not isinstance(cache_len, int):
        # a 0-d tensor is one depth for every row: read no value (the
        # dry-run's step runs on the meta device), take the per-row path
        cache_len = cache_len.to(torch.int32).expand(bsz)
    pos = batch.get("positions")    # (B, S_new), or (B, S_new, 3)
    if pos is None:
        if isinstance(cache_len, int):
            pos = (cache_len + steps)[None].expand(bsz, s_new)
        else:
            pos = cache_len[:, None] + steps[None]
    # continuous batching: mask of tokens whose routing counts toward the
    # control plane's expert-load metric — per-token (B, S_new) via
    # 'token_mask' (padded prefill) or per-slot (B,) via 'active'
    token_mask = batch.get("token_mask")
    if token_mask is None and "active" in batch:
        token_mask = batch["active"][:, None].expand(bsz, s_new)
    block_tables = batch.get("block_tables")
    new_counts = batch.get("new_counts")
    if block_tables is not None and new_counts is not None and \
            token_mask is None:
        token_mask = steps[None] < new_counts.to(torch.int32)[:, None]
    np_ = cfg.num_layers // len(pattern)
    ms = []
    for i in range(np_):
        for j, sub in enumerate(pattern):
            p, ffn_mesh = tp.sublayer(j, _period(params["layers"][j], i), i)
            x, m = _apply_sublayer(cfg, sub, p, x, pos,
                                   cache=_period(cache[j], i),
                                   cache_len=cache_len, enc_out=enc_out,
                                   window=window,
                                   collect=collect, token_mask=token_mask,
                                   block_tables=block_tables,
                                   new_counts=new_counts, ep_ctx=ep_ctx,
                                   ep_state=None if ep_state is None
                                   or ep_state[j] is None
                                   else _period(ep_state[j], i),
                                   data_mesh=moe_mesh, ffn_mesh=ffn_mesh,
                                   cache_shard=shards[j])
            ms.append(m)
    x = L.norm(x, params["final_norm"], cfg.norm)
    return _lm_head(cfg, params, x, tp.head_mesh), cache, \
        _stack_metrics(ms, collect, x.device)


# ---------------------------------------------------------------- sampling


def _filter_top_k_top_p(lg, k, p):
    """Mask each row of logits (B, V) to its top-k entries (k <= 0: all)
    and its top-p nucleus (the smallest prefix of the descending order
    with cumulative mass >= p; the argmax always survives), with a
    different k and p on every row. Ties keep vocabulary order (a stable
    sort), as the reference's ``argsort`` does."""
    v = lg.shape[-1]
    order = torch.argsort(-lg, dim=-1, stable=True)      # descending
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(v, device=lg.device).expand_as(order))
    keep_k = (k[:, None] <= 0) | (ranks < k[:, None])
    srt = lg.gather(-1, order)
    e = torch.exp(srt - srt.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    cum = torch.cumsum(probs, -1) - probs               # exclusive mass
    keep_p = (cum < p[:, None]).gather(-1, ranks)       # rank 0 kept
    return torch.where(keep_k & keep_p, lg, -math.inf)


@torch.no_grad()
def sample_tokens(logits, temperature, top_k, top_p, seed, step):
    """Next token of EVERY row in one call, with no host sync and no
    data-dependent shape.

    logits (B, V); temperature/top_p (B,) float32; top_k (B,) int32;
    seed (B,) int32 per-request seeds; step (B,) int32 = tokens each
    request has already sampled; all on the logits' device. Rows with
    temperature <= 0 take ``torch.argmax``, bit-identical to greedy
    decoding. Sampled rows take argmax(filtered(logits / t) + Gumbel
    noise) with the key ``fold_in(PRNGKey(seed), step)`` (``models.
    prng``, the reference's threefry bits): keyed by the request, not
    the slot or the batch, so batched decoding samples what sequential
    decoding does. Returns (B,) int32."""
    greedy = torch.argmax(logits, dim=-1)
    lg = logits.float() / temperature.clamp_min(1e-6)[:, None]
    lg = _filter_top_k_top_p(lg, top_k, top_p)
    key = prng.fold_in(prng.key(seed), step)
    sampled = torch.argmax(prng.gumbel(key, lg.shape[-1]) + lg, dim=-1)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)


def _lm_head(cfg, params, x, vocab_mesh=None):
    """Logits of x; with `vocab_mesh` the head is this rank's columns of
    the vocabulary (x's gradient summed over the model group) and so
    are the logits, their pad entries masked at global indices."""
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    lo = 0
    if vocab_mesh is not None:
        x = TP.copy_to_model(x, vocab_mesh)
        lo = TP.vocab_offset(vocab_mesh, head.shape[1])
    logits = x @ head
    if cfg.padded_vocab != cfg.vocab_size:   # mask pad entries
        bias = torch.where(
            torch.arange(lo, lo + head.shape[1], device=x.device)
            < cfg.vocab_size, 0.0, -1e9).to(logits.dtype)
        logits = logits + bias
    return logits
