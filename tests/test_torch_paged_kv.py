"""PyTorch port, paged serving: the paged decode-attention function, the
paged attention sublayer, the block allocator with its radix prefix
cache, and the paged / chunked / prefix-cached engine, each against the
JAX reference on the same numpy inputs and the reference's float32
weights.

Tolerances: the attention function float32 atol=rtol=1e-5 (float32 sums
in another order), bfloat16 atol=rtol=2e-2 compared in float32 (the
Pallas kernel rounds the scaled query to bfloat16, the plain versions
do not); the sublayer float32 atol=rtol=1e-5, its written positions
exact and its written k/v within the same tolerance. Allocator state, engine tokens, ServeResult
counters, the modeled clock and per-request TTFT/TPOT/E2E are exact.

Engine identity across KV layouts holds at the drop-free capacity
factor: inactive and masked lanes carry layout-dependent hidden states
that enter the MoE capacity dispatch, as in the reference
(``tests/test_paged_kv.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ServingSpec as JServingSpec
from repro.configs import get_config as jget_config
from repro.core.control import MoElessController as JMoElessController
from repro.kernels import decode_attn as JDA
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.kv import PagedKVCache as JPagedKVCache
from repro.serving.scheduler import GenRequest as JGenRequest
from repro_torch.configs import ServingSpec, get_config
from repro_torch.core.control import MoElessController
from repro_torch.core.costmodel import kv_bytes_per_block
from repro_torch.kernels import decode_attn as DA
from repro_torch.kernels import ops as OPS
from repro_torch.models import layers as L
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv import PagedKVCache
from repro_torch.serving.scheduler import GenRequest
from test_torch_kernels_cuda import _paged_case

torch.set_num_threads(1)

F32_TOL = 1e-5
TOL = {"float32": F32_TOL, "bfloat16": 2e-2}


@functools.lru_cache(maxsize=None)
def _setup():
    """Float32 mixtral smoke configs of both packages at the drop-free
    capacity factor, with the reference's weights in both forms
    (read-only)."""
    cfg = get_config("mixtral-8x7b", smoke=True).with_(dtype="float32")
    jcfg = jget_config("mixtral-8x7b", smoke=True).with_(dtype="float32",
                                                         impl="ref")
    cf = float(cfg.moe.num_experts)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(4))
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


# ------------------------------------------------------------ function


def _torch(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(getattr(torch, dtype)) if t.is_floating_point() else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("blk", [1, 3, 16])
def test_paged_attention_matches_reference(dtype, window, blk):
    """Port (plain version, through the wrapper and the ops dispatch)
    against the reference's Pallas kernel in interpret mode and its
    plain version: a full row, a kv_len = 0 row, a partial row."""
    nbs = -(-24 // blk)
    case = _paged_case(3, 4, 2, 16, blk, nbs, [nbs * blk, 0, 13])
    targs = [_torch(a, dtype) for a in case]
    got = DA.decode_attention_paged(*targs, window=window)
    again = OPS.decode_attention_paged_impl(*targs, window=window,
                                            impl="auto")
    assert torch.equal(got, again)
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(a, jdt) if a.dtype == np.float32 else
             jnp.asarray(a) for a in case]
    tol = TOL[dtype]
    for want in (JDA.decode_attention_paged(*jargs, window=window,
                                            interpret=True),
                 JDA.decode_attention_paged_ref(*jargs, window=window)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("blk", [1, 3, 16])
def test_paged_attention_hidden_rows_match_reference(dtype, window, blk):
    """Rows with no visible lane against the reference's Pallas kernel in
    interpret mode and its plain version: kv_len = 0, every lane hidden
    by position (q_pos = -1) and, under the window, every lane older than
    it (q_pos = 40); they average v over all nbs * blk lanes. Pool block
    0 (where unassigned table entries point) and every chain lane past
    kv_len hold 1e4, which the full and partial rows must not weigh."""
    nbs = -(-24 // blk)
    kl = [nbs * blk, 0, 13, 9, 9]
    qp = [nbs * blk - 1, 3, 12, -1, 40]
    case = _paged_case(len(kl), 4, 2, 16, blk, nbs, kl, past=1e4, q_pos=qp)
    targs = [_torch(a, dtype) for a in case]
    got = DA.decode_attention_paged(*targs, window=window)
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(a, jdt) if a.dtype == np.float32 else
             jnp.asarray(a) for a in case]
    tol = TOL[dtype]
    for want in (JDA.decode_attention_paged(*jargs, window=window,
                                            interpret=True),
                 JDA.decode_attention_paged_ref(*jargs, window=window)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_paged_plain_equals_contiguous_plain_on_gathered_chain():
    """Scatter a dense cache into a shuffled pool and read it back through
    the tables: the paged plain version equals the contiguous plain
    version on the dense layout, bit for bit."""
    b, h, kvh, hd, blk, nbs = 2, 4, 2, 32, 4, 6
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    dk = torch.from_numpy(rng.standard_normal(
        (b, nbs * blk, kvh, hd)).astype(np.float32))
    dv = torch.from_numpy(rng.standard_normal(dk.shape).astype(np.float32))
    dpos = torch.arange(nbs * blk, dtype=torch.int32)[None].repeat(b, 1)
    ids = torch.from_numpy(
        rng.permutation(b * nbs).astype(np.int32) + 1).reshape(b, nbs)
    nb = 1 + b * nbs
    pk = torch.zeros((nb, blk, kvh, hd))
    pv = torch.zeros_like(pk)
    ppos = torch.full((nb, blk), -(10 ** 9), dtype=torch.int32)
    pk[ids.long()] = dk.reshape(b, nbs, blk, kvh, hd)
    pv[ids.long()] = dv.reshape(b, nbs, blk, kvh, hd)
    ppos[ids.long()] = dpos.reshape(b, nbs, blk)
    kv_len = torch.tensor([24, 13], dtype=torch.int32)
    q_pos = kv_len - 1
    paged = DA.decode_attention_paged_ref(q, pk, pv, ppos, ids, kv_len,
                                          q_pos)
    dense = DA.decode_attention_ref(q, dk, dv, dpos, kv_len, q_pos)
    assert torch.equal(paged, dense)


# ------------------------------------------------------------ sublayer


@pytest.mark.parametrize("s,counts", [(1, [1, 1, 0]), (4, [4, 2, 0])])
def test_paged_attention_block_matches_reference(s, counts):
    """The paged branch of ``attention_block`` at s = 1 (decode) and
    s = chunk with full, partial and zero new-token counts."""
    cfg, jcfg, jp, tp = _setup()
    pa_j = jax.tree.map(lambda a: a[0], jp["layers"][0]["attn"])
    pa_t = {k: v[0] for k, v in tp["layers"][0]["attn"].items()}
    b, blk, nbs = 3, 3, 5
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    case = _paged_case(b, 1, kvh, hd, blk, nbs, [7, 11, 0], seed=3)
    _, pk, pv, ppos, tab, cl, _ = case
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = (cl[:, None] + np.arange(s, dtype=np.int32)[None]).astype(np.int32)
    counts = np.asarray(counts, np.int32)
    jcache = {"k": jnp.asarray(pk), "v": jnp.asarray(pv),
              "pos": jnp.asarray(ppos)}
    jy, jc = JL.attention_block(pa_j, jcfg, jnp.asarray(x),
                                jnp.asarray(pos), cache=jcache,
                                cache_len=jnp.asarray(cl), impl="ref",
                                block_tables=jnp.asarray(tab),
                                new_counts=jnp.asarray(counts))
    tcache = {"k": torch.from_numpy(pk.copy()),
              "v": torch.from_numpy(pv.copy()),
              "pos": torch.from_numpy(ppos.copy())}
    ty, tc = L.attention_block(pa_t, cfg, torch.from_numpy(x),
                               torch.from_numpy(pos), cache=tcache,
                               cache_len=torch.from_numpy(cl), impl="auto",
                               block_tables=torch.from_numpy(tab),
                               new_counts=torch.from_numpy(counts))
    assert tc["k"] is tcache["k"]                  # written in place
    # the inactive row (count 0, kv_len 0) attends to trash: ignored
    live = counts > 0
    np.testing.assert_allclose(ty.numpy()[live], np.asarray(jy)[live],
                               atol=F32_TOL, rtol=F32_TOL)
    # every block but trash block 0 (whose colliding writes land in no
    # defined order) holds the reference's values: positions exactly,
    # k/v (projections of x, float32 sums in another order) within the
    # tolerance; blocks no row wrote stay bit for bit as they were
    written = np.zeros(pk.shape[0], bool)
    for r in range(b):
        for j in range(counts[r]):
            written[tab[r, (cl[r] + j) // blk]] = True
    written[0] = False
    np.testing.assert_array_equal(tc["pos"].numpy()[1:],
                                  np.asarray(jc["pos"])[1:])
    for k, before in (("k", pk), ("v", pv)):
        got = tc[k].numpy()
        np.testing.assert_allclose(got[1:], np.asarray(jc[k])[1:],
                                   atol=F32_TOL, rtol=F32_TOL)
        keep = ~written
        keep[0] = False
        np.testing.assert_array_equal(got[keep], before[keep])
        assert not np.array_equal(got[written], before[written])


# ------------------------------------------------------------ allocator


def _pools(**kw):
    """The reference's and the port's PagedKVCache on the same knobs."""
    cfg, jcfg, jp, tp = _setup()
    args = (kw.pop("num_slots", 3), kw.pop("max_len", 16))
    return (JPagedKVCache(jcfg, jp, *args, **kw),
            PagedKVCache(cfg, tp, *args, **kw))


def _state(kv):
    pre = kv.prefix
    return {"tables": kv.tables.tolist(), "nblocks": kv.nblocks.tolist(),
            "refcount": kv.refcount.tolist(), "lengths": kv.lengths.tolist(),
            "active": kv.active.tolist(), "owners": kv.owners.tolist(),
            "free": list(kv._free), "free_blocks": list(kv._free_blocks),
            "cow_blocks": kv.cow_blocks,
            "prefix": None if pre is None else (pre.hits, pre.tokens_saved,
                                                pre.evictable())}


def _script(kv):
    """One scripted admission sequence with the prefix cache on: an
    exact-repeat prompt (copy-on-write), pool pressure with eviction,
    holds and an impossible admission. Returns every step's result and
    the pool state after it."""
    p1 = np.arange(1, 11, dtype=np.int32)             # 10 tokens
    p2 = np.arange(50, 62, dtype=np.int32)            # disjoint, 12
    out = []

    def log(x):
        out.append((x, _state(kv)))

    s0 = kv.alloc()
    log(kv.begin(s0, p1, 2, owner=10))
    log(kv.advance(np.array([10, 0, 0], np.int32)))
    log(kv.advance())
    log(kv.release(s0))                               # caches 3 blocks
    s1 = kv.alloc()
    log(kv.begin(s1, p1, 2, owner=11))                # hit 9, COW
    log(kv.can_admit(12, 4, p2))
    s2 = kv.alloc()
    log(kv.begin(s2, p2, 4, owner=12))                # evicts the tail
    log(kv.can_admit(8, 8, p1))                       # held
    log(kv.admission_error(40, 10))
    log(kv.admission_error(20, 4))
    log(kv.advance(np.array([3, 2, 0], np.int32)))
    log(kv.release(s2))
    log(kv.release(s1))
    s3 = kv.alloc()
    log(kv.begin(s3, np.concatenate([p1[:6], p2[:3]]), 3, owner=13))
    log(kv.advance(np.array([0, 0, 9], np.int32)))
    log(kv.release(s3))
    log(kv.prefix.evict(100))
    return out


def test_allocator_script_matches_reference():
    jkv, kv = _pools(block=4, num_blocks=8, prefix_cache=True,
                     chunked=True)
    mine, ref = _script(kv), _script(jkv)
    assert len(mine) == len(ref)
    for i, (m, r) in enumerate(zip(mine, ref)):
        assert m == r, i
    assert kv.cow_blocks == 1 and kv.prefix.hits == 2
    assert kv.used_blocks == 0


def _pins_under_pressure(kv):
    """``begin`` pins the matched chain before evicting: eviction frees
    OTHER chains, and no pool block sits at two table indices."""
    p1 = np.arange(1, 9, dtype=np.int32)
    p2 = np.arange(50, 58, dtype=np.int32)
    for p in (p1, p2):
        s = kv.alloc()
        kv.begin(s, p, max_new=4)
        kv.lengths[s] = 12
        kv.release(s)
    assert kv.free_blocks == 2
    matched, chain = kv.prefix.match(p1)
    assert matched == 8 and len(chain) == 2
    assert kv.can_admit(8, 8, p1)
    s = kv.alloc()
    assert kv.begin(s, p1, max_new=8) == 7
    row = kv.tables[s, :int(kv.nblocks[s])]
    assert len(np.unique(row)) == len(row)
    assert row[0] == chain[0] and kv.refcount[chain[0]] == 2
    assert chain[1] not in row
    assert kv.prefix.match(p1) == (8, chain)


def _holds_when_only_matched_chain_evictable(kv):
    """``can_admit`` does not count the matched chain as headroom; a
    forced ``begin`` raises with its pins rolled back."""
    p = np.arange(1, 9, dtype=np.int32)
    s = kv.alloc()
    kv.begin(s, p, max_new=4)
    kv.lengths[s] = 12
    kv.release(s)
    assert kv.free_blocks == 1
    assert not kv.can_admit(8, 8, p)
    _, chain = kv.prefix.match(p)
    s2 = kv.alloc()
    with pytest.raises(RuntimeError, match="exhausted"):
        kv.begin(s2, p, max_new=8)
    assert [int(kv.refcount[b]) for b in chain] == [1, 1]
    assert kv.free_blocks == 1
    assert kv.prefix.match(p)[1] == chain


def _evict_peels_whole_chain(kv):
    """One ``evict`` call unwinds a cold chain back to front."""
    p = np.arange(1, 13, dtype=np.int32)
    s = kv.alloc()
    kv.begin(s, p, max_new=4)
    kv.lengths[s] = 12
    kv.release(s)
    assert kv.used_blocks == 3
    assert kv.prefix.evict(5) == 3
    assert kv.used_blocks == 0 and kv.prefix.evictable() == 0


@pytest.mark.parametrize("regression,num_slots,num_blocks", [
    (_pins_under_pressure, 3, 7),
    (_holds_when_only_matched_chain_evictable, 2, 4),
    (_evict_peels_whole_chain, 2, 0),
])
def test_allocator_regressions_match_reference(regression, num_slots,
                                            num_blocks):
    """The three allocator regressions that ``tests/test_paged_kv.py``
    pins for the reference, replayed on both packages: each holds, and
    the end states are equal."""
    jkv, kv = _pools(num_slots=num_slots, block=4, num_blocks=num_blocks,
                     prefix_cache=True, chunked=True)
    regression(kv)
    regression(jkv)
    assert _state(kv) == _state(jkv)


def test_block_bytes_match_costmodel_and_reference():
    for block in (4, 16):
        jkv, kv = _pools(num_slots=2, max_len=32, block=block)
        assert kv.block_bytes == kv_bytes_per_block(kv.cfg, block) \
            == jkv.block_bytes
        assert kv.pool_bytes == jkv.pool_bytes


# ------------------------------------------------------------ engine


PREFIX = np.arange(100, 109, dtype=np.int32)      # 9 shared tokens


def _trace(cls, cfg, shared: bool, seed=7):
    """(prompt, max_new, arrival) requests: without `shared` the
    reference's paged-KV trace; with it, a shared 9-token system prompt
    plus unique suffixes, a late exact repeat of request 0 (copy-on-
    write) and a late request on the warm prefix."""
    rng = np.random.default_rng(seed)
    if not shared:
        specs = [(rng.integers(1, cfg.vocab_size, n).astype(np.int32), g, a)
                 for n, g, a in [(7, 6, 0.0), (11, 5, 0.0), (3, 7, 0.1),
                                 (9, 4, 0.2)]]
    else:
        sfx = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 5, 2)]
        p0 = np.concatenate([PREFIX, sfx[0]])
        specs = [(p0, 5, 0.0), (np.concatenate([PREFIX, sfx[1]]), 4, 0.0),
                 (p0.copy(), 5, 10.0),
                 (np.concatenate([PREFIX, sfx[2]]), 6, 10.0)]
    return [cls(rid=i, arrival=a, prompt=p, max_new_tokens=g)
            for i, (p, g, a) in enumerate(specs)]


SPECS = {
    "paged solo": (dict(kv="paged", kv_block=5), False),
    "paged chunked": (dict(kv="paged", kv_block=4, prefill_chunk=4), False),
    "paged chunked prefix": (dict(kv="paged", kv_block=4, prefill_chunk=4,
                                  prefix_cache=True), True),
}


def _serve(pkg: str, spec: dict, shared: bool):
    cfg, jcfg, jp, tp = _setup()
    if pkg == "ref":
        eng = JServingEngine(jcfg, jp, max_len=32,
                             serving=JServingSpec(**spec))
        ctrl = JMoElessController(jcfg, num_devices=4)
        reqs = _trace(JGenRequest, cfg, shared)
    else:
        eng = ServingEngine(cfg, tp, max_len=32, serving=ServingSpec(**spec))
        ctrl = MoElessController(cfg, num_devices=4)
        reqs = _trace(GenRequest, cfg, shared)
    eng.start(num_slots=2, control=ctrl, time_scale=50.0)
    for r in reqs:
        eng.submit(r)
    res = eng.run()
    kv = eng._session.kv
    prefix = None if kv.prefix is None else (kv.prefix.hits,
                                             kv.prefix.tokens_saved)
    out = {
        "tokens": {r.rid: tuple(r.tokens) for r in reqs},
        "hit": [r.prefix_hit_len for r in reqs],
        "records": sorted(map(dataclasses.astuple, res.records)),
        "prefix": prefix, "cow": kv.cow_blocks,
        "phases": dict(ctrl.phase_iterations),
        **{k: getattr(res, k) for k in (
            "iterations", "prefills", "rejected", "cancelled", "clock_s",
            "dropped_tokens", "mean_batch_occupancy")},
    }
    eng.close()
    return out


_serve_ref = functools.lru_cache(maxsize=None)(
    lambda name: _serve("ref", *SPECS[name]))


@pytest.mark.parametrize("name", list(SPECS))
def test_paged_engine_matches_reference(name):
    """Tokens, ServeResult counters, the modeled clock and every
    request's TTFT/TPOT/E2E record equal the reference engine's."""
    mine = _serve("port", *SPECS[name])
    assert mine == _serve_ref(name)
    if SPECS[name][1]:
        assert mine["prefix"][0] == 2 and mine["cow"] == 1
        assert mine["phases"].get("mixed", 0) > 0


def _port_tokens(spec: ServingSpec, shared: bool):
    cfg, _, _, tp = _setup()
    reqs = _trace(GenRequest, cfg, shared)
    ServingEngine(cfg, tp, max_len=32, serving=spec).serve(reqs,
                                                           num_slots=3)
    return {r.rid: tuple(r.tokens) for r in reqs}


@functools.lru_cache(maxsize=None)
def _contiguous(shared: bool):
    return _port_tokens(ServingSpec(), shared)


@pytest.mark.parametrize("block,chunk", [(5, 3), (1, 1), (16, 8), (3, 7)])
def test_port_layouts_give_identical_tokens(block, chunk):
    """Within the port: contiguous == paged solo == paged chunked ==
    prefix-warm greedy tokens, bit for bit, per (block, chunk)."""
    for shared in (False, True):
        base = _contiguous(shared)
        assert _port_tokens(ServingSpec(kv="paged", kv_block=block),
                            shared) == base
        assert _port_tokens(ServingSpec(kv="paged", kv_block=block,
                                        prefill_chunk=chunk),
                            shared) == base
    assert _port_tokens(ServingSpec(kv="paged", kv_block=block,
                                    prefill_chunk=chunk, prefix_cache=True),
                        True) == _contiguous(True)
