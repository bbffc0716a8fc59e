"""PyTorch port, sampling and the fixed-batch API: the threefry bits,
uniform and Gumbel draws of ``repro_torch.models.prng`` against
``jax.random``'s, ``sample_tokens`` against the reference's, the
engine's sampled tokens against the reference engine's (contiguous, and
paged with chunked prefill), the port's own sampling identities
(temperature 0 == greedy, seeded determinism, batched == sequential),
and ``prefill``/``decode`` against the reference's batch API.

Everything here is exact: integer bits, float32 draws compared bit for
bit, and tokens. The reference runs on the CPU with threefry2x32
(``tests/conftest.py``), where its float32 log is XLA's Cephes
polynomial, which ``prng.log`` reproduces.
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
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.scheduler import GenRequest as JGenRequest
from repro.serving.scheduler import SamplingParams as JSamplingParams
from repro_torch.configs import ServingSpec, get_config
from repro_torch.core.control import MoElessController
from repro_torch.models import prng
from repro_torch.models import transformer as T
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import GenRequest, SamplingParams

torch.set_num_threads(1)

# 0, small, negative int32, the int32 extremes, and Python ints past
# int32 (PRNGKey keeps their low 32 bits)
SEEDS = [0, 1, -1, 7, 2**31 - 1, -2**31, 2**31, 2**32 + 5]
COUNTS = [0, 1, 2, 17, 999, 1000]


def _bits32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32).view(np.uint32)


# ----------------------------------------------------------------- prng


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_draws_match_jax(seed):
    """Key words, 32-bit bits, uniform and Gumbel draws of
    fold_in(PRNGKey(seed), n) equal jax's bit for bit; every n rides one
    batched call (one key per row)."""
    n_draw = 257
    keys = prng.fold_in(prng.key(torch.full((len(COUNTS),), seed,
                                            dtype=torch.int64)),
                        torch.tensor(COUNTS))
    bits = prng.random_bits(keys, n_draw).numpy()
    uni = prng.uniform(keys, n_draw).numpy()
    gum = prng.gumbel(keys, n_draw).numpy()
    for i, n in enumerate(COUNTS):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), n)
        np.testing.assert_array_equal(
            keys[i].numpy(), np.asarray(jax.random.key_data(jk)))
        np.testing.assert_array_equal(
            bits[i], np.asarray(jax.random.bits(jk, (n_draw,), jnp.uint32)))
        np.testing.assert_array_equal(
            _bits32(uni[i]),
            _bits32(jax.random.uniform(jk, (n_draw,), jnp.float32)))
        np.testing.assert_array_equal(
            _bits32(gum[i]),
            _bits32(jax.random.gumbel(jk, (n_draw,), jnp.float32)))


def test_prng_log_matches_reference_cpu_log():
    """``prng.log`` equals the reference's float32 log over the Gumbel
    draw's whole range: (0, 1) and -log of it, up to ~87.3."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.random(50_000, dtype=np.float32),
        np.exp2(-rng.uniform(0, 126, 20_000)).astype(np.float32),
        rng.uniform(0, 90, 20_000).astype(np.float32),
        np.float32([1.1754944e-38, 1 - 2**-24, 1 - 2**-23, 1.0, 87.33655])])
    x = x[x > 0]
    np.testing.assert_array_equal(
        _bits32(prng.log(torch.from_numpy(x))),
        _bits32(jax.jit(jnp.log)(x)))


# ------------------------------------------------------- sample_tokens


def _logits(kind: str, b: int, v: int, rng):
    lg = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    if kind == "tied":          # many exact ties, the argsort's stability
        lg = np.round(lg / 2)
    elif kind == "padded":      # _lm_head's -1e9 bias on a padded vocab
        lg[:, v - 84:] += np.float32(-1e9)
    return lg


@pytest.mark.parametrize("kind", ["normal", "tied", "padded", "bfloat16"])
def test_sample_tokens_matches_reference(kind):
    """Every row of a grid of temperature (0 beside > 0), top_k (0, 1,
    50, above V), top_p (1, 0.95, 0.1), seeds and step counts gives the
    reference's token, in one batched call per side."""
    v = 384
    grid = [(t, k, p) for t in (0.0, 0.5, 0.8, 1.3)
            for k in (0, 1, 50, v + 5) for p in (1.0, 0.95, 0.1)]
    rng = np.random.default_rng(len(kind))
    b = len(grid)
    lg = _logits(kind, b, v, rng)
    t, k, p = (np.asarray(c, dt) for c, dt in zip(
        zip(*grid), (np.float32, np.int32, np.float32)))
    seed = rng.integers(-2**31, 2**31, b).astype(np.int32)
    step = rng.integers(0, 1000, b).astype(np.int32)
    jlg = jnp.asarray(lg)
    tlg = torch.from_numpy(lg)
    if kind == "bfloat16":
        jlg, tlg = jlg.astype(jnp.bfloat16), tlg.to(torch.bfloat16)
    want = np.asarray(JT.sample_tokens(jlg, *map(jnp.asarray,
                                                 (t, k, p, seed, step))))
    got = T.sample_tokens(tlg, *map(torch.from_numpy,
                                    (t, k, p, seed, step)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # greedy rows are the argmax, bit-identical to greedy decoding
    greedy = t <= 0
    np.testing.assert_array_equal(got.numpy()[greedy],
                                  torch.argmax(tlg, -1).numpy()[greedy])


# ------------------------------------------------------------- engines


@functools.lru_cache(maxsize=None)
def _setup(cf):
    """Float32 mixtral smoke configs of both packages at capacity
    factor `cf`, with the reference's weights in both forms
    (read-only)."""
    cfg = get_config("mixtral-8x7b", smoke=True).with_(dtype="float32")
    jcfg = jget_config("mixtral-8x7b", smoke=True).with_(dtype="float32",
                                                         impl="ref")
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(11))
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


def _reqs(req_cls, samp_cls, vocab, spec, seed=3):
    """spec rows: (prompt_len, max_new_tokens, arrival, temperature,
    top_k, top_p, seed or None)."""
    rng = np.random.default_rng(seed)
    return [req_cls(rid=i, arrival=float(a),
                    prompt=rng.integers(0, vocab, size=pl, dtype=np.int32),
                    max_new_tokens=n,
                    sampling=samp_cls(temperature=t, top_k=k, top_p=p,
                                      seed=s))
            for i, (pl, n, a, t, k, p, s) in enumerate(spec)]


# greedy and sampled requests in one pool, more requests than slots,
# one arriving mid-run, one with a derived seed (its rid)
MIXED = [(5, 6, 0.0, 0.8, 50, 0.95, 7), (9, 5, 0.0, 0.0, 0, 1.0, None),
         (3, 8, 0.0, 1.3, 0, 0.95, -3), (12, 5, 0.0, 0.7, 8, 1.0, None),
         (7, 4, 1e-3, 0.9, 0, 0.1, 2**31 - 1), (4, 7, 0.0, 0.0, 5, 0.5, 1)]


@pytest.mark.parametrize("layout", ["contiguous", "paged-chunked"])
def test_sampled_serve_matches_reference(layout):
    """A session of greedy and sampled requests gives the reference
    engine's tokens, finish reasons, counters and modeled-clock records,
    with the solo-prefill first token (contiguous) and the chunked
    first token (paged)."""
    cfg, jcfg, jp, tp = _setup(1.25)
    kw = {}
    if layout == "paged-chunked":
        kw = {"kv": "paged", "kv_block": 4, "prefill_chunk": 5}
    out = []
    for eng_cls, req_cls, samp_cls, ctrl_cls, spec_cls, c, p in (
            (JServingEngine, JGenRequest, JSamplingParams,
             JMoElessController, JServingSpec, jcfg, jp),
            (ServingEngine, GenRequest, SamplingParams, MoElessController,
             ServingSpec, cfg, tp)):
        reqs = _reqs(req_cls, samp_cls, cfg.vocab_size, MIXED)
        res = eng_cls(c, p, max_len=24, serving=spec_cls(**kw)).serve(
            reqs, num_slots=3, control=ctrl_cls(c, num_devices=4),
            time_scale=50.0)
        out.append(({r.rid: list(map(int, r.tokens)) for r in reqs},
                    [r.finish_reason for r in reqs],
                    (res.iterations, res.prefills, res.clock_s),
                    sorted(map(dataclasses.astuple, res.records))))
    assert out[1] == out[0]
    assert any(len(set(t)) > 1 for t in out[1][0].values())


def test_batch_api_matches_reference():
    """``prefill``/``decode`` (greedy, fixed batch) give the reference's
    tokens and cache length, with the controller driven per call."""
    cfg, jcfg, jp, tp = _setup(1.25)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(3, 6), dtype=np.int32)
    jeng = JServingEngine(jcfg, jp, max_len=20,
                          controller=JMoElessController(jcfg))
    jtok, jcache, jlen = jeng.prefill({"tokens": jnp.asarray(prompts)})
    jout, _, jlen2 = jeng.decode(jtok, jcache, jlen, 5)
    eng = ServingEngine(cfg, tp, max_len=20,
                        controller=MoElessController(cfg))
    tok, cache, clen = eng.prefill({"tokens": prompts})
    out, _, clen2 = eng.decode(tok, cache, clen, 5)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert (clen, clen2, eng.iteration) == (jlen, jlen2, jeng.iteration)
    assert eng.controller.iterations == jeng.controller.iterations


# ------------------------------------- the port's sampling identities


def test_temperature_zero_requests_match_greedy_batch_api():
    """Requests with SamplingParams(temperature=0) generate exactly the
    fixed-batch greedy API's tokens, one request at a time."""
    cfg, _, _, tp = _setup(float(4))
    reqs = _reqs(GenRequest, SamplingParams, cfg.vocab_size,
                 [(5, 5, 0.0, 0.0, 0, 1.0, None),
                  (8, 4, 0.0, 0.0, 0, 1.0, None)])
    eng = ServingEngine(cfg, tp, max_len=32)
    want = []
    for req in reqs:
        tok, cache, clen = eng.prefill({"tokens": req.prompt[None]})
        out, _, _ = eng.decode(tok, cache, clen, req.max_new_tokens - 1)
        want.append([int(tok[0])] + out[0].tolist())
    ServingEngine(cfg, tp, max_len=32).serve(reqs, num_slots=2)
    assert [list(r.tokens) for r in reqs] == want


def test_seeded_sampling_deterministic_across_runs():
    cfg, _, _, tp = _setup(float(4))

    def run(seed):
        reqs = _reqs(GenRequest, SamplingParams, cfg.vocab_size,
                     [(5, 6, 0.0, 0.9, 32, 1.0, seed),
                      (6, 6, 0.0, 0.9, 32, 1.0, seed),
                      (4, 6, 0.5, 0.9, 32, 1.0, seed)])
        ServingEngine(cfg, tp, max_len=32).serve(reqs, num_slots=2)
        return [list(r.tokens) for r in reqs]

    assert run(7) == run(7)
    assert run(7) != run(8)


def test_seed_outside_int32_keeps_its_low_bits():
    """A seed a client may send outside int32 serves (the reference's
    int32 slot array would overflow), sampling as PRNGKey does: with
    the seed's low 32 bits."""
    cfg, _, _, tp = _setup(float(4))

    def run(seed):
        reqs = _reqs(GenRequest, SamplingParams, cfg.vocab_size,
                     [(5, 6, 0.0, 0.9, 0, 1.0, seed),
                      (7, 6, 0.0, 0.9, 0, 1.0, seed + 1)])
        ServingEngine(cfg, tp, max_len=32).serve(reqs, num_slots=2)
        return [list(r.tokens) for r in reqs]

    assert run(2**40 + 3) == run(3)
    assert run(2**31) == run(-2**31)


@pytest.mark.parametrize("layout", ["contiguous", "paged-chunked"])
def test_sampled_batched_matches_sequential(layout):
    """Keys fold per request (seed, token index), not per slot or batch:
    continuous batching samples the tokens of one-at-a-time decoding at
    the drop-free capacity factor."""
    cfg, _, _, tp = _setup(float(4))
    spec = ServingSpec()
    if layout == "paged-chunked":
        spec = ServingSpec(kv="paged", kv_block=4, prefill_chunk=3)
    rows = [(5, 5, 0.0, 0.8, 16, 1.0, 100), (9, 4, 0.0, 0.8, 0, 0.9, 101),
            (3, 6, 1.0, 1.1, 16, 0.95, 102)]
    seq = _reqs(GenRequest, SamplingParams, cfg.vocab_size, rows)
    eng = ServingEngine(cfg, tp, max_len=32, serving=spec)
    for q in seq:
        eng.serve([q], num_slots=1)
    bat = _reqs(GenRequest, SamplingParams, cfg.vocab_size, rows)
    res = ServingEngine(cfg, tp, max_len=32, serving=spec).serve(
        bat, num_slots=2)
    assert res.mean_batch_occupancy > 1.0
    assert [list(q.tokens) for q in bat] == [list(q.tokens) for q in seq]


def test_session_sampling_args_are_the_slot_arrays():
    """``sampling_args`` hands ``sample_tokens`` each slot's bound
    temperature, top-k, top-p, seed (its low 32 bits) and count, with
    their dtypes, from the one buffer they share."""
    cfg, _, _, tp = _setup(float(4))
    eng = ServingEngine(cfg, tp, max_len=32)
    eng.start(num_slots=3)
    sess = eng._session
    reqs = _reqs(GenRequest, SamplingParams, cfg.vocab_size,
                 [(5, 6, 0.0, 0.8, 50, 0.95, 2**40 + 3),
                  (4, 6, 0.0, 1.3, 0, 0.1, -7)])
    for slot, r in zip((2, 0), reqs):
        sess.bind_slot(slot, r)
    sess.count[2] += 5
    want = ([1.3, 0.0, 0.8], [0, 0, 50], [0.1, 1.0, 0.95],
            [2**32 - 7, 0, 3], [0, 0, 5])
    dtypes = (torch.float32, torch.int32, torch.float32, torch.int64,
              torch.int32)
    for got, w, d in zip(sess.sampling_args("cpu"), want, dtypes):
        assert got.dtype == d
        assert torch.equal(got, torch.tensor(w, dtype=d))
    eng.close()
