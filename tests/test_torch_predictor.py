"""PyTorch port, the expert load predictor (``core/predictor.py``) against
the JAX reference on the reference's float32 weights (mixtral-8x7b smoke
config, 6 and 4 layers), and the serving engine with the predictor
attached to the session controller.

Exact: ``prng.split`` and ``prng.randint`` (bit for bit), ``from_gates``
weights and ``param_bytes``, ``predict_loads`` and
``predict_loads_all`` for distance 0, 1 and 2 with and without a token
mask (a planted tie between two equal weight columns pins the order:
lower index first), ``split_dataset``, the accuracy and correlation
functions, ``finetune``'s choice of layers; in the engine, tokens
(greedy and sampled), the controller's iterations, host transfers,
replica counts, plans, modeled clock and cost, and the runtime's meters.
Allclose (atol = rtol = 1e-4): ``predict_logits``, the collected gate
inputs and router logits, and the weights after 20 fine-tuning steps.
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
from repro.core import predictor as JP
from repro.core.control import MoElessController as JMoElessController
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.scheduler import GenRequest as JGenRequest
from repro.serving.scheduler import SamplingParams as JSamplingParams
from repro_torch.configs import ServingSpec, get_config
from repro_torch.core import predictor as P
from repro_torch.core.control import MoElessController
from repro_torch.models import prng
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import GenRequest, SamplingParams

torch.set_num_threads(1)

TOL = 1e-4      # atol = rtol, float32


@functools.lru_cache(maxsize=None)
def _setup(num_layers=6, cf=None):
    """Float32 mixtral smoke configs of both packages at `num_layers`
    (and capacity factor `cf`), the reference's weights in both forms
    (read-only)."""
    cfg = get_config("mixtral-8x7b", smoke=True).with_(
        dtype="float32", num_layers=num_layers)
    jcfg = jget_config("mixtral-8x7b", smoke=True).with_(
        dtype="float32", impl="ref", num_layers=num_layers)
    if cf is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe,
                                                  capacity_factor=cf))
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(3))
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


@functools.lru_cache(maxsize=None)
def _datasets():
    """Both packages' gate datasets over 3 batches of (4, 48) tokens,
    and the reference's 7:3 split."""
    cfg, jcfg, jp, tp = _setup()
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size, (4, 48), dtype=np.int32)
               for _ in range(3)]
    jds = JP.collect_gate_dataset(jcfg, jp, [jnp.asarray(b)
                                             for b in batches])
    tds = P.collect_gate_dataset(cfg, tp, batches)
    return jds, tds, JP.split_dataset(jds)


def _predictors(distance, planted_tie=False):
    cfg, jcfg, jp, tp = _setup()
    jpred = JP.from_gates(jcfg, jp, distance)
    pred = P.from_gates(cfg, tp, distance)
    if planted_tie:
        # every layer: columns 0 and 3 equal, so the two logits tie
        # exactly for every token
        w = np.asarray(jpred.weights).copy()
        w[:, :, 3] = w[:, :, 0]
        jpred = JP.LoadPredictor(distance, jnp.asarray(w))
        pred = P.LoadPredictor(distance, torch.from_numpy(w))
    return cfg, jpred, pred


def test_from_gates_weights_and_bytes():
    cfg, jpred, pred = _predictors(1)
    lm, d, e = cfg.num_layers, cfg.d_model, cfg.moe.num_experts
    assert pred.weights.dtype == torch.float32
    np.testing.assert_array_equal(pred.weights.numpy(),
                                  np.asarray(jpred.weights))
    assert pred.num_layers == jpred.num_layers == lm
    assert pred.param_bytes == jpred.param_bytes == lm * d * e * 4


def test_predict_logits_and_loads_match():
    jds, tds, (train, test) = _datasets()
    cfg, jpred, pred = _predictors(1)
    k = cfg.moe.top_k
    for l in range(1, cfg.num_layers):
        hid = test["inputs"][l - 1]
        np.testing.assert_allclose(
            pred.predict_logits(l, hid).numpy(),
            np.asarray(jpred.predict_logits(l, jnp.asarray(hid))),
            atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(
            pred.predict_loads(l, hid, k),
            jpred.predict_loads(l, jnp.asarray(hid), k))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("distance", [0, 1, 2])
def test_predict_loads_all_matches(distance, tie, masked):
    cfg, jpred, pred = _predictors(distance, planted_tie=tie)
    lm, d, e, k = (cfg.num_layers, cfg.d_model, cfg.moe.num_experts,
                   cfg.moe.top_k)
    rng = np.random.default_rng(distance)
    gi = rng.standard_normal((lm, 13, d)).astype(np.float32)
    actual = rng.integers(0, 9, (lm, e)).astype(np.int32)
    mask = (np.arange(13) % 3 != 1) if masked else None
    want = np.asarray(jpred.predict_loads_all(
        jnp.asarray(gi), jnp.asarray(actual), k,
        token_mask=None if mask is None else jnp.asarray(mask)))
    got = pred.predict_loads_all(
        torch.from_numpy(gi), torch.from_numpy(actual), k,
        token_mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (lm, e)
    np.testing.assert_array_equal(got.numpy(), want)
    n_tok = int(mask.sum()) if masked else 13
    for l in range(distance, lm):
        assert want[l].sum() == n_tok * k
        if tie:   # column 3 is chosen only beside its equal, column 0
            assert want[l, 0] >= want[l, 3]
        np.testing.assert_array_equal(
            pred.predict_loads(l, gi[l - distance][mask if masked
                                                   else slice(None)], k),
            want[l])
    np.testing.assert_array_equal(got.numpy()[:distance], actual[:distance])
    if tie:   # the tie sat at the top-k boundary for some token: the lower
        # index won it
        assert want[distance:, 0].sum() > want[distance:, 3].sum()


def test_collect_and_split_dataset_match():
    jds, tds, (jtrain, jtest) = _datasets()
    cfg = _setup()[0]
    assert tds["inputs"].dtype == tds["logits"].dtype == np.float32
    assert tds["inputs"].shape == (cfg.num_layers, 3 * 4 * 48, cfg.d_model)
    assert tds["logits"].shape == (cfg.num_layers, 3 * 4 * 48,
                                   cfg.moe.num_experts)
    for key in ("inputs", "logits"):
        np.testing.assert_allclose(tds[key], jds[key], atol=TOL, rtol=TOL)
    train, test = P.split_dataset(jds)
    for a, b in ((train, jtrain), (test, jtest)):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_accuracy_correlation_and_profile_match():
    _, _, (train, test) = _datasets()
    cfg = _setup()[0]
    k = cfg.moe.top_k
    for distance in (1, 2):
        _, jpred, pred = _predictors(distance)
        acc = P.profile_accuracy(pred, test, k)
        assert acc.tolist() == JP.profile_accuracy(jpred, test, k).tolist()
        for l in range(distance, cfg.num_layers):
            hid, true = test["inputs"][l - distance], test["logits"][l]
            assert P.topk_overlap_accuracy(pred.predict_logits(l, hid),
                                           true, k) == \
                JP.topk_overlap_accuracy(jpred.predict_logits(
                    l, jnp.asarray(hid)), jnp.asarray(true), k)
            pl = pred.predict_loads(l, hid, k)
            actual = np.bincount(np.argsort(-true, axis=-1, kind="stable")
                                 [:, :k].reshape(-1), minlength=4)
            assert P.load_correlation(pl, actual) == \
                JP.load_correlation(pl, actual)
    # same-layer replicas reproduce the router (paper §4.1, d = 0)
    _, _, pred = _predictors(0)
    assert P.profile_accuracy(pred, test, k).min() == 1.0


def test_finetune_matches_reference():
    _, _, (train, test) = _datasets()
    cfg = _setup()[0]
    _, jpred, pred = _predictors(2)
    kw = dict(threshold=0.9, steps=20)
    jft = JP.finetune(jpred, train, test, cfg.moe.top_k, **kw)
    ft = P.finetune(pred, train, test, cfg.moe.top_k, **kw)
    assert ft.finetuned_layers and \
        ft.finetuned_layers == jft.finetuned_layers
    assert ft.distance == 2
    np.testing.assert_allclose(ft.weights.numpy(), np.asarray(jft.weights),
                               atol=TOL, rtol=TOL)
    untouched = [l for l in range(cfg.num_layers)
                 if l not in ft.finetuned_layers]
    assert torch.equal(ft.weights[untouched], pred.weights[untouched])


# ------------------------------------------------------------ prng

SEEDS = [0, 7, 123456, -5, 2 ** 31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_split_matches_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
    for num in (2, 3, 5):
        np.testing.assert_array_equal(
            prng.split(tk, num).numpy(),
            np.asarray(jax.random.split(jk, num)).astype(np.int64))
    # a batch of keys splits row by row
    keys = prng.key(torch.tensor([seed, seed + 1]))
    np.testing.assert_array_equal(prng.split(keys)[1].numpy(),
                                  prng.split(prng.key(seed + 1)).numpy())


@pytest.mark.parametrize("n,lo,hi", [
    (1024, 0, 5734),           # finetune's draw: a span not a power of 2
    (7, 3, 10),                # minval > 0
    (100, 0, 1),               # a span of 1
    (64, 5, 5),                # an empty range returns minval
    (33, -4, 2 ** 31 - 1),     # a span above 2^31
    (50, 0, 3 * 65536 + 7),    # above 2^16: the uint32 square wraps
    (20, 0, 65536), (20, 0, 65535), (20, 1, 65538),
    (9, -2 ** 31, 2 ** 31 - 1)])
@pytest.mark.parametrize("seed", SEEDS)
def test_prng_randint_matches_jax(seed, n, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (n,), lo,
                                         hi))
    got = prng.randint(prng.key(seed), n, lo, hi)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ engine

TRACE = [(5, 6, 0.0), (9, 3, 0.0), (3, 8, 0.0), (12, 5, 0.0),
         (7, 4, 1e-3), (4, 7, 2e-3)]


def _reqs(req_cls, samp_cls, cfg, seed=9):
    rng = np.random.default_rng(seed)
    return [req_cls(rid=i, arrival=a,
                    prompt=rng.integers(0, cfg.vocab_size, size=n,
                                        dtype=np.int32),
                    max_new_tokens=m,
                    sampling=samp_cls(temperature=0.8, top_p=0.9, seed=i)
                    if i % 2 else samp_cls())
            for i, (n, m, a) in enumerate(TRACE)]


def _serve(pkg, spec, runtime, predictor=True):
    cf = float(4) if runtime == "on" else None
    cfg, jcfg, jp, tp = _setup(4, cf)
    # E slots a device: no device ever holds more than E instances, so no
    # slot allocation can fail (the default 3 fill up in this trace)
    slots = cfg.moe.num_experts if runtime == "on" else 0
    if pkg == "jax":
        mesh = jax.make_mesh((1, 1, 1), ("data", "ep", "tp"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 3) \
            if runtime == "on" else None
        ctrl = JMoElessController(
            jcfg, num_devices=4, slots_per_device=slots,
            predictor=JP.from_gates(jcfg, jp, 1) if predictor else None)
        eng = JServingEngine(jcfg, jp, max_len=24, expert_runtime=runtime,
                             mesh=mesh, serving=JServingSpec(
                                 **dataclasses.asdict(spec)))
        reqs = _reqs(JGenRequest, JSamplingParams, cfg)
    else:
        ctrl = MoElessController(
            cfg, num_devices=4, slots_per_device=slots,
            predictor=P.from_gates(cfg, tp, 1) if predictor else None)
        eng = ServingEngine(cfg, tp, max_len=24, expert_runtime=runtime,
                            serving=spec)
        reqs = _reqs(GenRequest, SamplingParams, cfg)
    res = eng.serve(reqs, num_slots=3, control=ctrl, time_scale=50.0)
    return reqs, res, ctrl


PATHS = {"contiguous": (ServingSpec(), "off"),
         "paged_chunked": (ServingSpec(kv="paged", kv_block=4,
                                       prefill_chunk=5), "off"),
         "runtime_on": (ServingSpec(), "on")}


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_with_predictor_matches_reference(path):
    spec, runtime = PATHS[path]
    jreqs, jres, jctrl = _serve("jax", spec, runtime)
    reqs, res, ctrl = _serve("torch", spec, runtime)
    assert [list(r.tokens) for r in reqs] == [list(r.tokens) for r in jreqs]
    for k in ("iterations", "prefills", "clock_s", "dropped_tokens",
              "mean_batch_occupancy"):
        assert getattr(res, k) == getattr(jres, k), k
    rows = lambda rs: sorted(map(dataclasses.astuple, rs))     # noqa: E731
    assert rows(res.records) == rows(jres.records)
    assert ctrl.iterations == jctrl.iterations >= res.iterations
    assert ctrl.phase_iterations == jctrl.phase_iterations
    assert ctrl.host_transfers == jctrl.host_transfers == ctrl.iterations
    assert ctrl.replica_counts == jctrl.replica_counts
    assert ctrl.layer_latency == jctrl.layer_latency
    assert ctrl.cost == jctrl.cost
    for mine, ref in zip(ctrl.plans + ctrl.last_plans,
                         jctrl.plans + jctrl.last_plans):
        np.testing.assert_array_equal(mine.replicas, ref.replicas)
        assert mine.placement == ref.placement
    if runtime == "on":
        st = dataclasses.asdict(res.runtime.finalize(res.clock_s))
        assert st == dataclasses.asdict(jres.runtime.finalize(jres.clock_s))
        assert st["transfers"] > 0
    # the predictor is in the loop: the oracle controller (actual loads
    # as the prediction) plans differently somewhere, tokens unchanged
    # off the runtime
    oreqs, ores, octrl = _serve("torch", spec, runtime, predictor=False)
    assert (octrl.replica_counts, octrl.layer_latency) != \
        (ctrl.replica_counts, ctrl.layer_latency)
    if runtime == "off":
        assert [r.tokens for r in oreqs] == [r.tokens for r in reqs]
