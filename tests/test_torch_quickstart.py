"""PyTorch port, ``launch/quickstart.py`` against the reference's steps
(``examples/quickstart.py:28-75``) rebuilt from ``repro`` modules, on the
reference's float32 weights (mixtral-8x7b smoke config at 2 layers, 20
fine-tuning steps):

* exact: the gate batches (``prng.randint`` against
  ``jax.random.randint``), the accuracies before fine-tuning, the
  fine-tuned layers, every handle's tokens (greedy and sampled), the
  streamed tokens, the records (but their wall-clock latencies: the
  engine-level controller leaves the session clock on the wall), the
  cancelled count, the controller's plans, replica counts and modeled
  layer latencies, and the three cost-model numbers;
* allclose at atol = rtol = 1e-4 (``test_torch_predictor.py::
  test_finetune_matches_reference``'s tolerance): the accuracies after
  fine-tuning and the fine-tuned weights.

``main`` runs on the CPU with ``--device cpu`` and raises without a card
by default.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import costmodel as JCM
from repro.core import predictor as JP
from repro.core.placer import place_layer as jplace_layer
from repro.core.plan import static_plan as jstatic_plan
from repro.core.scaler import scale_layer as jscale_layer
from repro.models import model as JM
from repro.serving.engine import MoElessController as JMoElessController
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.scheduler import GenRequest as JGenRequest
from repro.serving.scheduler import SamplingParams as JSamplingParams
from repro_torch.configs import get_config
from repro_torch.launch import quickstart as Q
from repro_torch.params import from_jax

torch.set_num_threads(1)

TOL = 1e-4          # atol = rtol, float32
LAYERS, STEPS = 2, 20


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = get_config("mixtral-8x7b", smoke=True).with_(
        dtype="float32", num_layers=LAYERS)
    jcfg = jget_config("mixtral-8x7b", smoke=True).with_(
        dtype="float32", impl="ref", num_layers=LAYERS)
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


def _reference(jcfg, jp, steps=STEPS):
    """The reference script's steps 1-4 on `jp`."""
    key = jax.random.PRNGKey(0)
    batches = [jax.random.randint(jax.random.fold_in(key, i), (4, 64), 0,
                                  jcfg.vocab_size) for i in range(4)]
    ds = JP.collect_gate_dataset(jcfg, jp, batches)
    train, test = JP.split_dataset(ds)
    pred = JP.from_gates(jcfg, jp, distance=1)
    acc0 = JP.profile_accuracy(pred, test, jcfg.moe.top_k)
    pred = JP.finetune(pred, train, test, jcfg.moe.top_k, threshold=0.8,
                       steps=steps)
    acc1 = JP.profile_accuracy(pred, test, jcfg.moe.top_k)

    ctrl = JMoElessController(jcfg, num_devices=8, predictor=pred)
    engine = JServingEngine(jcfg, jp, max_len=64, controller=ctrl)
    rng = np.random.default_rng(0)
    engine.start(num_slots=4)
    handles = [engine.submit(JGenRequest(
        rid=i, arrival=0.0,
        prompt=rng.integers(0, jcfg.vocab_size, size=16, dtype=np.int32),
        max_new_tokens=12,
        sampling=JSamplingParams(temperature=0.8, top_k=16, seed=i)
        if i % 2 else JSamplingParams()))
        for i in range(8)]
    streamed = list(engine.stream(handles[0]))
    engine.cancel(handles[-1])
    res = engine.run()
    assert streamed == handles[0].tokens

    coeffs = JCM.derive_coeffs(jcfg)
    sp = jstatic_plan(jcfg.moe.num_experts, 8)
    loads = np.array([1000.0, 40, 30, 30])
    reps = jscale_layer(loads, cv_threshold=0.2, max_total_replicas=8)
    mp = jplace_layer(loads, reps, 8)
    t_static = JCM.layer_forward_time(sp, loads, coeffs)
    t_moeless = JCM.layer_forward_time(mp, loads, coeffs)
    return dict(batches=batches, acc0=acc0, acc1=acc1, pred=pred, ctrl=ctrl,
                tokens=[[int(t) for t in h.tokens] for h in handles],
                streamed=[int(t) for t in streamed], result=res,
                t_static=t_static, t_moeless=t_moeless)


@functools.lru_cache(maxsize=None)
def _both():
    cfg, jcfg, jp, tp = _setup()
    lines = []
    mine = Q.run(cfg, tp, finetune_steps=STEPS, log=lines.append)
    return mine, _reference(jcfg, jp), lines


def test_gate_batches_equal_reference():
    cfg = _setup()[0]
    got = Q.gate_batches(cfg.vocab_size)
    key = jax.random.PRNGKey(0)
    for i, b in enumerate(got):
        want = np.asarray(jax.random.randint(jax.random.fold_in(key, i),
                                             (4, 64), 0, cfg.vocab_size))
        assert b.dtype == torch.int32 and tuple(b.shape) == (4, 64)
        np.testing.assert_array_equal(b.numpy(), want)
    # another seed draws other tokens
    assert not torch.equal(Q.gate_batches(cfg.vocab_size, 1)[0], got[0])


def test_predictor_matches_reference():
    mine, ref, _ = _both()
    np.testing.assert_array_equal(mine.acc_before, ref["acc0"])
    assert mine.finetuned_layers == ref["pred"].finetuned_layers
    assert mine.finetuned_layers, "nothing was fine-tuned"
    np.testing.assert_allclose(mine.acc_after, ref["acc1"], atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(mine.predictor.weights.numpy(),
                               np.asarray(ref["pred"].weights), atol=TOL,
                               rtol=TOL)


def test_serving_matches_reference():
    mine, ref, _ = _both()
    assert mine.tokens == ref["tokens"]
    assert mine.streamed == ref["streamed"] == mine.tokens[0]
    res, jres = mine.result, ref["result"]
    assert res.cancelled == jres.cancelled == 1
    assert len(res.records) == len(jres.records) == 7
    # the engine-level controller leaves the session clock on the wall,
    # so a record's id, arrival, prompt and output lengths are compared,
    # not its latencies
    rows = lambda rs: sorted(dataclasses.astuple(r)[:4]        # noqa: E731
                             for r in rs)
    assert rows(res.records) == rows(jres.records)
    for k in ("iterations", "prefills"):
        assert getattr(res, k) == getattr(jres, k), k
    # the fine-tuned predictor planned the same replicas
    ctrl, jctrl = mine.controller, ref["ctrl"]
    assert ctrl.iterations == jctrl.iterations > 0
    assert ctrl.host_transfers == jctrl.host_transfers == ctrl.iterations
    assert ctrl.replica_counts == jctrl.replica_counts
    assert ctrl.layer_latency == jctrl.layer_latency
    for a, b in zip(ctrl.plans, jctrl.plans):
        np.testing.assert_array_equal(a.replicas, b.replicas)
        assert a.placement == b.placement
    # every request but the cancelled one reached its budget
    assert all(len(t) == Q.MAX_NEW for t in mine.tokens[:-1])


def test_cost_model_matches_reference():
    mine, ref, _ = _both()
    assert mine.t_static == ref["t_static"]
    assert mine.t_moeless == ref["t_moeless"]
    assert mine.reduction == 1 - ref["t_moeless"] / ref["t_static"]
    np.testing.assert_array_equal(Q.skewed_loads(4), [1000.0, 40, 30, 30])
    assert Q.skewed_loads(8).tolist() == [1000.0, 40, 30, 30, 40, 30, 30,
                                          40]
    # at 8 experts the plan holds 16 replicas, so the skewed expert gets
    # some and the MoEless layer is faster than static EP's
    wide = get_config("mixtral-8x7b", smoke=True).with_(
        moe=dataclasses.replace(_setup()[0].moe, num_experts=8))
    t_static, t_moeless = Q.cost_model(wide)
    assert t_moeless < t_static


def test_run_logs_the_reference_lines():
    mine, ref, lines = _both()
    assert len(lines) == 3
    assert lines[0].startswith("predictor accuracy per layer: ")
    assert lines[1] == (f"served 7 requests (1 cancelled), streamed request "
                        f"0 token-by-token: {ref['streamed']}")
    assert lines[2].startswith("layer forward on skewed load: static=")


def test_main_on_the_cpu(capsys):
    out = Q.main(["--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 3
    assert "(fine-tuned layers: " in printed[0]
    assert printed[1].startswith("served 7 requests (1 cancelled)")
    assert "moeless=" in printed[2] and "(-" in printed[2]
    assert out.result.cancelled == 1 and len(out.acc_before) == 4


def test_main_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Q.main([])
