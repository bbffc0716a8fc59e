"""Quickstart of the PyTorch port: the MoEless pipeline end to end on a
reduced Mixtral, the counterpart of ``examples/quickstart.py``.

1. build a reduced MoE model and collect real gate data,
2. fine-tune the layer-aware load predictors (paper §4.1),
3. serve requests through the request-level API (submit / stream /
   cancel, per-request SamplingParams): predictor -> scaler -> placer ->
   serverless slots,
4. report latency vs the Megatron static-EP baseline via the §3.3 model
   (the reference's v5e cost-model constants).

On the CUDA card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

The weights come from ``init_params(cfg, seed)``, so the printed
accuracies and tokens differ from the reference script's; the tests hold
``run`` to the reference's steps on carried weights.
"""
from __future__ import annotations

import argparse
from typing import NamedTuple

import numpy as np

from repro_torch.kernels import IMPLS

N_REQUESTS, PROMPT_LEN, MAX_NEW = 8, 16, 12
GATE_BATCHES, GATE_SHAPE = 4, (4, 64)
# the reference's skewed layer load of its 4-expert smoke model; wider
# models repeat the small loads (``skewed_loads``)
SKEWED_LOADS = (1000.0, 40.0, 30.0, 30.0)


class Quickstart(NamedTuple):
    """What ``run`` computed: the predictor's per-layer accuracy before
    and after fine-tuning, the fine-tuned layers and the fine-tuned
    ``LoadPredictor``; each request's tokens (the cancelled one's as far
    as it got), request 0's streamed tokens, the ``ServeResult`` and the
    engine's controller; the §3.3 model's static and MoEless layer times
    (s) and the MoEless reduction (a fraction)."""
    acc_before: np.ndarray
    acc_after: np.ndarray
    finetuned_layers: list
    predictor: object
    tokens: list
    streamed: list
    result: object
    controller: object
    t_static: float
    t_moeless: float
    reduction: float


def gate_batches(vocab_size: int, seed: int = 0) -> list:
    """The gate dataset's token batches: batch i is
    ``jax.random.randint(fold_in(PRNGKey(seed), i), (4, 64), 0, vocab)``
    drawn by ``models.prng`` (host int32 tensors)."""
    from repro_torch.models import prng
    key = prng.key(seed)
    n = int(np.prod(GATE_SHAPE))
    return [prng.randint(prng.fold_in(key, i), n, 0, vocab_size)
            .reshape(GATE_SHAPE) for i in range(GATE_BATCHES)]


def make_requests(vocab_size: int, seed: int = 0) -> list:
    """The 8 requests: 16-token prompts from ``default_rng(seed)``, 12 new
    tokens each, odd ones sampled (temperature 0.8, top-k 16, seed i),
    even ones greedy."""
    from repro_torch.serving.scheduler import GenRequest, SamplingParams
    rng = np.random.default_rng(seed)
    return [GenRequest(
        rid=i, arrival=0.0,
        prompt=rng.integers(0, vocab_size, size=PROMPT_LEN, dtype=np.int32),
        max_new_tokens=MAX_NEW,
        sampling=SamplingParams(temperature=0.8, top_k=16, seed=i)
        if i % 2 else SamplingParams())
        for i in range(N_REQUESTS)]


def skewed_loads(num_experts: int) -> np.ndarray:
    """One expert at 1000 tokens, the others at the reference's 40, 30,
    30 repeated: the reference's vector at 4 experts."""
    return np.concatenate([SKEWED_LOADS[:1],
                           np.resize(SKEWED_LOADS[1:], num_experts - 1)])


def cost_model(cfg, num_devices: int = 8):
    """The §3.3 layer time of the skewed load under static EP and under
    the MoEless plan (scaled at CV 0.2, placed on `num_devices`):
    (static s, MoEless s). The plan may hold twice the experts'
    replicas, and at least `num_devices`: the reference's 8 for its 4
    experts on 8 devices. (At 8 replicas, 8 experts would leave the
    skewed one none to spare.)"""
    from repro_torch.core import costmodel as CM
    from repro_torch.core.placer import place_layer
    from repro_torch.core.plan import static_plan
    from repro_torch.core.scaler import scale_layer
    coeffs = CM.derive_coeffs(cfg)
    sp = static_plan(cfg.moe.num_experts, num_devices)
    loads = skewed_loads(cfg.moe.num_experts)
    reps = scale_layer(loads, cv_threshold=0.2, max_total_replicas=max(
        num_devices, 2 * cfg.moe.num_experts))
    mp = place_layer(loads, reps, num_devices)
    return (CM.layer_forward_time(sp, loads, coeffs),
            CM.layer_forward_time(mp, loads, coeffs))


def run(cfg, params, *, seed: int = 0, finetune_steps: int = 100,
        threshold: float = 0.8, num_devices: int = 8, slots: int = 4,
        max_len: int = 64, requests=None, log=print) -> Quickstart:
    """The reference's four steps on `cfg` and `params` (on any device):
    the gate dataset from ``gate_batches(vocab, seed)``, predictors at
    distance 1 fine-tuned below `threshold` for `finetune_steps` steps;
    `requests` (default ``make_requests(vocab)``) served on a session of
    `slots` slots with ``MoElessController(num_devices=, predictor=)``,
    request 0 streamed and the last one cancelled; the cost model.
    `log` gets the reference's three lines."""
    from repro_torch.core import predictor as P
    from repro_torch.core.control import MoElessController
    from repro_torch.serving.engine import ServingEngine

    # --- 1-2: predictor fine-tuning on real router data
    ds = P.collect_gate_dataset(cfg, params,
                                gate_batches(cfg.vocab_size, seed))
    train, test = P.split_dataset(ds)
    pred = P.from_gates(cfg, params, distance=1)
    acc0 = P.profile_accuracy(pred, test, cfg.moe.top_k)
    pred = P.finetune(pred, train, test, cfg.moe.top_k, threshold=threshold,
                      steps=finetune_steps)
    acc1 = P.profile_accuracy(pred, test, cfg.moe.top_k)
    log(f"predictor accuracy per layer: {acc0.round(3)} -> "
        f"{acc1.round(3)} (fine-tuned layers: {pred.finetuned_layers})")

    # --- 3: serve through the request-level API, control plane attached
    ctrl = MoElessController(cfg, num_devices=num_devices, predictor=pred)
    engine = ServingEngine(cfg, params, max_len=max_len, controller=ctrl)
    if requests is None:
        requests = make_requests(cfg.vocab_size)
    engine.start(num_slots=slots)
    handles = [engine.submit(r) for r in requests]
    streamed = list(engine.stream(handles[0]))   # incremental tokens
    engine.cancel(handles[-1])                   # client gave up
    res = engine.run()
    engine.close()
    log(f"served {len(res.records)} requests ({res.cancelled} cancelled), "
        f"streamed request 0 token-by-token: {streamed}")
    assert streamed == handles[0].tokens

    # --- 4: latency vs static EP under the paper's §3.3 cost model
    t_static, t_moeless = cost_model(cfg, num_devices)
    red = 1 - t_moeless / t_static
    log(f"layer forward on skewed load: static={t_static * 1e3:.3f} ms  "
        f"moeless={t_moeless * 1e3:.3f} ms  (-{red * 100:.0f}%)")
    return Quickstart(acc0, acc1, list(pred.finetuned_layers), pred,
                      [[int(t) for t in h.tokens] for h in handles],
                      [int(t) for t in streamed], res, ctrl, t_static,
                      t_moeless, red)


def main(argv=None) -> Quickstart:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card; raises "
                         "where none is present)")
    ap.add_argument("--impl", default="auto", choices=IMPLS,
                    help="kernel backend of the forward and the serving "
                         "engine; auto = the CUDA kernels on a CUDA "
                         "tensor, the plain versions on a CPU one")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config("mixtral-8x7b", smoke=True).with_(num_layers=4,
                                                       impl=args.impl)
    params = init_params(cfg, 0, device=args.device)
    return run(cfg, params)


if __name__ == "__main__":
    main()
