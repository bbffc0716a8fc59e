"""PyTorch port, ``launch/gateway_smoke.py`` against the reference's
``examples/gateway_smoke.py`` on the CPU:

* ``offline_tokens`` on the reference's weights through ``from_jax``
  equals the reference's ``offline_tokens`` logic (the smoke config at
  the pinned capacity factor, contiguous KV, no runtime) on the JAX
  weights, token for token, at float32 and at the smoke config's own
  bfloat16;
* the constants, ``REQUIRED_FAMILIES``, ``parse_exposition`` and
  ``check_exposition`` equal the reference script's (loaded with
  ``importlib``): both parse the reference's golden exposition to the
  same types and samples, both accept an exposition the reference's
  ``MetricsRegistry`` renders with every required family, both refuse
  the same malformed lines and the same incomplete expositions;
* one boot of ``python -m repro_torch.launch.gateway_smoke --device
  cpu`` passes end to end in a subprocess (the launcher with the expert
  runtime on, paged KV, chunked prefill and the prefix cache, over HTTP,
  against the offline engine), with the script's boot timeout kept;
  without ``--device`` it needs a card.
"""
import dataclasses
import functools
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.obs.registry import MetricsRegistry
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.scheduler import GenRequest as JGenRequest
from repro.serving.scheduler import SamplingParams as JSamplingParams
from repro_torch.launch import gateway_smoke as G
from repro_torch.params import from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "goldens" / "metrics_exposition.txt"
# the script's boot timeout, the model's build and two requests
RUN_TIMEOUT_S = G.BOOT_TIMEOUT_S + 120


@functools.lru_cache(maxsize=None)
def _ref_script():
    spec = importlib.util.spec_from_file_location(
        "ref_gateway_smoke", ROOT / "examples" / "gateway_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_offline(jcfg, jp):
    """The reference's ``offline_tokens`` body on given weights."""
    eng = JServingEngine(jcfg, jp, max_len=G.MAX_LEN)
    req = JGenRequest(rid=0, arrival=0.0,
                      prompt=np.asarray(G.PROMPT, np.int32),
                      max_new_tokens=G.GEN,
                      sampling=JSamplingParams(temperature=0.0))
    eng.start(num_slots=G.SLOTS)
    handle = eng.submit(req)
    eng.run()
    return [int(t) for t in handle.tokens]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_offline_tokens_match_reference(dtype):
    jcfg = jget_config(G.ARCH, smoke=True)
    jcfg = jcfg.with_(dtype=dtype, impl="ref", moe=dataclasses.replace(
        jcfg.moe, capacity_factor=G.CAPACITY_FACTOR))
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    cfg = G.smoke_config().with_(dtype=dtype)
    assert cfg.moe.capacity_factor == jcfg.moe.capacity_factor == 4.0
    want = _ref_offline(jcfg, jp)
    got = G.offline_tokens(cfg, from_jax(jax.tree.map(np.asarray, jp)))
    assert len(got) == G.GEN
    assert got == want


def test_constants_match_reference_script():
    ref = _ref_script()
    for k in ("ARCH", "PROMPT", "GEN", "SLOTS", "MAX_LEN", "BOOT_TIMEOUT_S",
              "KV_BLOCK", "PREFILL_CHUNK", "CAPACITY_FACTOR",
              "REQUIRED_FAMILIES"):
        assert getattr(G, k) == getattr(ref, k), k
    assert G.smoke_config().dtype == jget_config(G.ARCH, smoke=True).dtype


def test_parse_exposition_matches_reference_on_its_golden():
    text = GOLDEN.read_text()
    types, samples = G.parse_exposition(text)
    assert (types, samples) == _ref_script().parse_exposition(text)
    assert types["demo_requests_total"] == "counter"
    assert samples['demo_requests_total{outcome="ok"}'] == 3.0
    assert samples['demo_latency_seconds_bucket{le="+Inf"}'] == 3.0


MALFORMED = [
    "demo_total",                               # no value
    'demo_total{outcome="ok} 1',                # unterminated label
    "demo_total 1 2",                           # two values
    "# TYPE demo_total summary",                # unknown kind
    "# a stray comment",
    "9demo_total 1",                            # bad name
]


@pytest.mark.parametrize("line", MALFORMED)
def test_parse_exposition_refuses_malformed_lines(line):
    text = GOLDEN.read_text() + line + "\n"
    with pytest.raises(AssertionError):
        G.parse_exposition(text)
    with pytest.raises(AssertionError):
        _ref_script().parse_exposition(text)


def _rendered(drop=None, prefix_hits=1.0):
    """An exposition rendered by the reference's registry with every
    family ``check_exposition`` reads, the values it asks for; `drop`
    leaves one family out, `prefix_hits` sets the prefix-cache hits."""
    reg = MetricsRegistry()
    for ctr, gau, hist in G.REQUIRED_FAMILIES.values():
        for name, kind in ((ctr, "counter"), (gau, "gauge"),
                           (hist, "histogram")):
            if name == drop:
                continue
            if name == "engine_steps_total" or \
                    name == "control_iterations_total":
                getattr(reg, kind)(name, labels=("phase",)).labels(
                    phase="decode").inc(3)
            elif name == "control_pred_load_l1_error":
                reg.gauge(name, labels=("layer",)).labels(layer="1").set(
                    0.25)
            elif name == "router_requests_total":
                reg.counter(name, labels=("outcome",)).labels(
                    outcome="admitted").inc(2)
            elif name == "runtime_replica_starts_total":
                reg.counter(name, labels=("kind",)).labels(
                    kind="cold").inc(4)
            elif kind == "histogram":
                h = reg.histogram(name)
                h.observe(0.01)
                h.observe(0.02)
            elif kind == "counter":
                reg.counter(name).inc(2)
            else:
                reg.gauge(name).set(1)
    reg.gauge("kv_blocks_used").set(2)
    reg.gauge("kv_blocks_free").set(5)
    reg.counter("kv_prefix_hits_total").inc(prefix_hits)
    reg.counter("kv_prefix_tokens_saved_total").inc(5)
    return reg.render_prometheus()


@pytest.mark.parametrize("case", ["complete", "no_runtime_gauge",
                                  "no_router_histogram", "cold_prefix"])
def test_check_exposition_matches_reference(case):
    text = {"complete": lambda: _rendered(),
            "no_runtime_gauge": lambda: _rendered(
                drop="runtime_resident_replicas"),
            "no_router_histogram": lambda: _rendered(
                drop="router_http_request_seconds"),
            "cold_prefix": lambda: _rendered(prefix_hits=0.0)}[case]()
    outcomes = []
    for check in (G.check_exposition, _ref_script().check_exposition):
        try:
            check(text)
            outcomes.append("pass")
        except AssertionError:
            outcomes.append("fail")
    assert outcomes == (["pass"] * 2 if case == "complete" else ["fail"] * 2)


def test_gateway_smoke_passes_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.gateway_smoke",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=RUN_TIMEOUT_S)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    want = lines[0].removeprefix("offline greedy tokens: ")
    assert lines[1] == f"unary completion OK: {want}"
    assert lines[2] == f"SSE stream OK: {want}"
    assert lines[3].startswith("/metrics exposition OK (")
    assert lines[-1].startswith("gateway smoke PASS")


def test_main_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.main([])
