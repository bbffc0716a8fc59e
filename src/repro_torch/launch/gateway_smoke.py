"""End-to-end gateway smoke of the PyTorch port, the counterpart of
``examples/gateway_smoke.py``: boot ``repro_torch.launch.serve
--gateway`` as a subprocess (expert runtime ON, so every telemetry
subsystem is live; paged KV + chunked prefill + radix prefix cache ON,
capacity factor pinned to num_experts so routing is drop-free), hit it
over real HTTP, and assert

  * the tokens are bit-identical to an offline ``ServingEngine`` run
    with the same seed/prompt on the CONTIGUOUS KV layout (and no
    expert runtime) — so the greedy EP-vs-dispatch equivalence AND the
    paged-vs-contiguous bit-identity contract both ride over HTTP;
  * the second, identical request warms the radix prefix cache:
    ``kv_prefix_hits_total >= 1`` and ``kv_prefix_tokens_saved_total
    > 0`` in the exposition, with the tokens still unchanged;
  * ``GET /metrics`` is valid Prometheus text exposition (every line
    parses) containing counter+gauge+histogram families from each of
    scheduler / engine / expert runtime / control plane / router,
    plus the paged-KV gauges/counters;
  * ``GET /metrics.json`` still serves the JSON meters payload.

On the CUDA card unless ``--device cpu``; both sides take ``--impl``:

  PYTHONPATH=src python -m repro_torch.launch.gateway_smoke --device cpu

Exits non-zero on any mismatch.
"""
from __future__ import annotations

import argparse
import dataclasses
import http.client
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.kernels import IMPLS

SRC = Path(__file__).resolve().parents[2]
ROOT = SRC.parent

ARCH = "mixtral-8x7b"
PROMPT = list(range(1, 9))          # token ids; len 8
GEN = 6
SLOTS = 2
MAX_LEN = len(PROMPT) + GEN + 1
BOOT_TIMEOUT_S = 300
SEED = 0
# Paged-KV knobs for the gateway side. Bit-identity vs the contiguous
# offline engine requires drop-free routing, so the capacity factor is
# pinned to the smoke config's num_experts on BOTH sides.
KV_BLOCK = 5
PREFILL_CHUNK = 3
CAPACITY_FACTOR = 4.0


def smoke_config(impl: str = "auto"):
    """The launcher's model: the arch's smoke config at the pinned
    drop-free capacity factor, kernels per `impl`."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH, smoke=True)
    assert float(cfg.moe.num_experts) == CAPACITY_FACTOR, \
        "drop-free pin out of date vs smoke config"
    return cfg.with_(impl=impl, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CAPACITY_FACTOR))


def offline_tokens(cfg, params) -> list[int]:
    """Greedy continuation from a plain in-process engine — the ground
    truth the gateway must reproduce bit-for-bit.  Deliberately stays
    on the CONTIGUOUS KV layout while the gateway serves from the
    paged pool: matching tokens over HTTP exercises the
    paged-vs-contiguous identity contract end to end."""
    import numpy as np

    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import GenRequest, SamplingParams

    eng = ServingEngine(cfg, params, max_len=MAX_LEN)
    req = GenRequest(rid=0, arrival=0.0,
                     prompt=np.asarray(PROMPT, np.int32),
                     max_new_tokens=GEN,
                     sampling=SamplingParams(temperature=0.0))
    eng.start(num_slots=SLOTS)
    handle = eng.submit(req)
    eng.run()
    tokens = [int(t) for t in handle.tokens]
    eng.close()
    return tokens


def boot_gateway(device: str = "cuda",
                 impl: str = "auto") -> tuple[subprocess.Popen, int]:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--gateway",
         "--port", "0", "--replicas", "1", "--slots", str(SLOTS),
         "--prompt-len", str(len(PROMPT)), "--gen", str(GEN),
         "--arch", ARCH, "--seed", str(SEED), "--expert-runtime", "on",
         "--kv-block", str(KV_BLOCK),
         "--prefill-chunk", str(PREFILL_CHUNK), "--prefix-cache",
         "--capacity-factor", str(CAPACITY_FACTOR),
         "--device", device, "--impl", impl],
        env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + BOOT_TIMEOUT_S
    lines = []
    while True:
        if time.monotonic() > deadline:
            proc.kill()
            sys.exit("gateway did not become ready:\n" + "".join(lines))
        line = proc.stdout.readline()
        if not line and proc.poll() is not None:
            sys.exit("gateway exited early:\n" + "".join(lines))
        lines.append(line)
        if line.startswith("GATEWAY READY"):
            port = int(line.split()[2].rsplit(":", 1)[1])
            return proc, port


def request(port: int, method: str, path: str, body: dict | None = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    payload = None if body is None else json.dumps(body)
    conn.request(method, path, body=payload,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r' (-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?|[+-]Inf|NaN)$')


def parse_exposition(text: str) -> tuple[dict, dict]:
    """Small Prometheus text-format 0.0.4 parser: every non-comment
    line must match ``name{labels} value``. Returns ({family: kind},
    {series: value})."""
    types: dict[str, str] = {}
    samples: dict[str, float] = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            assert kind in ("counter", "gauge", "histogram"), \
                f"unknown TYPE: {line!r}"
            types[name] = kind
        elif line.startswith("# HELP "):
            continue
        elif line.startswith("#"):
            raise AssertionError(f"unexpected comment line: {line!r}")
        else:
            m = _SAMPLE_RE.match(line)
            assert m, f"malformed sample line: {line!r}"
            samples[m.group(1) + (m.group(2) or "")] = float(
                m.group(3).replace("+Inf", "inf").replace("-Inf", "-inf"))
    return types, samples


# one (counter, gauge, histogram) triple per instrumented subsystem —
# the acceptance criterion for the exposition
REQUIRED_FAMILIES = {
    "scheduler": ("scheduler_admitted_total", "scheduler_pending",
                  "scheduler_queue_delay_seconds"),
    "engine": ("engine_steps_total", "engine_batch_occupancy",
               "engine_step_seconds"),
    "runtime": ("runtime_replica_starts_total", "runtime_resident_replicas",
                "runtime_bank_flush_seconds"),
    "control": ("control_iterations_total", "control_pred_load_l1_error",
                "control_layer_latency_seconds"),
    "router": ("router_requests_total", "router_replicas",
               "router_http_request_seconds"),
}


def check_exposition(text: str) -> None:
    types, samples = parse_exposition(text)
    for subsystem, (ctr, gau, hist) in REQUIRED_FAMILIES.items():
        assert types.get(ctr) == "counter", (subsystem, ctr, types.get(ctr))
        assert types.get(gau) == "gauge", (subsystem, gau, types.get(gau))
        assert types.get(hist) == "histogram", \
            (subsystem, hist, types.get(hist))
    assert samples["scheduler_admitted_total"] >= 2, samples
    assert samples['engine_steps_total{phase="decode"}'] >= 1
    assert samples['control_iterations_total{phase="decode"}'] >= 1
    # per-layer L1 error gauges, one per MoE layer
    l1 = [k for k in samples if k.startswith("control_pred_load_l1_error{")]
    assert l1, "no per-layer control_pred_load_l1_error series"
    assert samples['router_requests_total{outcome="admitted"}'] >= 2
    assert samples["scheduler_queue_delay_seconds_count"] >= 2
    starts = sum(v for k, v in samples.items()
                 if k.startswith("runtime_replica_starts_total{"))
    assert starts > 0, "expert runtime recorded no replica starts"
    # paged-KV pool + radix prefix cache: the second (identical)
    # request must have resumed from the cached prompt chain
    assert types.get("kv_blocks_used") == "gauge", types.get("kv_blocks_used")
    assert types.get("kv_blocks_free") == "gauge", types.get("kv_blocks_free")
    assert types.get("kv_prefix_hits_total") == "counter"
    assert samples["kv_prefix_hits_total"] >= 1, \
        "warm second request did not hit the prefix cache"
    assert samples["kv_prefix_tokens_saved_total"] > 0, samples
    # both requests released their slots before this scrape, so every
    # non-cached block is back on the free list
    assert samples["kv_blocks_free"] > 0, samples


def sse_tokens(raw: bytes) -> tuple[list[int], str | None]:
    tokens, reason, done = [], None, False
    for frame in raw.split(b"\n\n"):
        if not frame.startswith(b"data: "):
            continue
        if frame == b"data: [DONE]":
            done = True
            continue
        choice = json.loads(frame[6:])["choices"][0]
        tokens += choice.get("tokens", [])
        reason = choice.get("finish_reason") or reason
    assert done, "SSE stream did not finish with data: [DONE]"
    return tokens, reason


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of both the offline engine and the "
                         "gateway (default: the CUDA card; raises where "
                         "none is present)")
    ap.add_argument("--impl", default="auto", choices=IMPLS,
                    help="kernel backend of both sides; auto = the CUDA "
                         "kernels on the card, the plain versions on the "
                         "CPU")
    args = ap.parse_args(argv)

    from repro_torch.models.model import init_params
    cfg = smoke_config(args.impl)
    expected = offline_tokens(cfg, init_params(cfg, SEED,
                                               device=args.device))
    print(f"offline greedy tokens: {expected}")
    assert len(expected) == GEN

    proc, port = boot_gateway(args.device, args.impl)
    try:
        st, raw = request(port, "GET", "/healthz")
        health = json.loads(raw)
        assert st == 200 and health["status"] == "ok", (st, health)

        st, raw = request(port, "POST", "/v1/completions",
                          {"prompt": PROMPT, "max_tokens": GEN})
        body = json.loads(raw)
        assert st == 200, (st, body)
        got = body["choices"][0]["tokens"]
        assert got == expected, f"unary mismatch: {got} != {expected}"
        assert body["choices"][0]["finish_reason"] == "length", body
        assert body["usage"]["completion_tokens"] == GEN, body
        print(f"unary completion OK: {got}")

        st, raw = request(port, "POST", "/v1/completions",
                          {"prompt": PROMPT, "max_tokens": GEN,
                           "stream": True})
        assert st == 200, (st, raw[:200])
        got, reason = sse_tokens(raw)
        assert got == expected, f"SSE mismatch: {got} != {expected}"
        assert reason == "length", reason
        print(f"SSE stream OK: {got}")

        st, raw = request(port, "GET", "/metrics")
        assert st == 200, (st, raw[:200])
        check_exposition(raw.decode())
        print(f"/metrics exposition OK ({len(raw.splitlines())} lines, "
              f"all 5 subsystems present, prefix cache warm)")

        st, raw = request(port, "GET", "/metrics.json")
        m = json.loads(raw)["router"]
        assert st == 200 and m["admitted"] >= 2 \
            and m["completed"] >= 2 and m["rejected"] == 0, m
        assert "scale_events_total" in m, m
        print(f"/metrics.json OK: {m}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
    print("gateway smoke PASS: paged/chunked/prefix HTTP tokens == "
          "contiguous offline engine")


if __name__ == "__main__":
    main()
