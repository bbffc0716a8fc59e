"""PyTorch port, gateway: the OpenAI-compatible HTTP/SSE front door of
``repro_torch.serving.gateway`` over the port's engine on the CPU, as
the reference's ``tests/test_gateway.py`` drives the reference's:
gateway tokens (unary and SSE, greedy and sampled, completions and
chat) equal to the port's offline ``engine.stream()``, concurrent
clients, disconnect-frees-KV-slot, backpressure 429, replica failover,
structured 400s, the autoscaler's pure decisions, ``/metrics`` as
Prometheus text, and ``parse_completion`` against the reference's on
the same JSON. Servers run in threads (no fork). Exact throughout."""
import asyncio
import http.client
import json
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro.serving.gateway import parse_completion as jparse_completion
from repro_torch.configs import get_config
from repro_torch.models.model import init_params
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.gateway import (FAIL_TOKEN, Autoscaler,
                                         AutoscalerConfig, EngineDriver,
                                         GatewayServer, ReplicaMeters,
                                         RequestError, Router,
                                         parse_completion)
from repro_torch.serving.scheduler import GenRequest, SamplingParams

torch.set_num_threads(1)

MAX_LEN = 64
SLOTS = 2
PROMPT = list(range(1, 9))


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("mixtral-8x7b", smoke=True).with_(dtype="float32")
    return cfg, init_params(cfg, 0, device="cpu")


def _offline_tokens(cfg, params, sampling: SamplingParams,
                    gen: int = 8) -> list[int]:
    """Ground truth via the request-level API + ``engine.stream()``."""
    eng = ServingEngine(cfg, params, max_len=MAX_LEN)
    eng.start(num_slots=SLOTS)
    handle = eng.submit(GenRequest(
        rid=0, arrival=0.0, prompt=np.asarray(PROMPT, np.int32),
        max_new_tokens=gen, sampling=sampling))
    tokens = [int(t) for t in eng.stream(handle)]
    eng.close()
    return tokens


# ------------------------------------------------------ HTTP plumbing


class _Loop:
    """An asyncio loop on a background thread hosting a GatewayServer."""

    def __init__(self, router: Router):
        self.router = router
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.srv = GatewayServer(router)
        _, self.port = asyncio.run_coroutine_threadsafe(
            self.srv.start(), self.loop).result(30)

    def close(self):
        asyncio.run_coroutine_threadsafe(self.srv.close(),
                                         self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=5)
        self.router.stop()


@pytest.fixture(scope="module")
def gateway(setup):
    """One shared 2-replica threaded gateway for the HTTP tests."""
    cfg, params = setup

    def factory(i):
        eng = ServingEngine(cfg, params, max_len=MAX_LEN)
        return EngineDriver(eng, replica_id=i, num_slots=SLOTS,
                            max_pending=16)

    hosted = _Loop(Router(factory, threaded=True,
                          scaler=AutoscalerConfig(min_replicas=2,
                                                  max_replicas=2)))
    yield hosted
    hosted.close()


def _post(port, path, body, headers=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    data = resp.read()
    hdrs = dict(resp.getheaders())
    conn.close()
    return resp.status, hdrs, data


def _tokens(choice: dict) -> list[int]:
    """A choice's token ids: `tokens` (completions) or the message's or
    delta's `content` (chat)."""
    if "tokens" in choice:
        return choice["tokens"]
    return choice.get("message", choice.get("delta", {})).get("content",
                                                               [])


def _sse_tokens(raw: bytes) -> list[int]:
    toks = []
    for frame in raw.split(b"\n\n"):
        if frame.startswith(b"data: ") and frame != b"data: [DONE]":
            toks += _tokens(json.loads(frame[6:])["choices"][0])
    return toks


# ------------------------------------------------------------- parity


def test_gateway_tokens_match_engine_stream(setup, gateway):
    """Unary AND SSE responses are bit-identical to engine.stream()
    with the same seed — greedy, seeded top-p and seeded top-k/top-p
    sampling, on /v1/completions and /v1/chat/completions."""
    cfg, params = setup
    for sampling, chat in (
            (SamplingParams(temperature=0.0), False),
            (SamplingParams(temperature=0.8, top_p=0.9, seed=7), False),
            (SamplingParams(temperature=1.1, top_k=20, top_p=0.95,
                            seed=-4), True)):
        expected = _offline_tokens(cfg, params, sampling)
        body = {"max_tokens": 8, "temperature": sampling.temperature,
                "top_k": sampling.top_k, "top_p": sampling.top_p,
                "seed": sampling.seed}
        if chat:
            body["messages"] = [{"role": "system", "content": PROMPT[:3]},
                                {"role": "user", "content": PROMPT[3:]}]
            path = "/v1/chat/completions"
        else:
            body["prompt"] = PROMPT
            path = "/v1/completions"
        st, _, raw = _post(gateway.port, path, body)
        assert st == 200, raw
        out = json.loads(raw)
        assert _tokens(out["choices"][0]) == expected
        assert out["choices"][0]["finish_reason"] == "length"
        st, _, raw = _post(gateway.port, path, {**body, "stream": True})
        assert st == 200
        assert _sse_tokens(raw) == expected
        assert raw.rstrip().endswith(b"data: [DONE]")
    greedy = _offline_tokens(cfg, params, SamplingParams(temperature=0.0))
    assert expected != greedy      # the sampler ran


def _get(port, path, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_metrics_prometheus_text(setup):
    """With telemetry on, /metrics is Prometheus text with the router,
    scheduler, KV and control families after a request through a paged
    replica with a session control plane; /healthz and /metrics.json
    answer."""
    from repro_torch.configs import ServingSpec
    from repro_torch.core.control import MoElessController
    from repro_torch.obs import Telemetry
    cfg, params = setup
    tel = Telemetry()
    spec = ServingSpec(kv="paged", kv_block=4, prefill_chunk=4,
                       prefix_cache=True)

    def factory(i):
        eng = ServingEngine(cfg, params, max_len=MAX_LEN, serving=spec,
                            telemetry=tel, name=f"replica{i}")
        return EngineDriver(eng, replica_id=i, num_slots=SLOTS,
                            max_pending=4, control=MoElessController(
                                cfg, telemetry=tel,
                                track=f"replica{i}/control"))

    hosted = _Loop(Router(factory, threaded=True, telemetry=tel))
    try:
        st, _, raw = _post(hosted.port, "/v1/completions",
                           {"prompt": PROMPT, "max_tokens": 3})
        assert st == 200, raw
        st, raw = _get(hosted.port, "/metrics")
        assert st == 200
        families = set()
        for line in raw.decode().splitlines():
            if line.startswith("# TYPE "):
                name, kind = line.split()[2:4]
                assert kind in ("counter", "gauge", "histogram"), line
                families.add(name)
            elif line and not line.startswith("#"):
                float(line.rsplit(" ", 1)[1])
        for prefix in ("router_", "scheduler_", "kv_", "control_"):
            assert any(f.startswith(prefix) for f in families), prefix
        st, raw = _get(hosted.port, "/healthz")
        assert st == 200 and json.loads(raw)["status"] == "ok"
        st, raw = _get(hosted.port, "/metrics.json")
        assert st == 200 and json.loads(raw)["router"]["completed"] == 1
    finally:
        hosted.close()


def test_concurrent_clients_all_complete(setup, gateway):
    """A burst of concurrent clients across 2 replicas: every request
    completes with its own tokens and per-request metrics."""
    cfg, params = setup
    n = 6
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).tolist()
               for _ in range(n)]

    def one(i):
        return _post(gateway.port, "/v1/completions",
                     {"prompt": prompts[i], "max_tokens": 6})

    with ThreadPoolExecutor(n) as ex:
        results = list(ex.map(one, range(n)))
    replicas = set()
    for st, _, raw in results:
        assert st == 200, raw
        out = json.loads(raw)
        assert len(out["choices"][0]["tokens"]) == 6
        m = out["metrics"]
        assert m["e2e_s"] >= 0.0 and m["ttft_s"] >= 0.0
        replicas.add(m["replica"])
    assert replicas <= {0, 1}
    router = gateway.router.metrics()["router"]
    assert router["rejected"] == 0


def test_disconnect_mid_stream_frees_slot(setup):
    """Killing the socket mid-SSE cancels the request: the KV slot is
    recycled and the cancel is counted. The budget (480 tokens) keeps
    the request decoding well past the moment the disconnect is seen."""
    cfg, params = setup

    def factory(i):
        eng = ServingEngine(cfg, params, max_len=512)
        return EngineDriver(eng, replica_id=i, num_slots=SLOTS,
                            max_pending=4)

    hosted = _Loop(Router(factory, threaded=True))
    try:
        sock = socket.create_connection(("127.0.0.1", hosted.port))
        payload = json.dumps({"prompt": PROMPT, "max_tokens": 480,
                              "stream": True}).encode()
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\n"
                     b"Host: x\r\nContent-Type: application/json\r\n"
                     b"Content-Length: " + str(len(payload)).encode()
                     + b"\r\n\r\n" + payload)
        buf = b""
        while buf.count(b"data: ") < 2:        # wait for streaming to start
            chunk = sock.recv(4096)
            assert chunk, f"stream ended early: {buf!r}"
            buf += chunk
        sock.close()                           # abrupt client disconnect

        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            m = hosted.router.metrics()
            if m["router"]["cancelled"] == 1 \
                    and all(r["free_slots"] == SLOTS and r["running"] == 0
                            for r in m["replicas"]):
                break
            time.sleep(0.02)
        else:
            pytest.fail(f"slot not freed after disconnect: {m}")
        assert m["router"]["completed"] == 0
    finally:
        hosted.close()


def test_backpressure_429(setup):
    """1-deep pending queue on an UNTHREADED replica (nothing steps
    until the test drives it — no race): the second request gets HTTP
    429 + Retry-After while the first is still queued, and the queued
    one still completes once the engine is stepped."""
    cfg, params = setup

    def factory(i):
        eng = ServingEngine(cfg, params, max_len=MAX_LEN)
        return EngineDriver(eng, replica_id=i, num_slots=1,
                            max_pending=1)

    hosted = _Loop(Router(factory, threaded=False))
    try:
        body = {"prompt": PROMPT, "max_tokens": 4}
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(_post, hosted.port, "/v1/completions", body)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:   # until it is queued
                if hosted.router.metrics()["replicas"][0]["pending"]:
                    break
                time.sleep(0.005)
            st, hdrs, raw = _post(hosted.port, "/v1/completions", body)
            assert st == 429, raw
            err = json.loads(raw)["error"]
            assert err["type"] == "rate_limit_exceeded"
            assert float(hdrs["Retry-After"]) > 0
            # drain from the test thread: the parked request completes
            deadline = time.monotonic() + 120
            while hosted.router.metrics()["router"]["completed"] < 1:
                assert time.monotonic() < deadline
                hosted.router.step_all()
            st, _, raw = fut.result(timeout=120)
            assert st == 200, raw
        m = hosted.router.metrics()["router"]
        assert (m["rejected"], m["admitted"]) == (1, 1)
    finally:
        hosted.close()


def test_router_failover_unhealthy_replica(setup):
    """Marking a replica unhealthy fails its in-flight clients fast and
    routes new work to the survivor."""
    cfg, params = setup

    def factory(i):
        eng = ServingEngine(cfg, params, max_len=MAX_LEN)
        return EngineDriver(eng, replica_id=i, num_slots=SLOTS,
                            max_pending=8)

    router = Router(factory, threaded=False,
                    scaler=AutoscalerConfig(min_replicas=2,
                                            max_replicas=2))
    try:
        req = GenRequest(rid=router.next_rid(), arrival=float("nan"),
                         prompt=np.asarray(PROMPT, np.int32),
                         max_new_tokens=4)
        got = []
        d0, h0 = router.submit(req, sink=got.append)
        assert d0.replica_id == 0          # least-outstanding tie -> 0
        router.mark_unhealthy(0)
        assert got and got[-1].done and got[-1].token < 0
        assert router.live_replicas() == [router.replicas[1]]

        req2 = GenRequest(rid=router.next_rid(), arrival=float("nan"),
                          prompt=np.asarray(PROMPT, np.int32),
                          max_new_tokens=4)
        d1, h1 = router.submit(req2)
        assert d1.replica_id == 1          # failed over
        for _ in range(50):
            if h1.status == "finished":
                break
            d1.step_once()
        expected = _offline_tokens(cfg, params,
                                   SamplingParams(temperature=0.0),
                                   gen=4)
        assert [int(t) for t in h1.tokens] == expected
    finally:
        router.stop()


def test_sink_installed_before_submit(setup):
    """Regression: driver.submit wakes the step thread, which can emit
    a short request's ENTIRE completion before Router.submit returns —
    the sink must be installed before the submit so no event is
    dropped."""
    cfg, params = setup

    class EagerDriver(EngineDriver):
        """Simulates the step thread winning the race: the request is
        fully decoded inside submit(), before the caller regains
        control."""

        def submit(self, req):
            h = super().submit(req)
            while h.status in ("queued", "running"):
                self.step_once()
            return h

    def factory(i):
        eng = ServingEngine(cfg, params, max_len=MAX_LEN)
        return EagerDriver(eng, replica_id=i, num_slots=1, max_pending=4)

    router = Router(factory, threaded=False)
    try:
        got = []
        req = GenRequest(rid=router.next_rid(), arrival=float("nan"),
                         prompt=np.asarray(PROMPT, np.int32),
                         max_new_tokens=3)
        _, h = router.submit(req, sink=got.append)
        assert h.status == "finished"
        assert [e.token for e in got if e.token >= 0] \
            == [int(t) for t in h.tokens]
        assert got and got[-1].done
    finally:
        router.stop()


def test_replica_fail_cancels_inflight(setup):
    """fail() frees the KV slots of in-flight work, marks the handles
    'replica_failed' (status 'cancelled', not a fake success) and
    pushes a FAIL_TOKEN terminal event; stop(close=True) releases the
    session eagerly."""
    cfg, params = setup
    eng = ServingEngine(cfg, params, max_len=MAX_LEN)
    d = EngineDriver(eng, replica_id=0, num_slots=1, max_pending=4)
    got = []
    req = GenRequest(rid=0, arrival=float("nan"),
                     prompt=np.asarray(PROMPT, np.int32),
                     max_new_tokens=8)
    h = d.submit(req)
    d.subscribe(req.rid, got.append)
    d.step_once()                           # prefill: now mid-decode
    assert h.status == "running"
    d.fail()
    assert got and got[-1].done and got[-1].token == FAIL_TOKEN
    assert h.finish_reason == "replica_failed"
    assert h.status == "cancelled"
    m = d.meters()
    assert (m.pending, m.running, m.free_slots) == (0, 0, 1)
    d.stop(close=True)
    assert eng._session is None


def test_retire_releases_engine_session(setup):
    """Scale-down must stop the resident burn NOW: the retired
    replica's engine session is closed eagerly, not left to a future
    gc pass of the engine<->driver reference cycle."""
    cfg, params = setup
    made = []

    def factory(i):
        d = EngineDriver(ServingEngine(cfg, params, max_len=MAX_LEN),
                         replica_id=i, num_slots=1, max_pending=4)
        made.append(d)
        return d

    router = Router(factory, threaded=False,
                    scaler=AutoscalerConfig(min_replicas=1,
                                            max_replicas=2,
                                            idle_gb_s_down=1e-12,
                                            cooldown_s=0.0))
    try:
        router._spawn()                    # fleet of 2, both idle
        for i in range(1, 4):
            router.autoscale(0.1 * i)      # idle burn accrues -> retire
        assert len(router.replicas) == 1
        assert router.counters.scale_downs == 1
        retired, = [d for d in made
                    if d.replica_id not in router.replicas]
        assert retired.engine._session is None
    finally:
        router.stop()


def test_unary_replica_failure_returns_503(setup):
    """A replica dying mid-request surfaces as HTTP 503 (server_error),
    not a 200 with finish_reason 'cancelled'."""
    cfg, params = setup

    def factory(i):
        eng = ServingEngine(cfg, params, max_len=MAX_LEN)
        return EngineDriver(eng, replica_id=i, num_slots=1,
                            max_pending=4)

    hosted = _Loop(Router(factory, threaded=False))
    try:
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(_post, hosted.port, "/v1/completions",
                            {"prompt": PROMPT, "max_tokens": 4})
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:   # queued, never stepped
                if hosted.router.metrics()["replicas"][0]["pending"]:
                    break
                time.sleep(0.005)
            hosted.router.mark_unhealthy(0)
            st, _, raw = fut.result(timeout=30)
        assert st == 503, raw
        assert json.loads(raw)["error"]["type"] == "server_error"
    finally:
        hosted.close()


def test_malformed_content_length_400(gateway):
    """'Content-Length: abc' is a client error (400), not a 500."""
    sock = socket.create_connection(("127.0.0.1", gateway.port))
    try:
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Length: abc\r\n\r\n")
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(4096)
            if not chunk:
                break
            buf += chunk
        assert buf.startswith(b"HTTP/1.1 400 "), buf
    finally:
        sock.close()


# ----------------------------------------------- protocol validation


def test_structured_400_names_the_field():
    for body, param in (
            ({"prompt": PROMPT, "max_tokens": 4, "top_p": 0.0}, "top_p"),
            ({"prompt": PROMPT, "max_tokens": 4,
              "temperature": float("nan")}, "temperature"),
            ({"prompt": PROMPT, "max_tokens": 0}, "max_tokens"),
            ({"prompt": "text strings are not supported",
              "max_tokens": 4}, "prompt"),
            ({"prompt": PROMPT, "max_tokens": 4, "stop": [[]]}, "stop"),
            ({"max_tokens": 4}, "prompt")):
        with pytest.raises(RequestError) as ei:
            parse_completion(body, chat=False)
        assert ei.value.status == 400
        assert ei.value.param == param, body
        assert ei.value.body()["error"]["param"] == param


def test_parse_completion_maps_fields():
    creq = parse_completion(
        {"prompt": PROMPT, "max_tokens": 5, "temperature": 0.7,
         "top_p": 0.9, "seed": 11, "stop": [[1, 2]]},
        chat=False, priority=2)
    assert list(creq.prompt) == PROMPT and creq.max_tokens == 5
    s = creq.sampling
    assert (s.temperature, s.top_p, s.seed, s.priority) \
        == (0.7, 0.9, 11, 2)
    assert s.stop == ((1, 2),)
    chat = parse_completion(
        {"messages": [{"role": "user", "content": PROMPT}],
         "max_tokens": 3}, chat=True)
    assert list(chat.prompt) == PROMPT and chat.chat


def test_parse_completion_matches_reference():
    """The port's parse_completion gives the reference's fields, and
    rejects with the reference's status and param, for the same JSON."""
    bodies = [
        ({"prompt": PROMPT, "max_tokens": 5, "temperature": 0.7,
          "top_k": 3, "top_p": 0.9, "seed": 11, "stop": [[1, 2], [4]],
          "stream": True}, False, 2),
        ({"messages": [{"role": "user", "content": PROMPT}],
          "max_tokens": 3}, True, 0),
        ({"prompt": PROMPT, "max_tokens": 4, "top_p": 0.0}, False, 0),
        ({"prompt": PROMPT, "max_tokens": 0}, False, 0),
        ({"prompt": [PROMPT, PROMPT], "max_tokens": 2}, False, 0),
        ({"messages": [], "max_tokens": 2}, True, 0),
    ]

    def fields(fn, body, chat, priority):
        try:
            c = fn(body, chat=chat, priority=priority)
        except Exception as e:           # both packages' RequestError
            return ("error", e.status, e.param)
        s = c.sampling
        return (list(c.prompt), c.max_tokens, c.stream, c.chat,
                (s.temperature, s.top_k, s.top_p, s.seed, s.stop,
                 s.priority))

    for body, chat, pri in bodies:
        assert fields(parse_completion, body, chat, pri) == \
            fields(jparse_completion, body, chat, pri), body


# ------------------------------------------------- autoscaler (pure)


def _meters(rid, *, delay=0.0, idle=False):
    return ReplicaMeters(
        replica_id=rid, healthy=True, draining=False,
        pending=0 if idle else 1, running=0 if idle else 1,
        free_slots=2, outstanding_tokens=0 if idle else 8,
        queue_delay_s=delay, completed=0, cancelled=0, clock_s=0.0,
        gb_s=0.0, idle=idle)


def test_autoscaler_decisions():
    cfg = AutoscalerConfig(min_replicas=1, max_replicas=2,
                           queue_delay_up_s=0.1, sustain=2,
                           idle_gb_s_down=0.5, cooldown_s=1.0)
    sc = Autoscaler(cfg, resident_gb=1.0)
    # sustained queue delay scales up exactly once sustain is reached
    assert sc.observe(0.0, [_meters(0, delay=1.0)]) == (1, None)
    assert sc.observe(0.4, [_meters(0, delay=1.0)]) == (2, None)
    # cooldown gates the next decision even though the fleet is hot
    assert sc.observe(0.8, [_meters(0, delay=1.0),
                            _meters(1, delay=1.0)]) == (2, None)
    # at max_replicas there is no further scale-up
    assert sc.observe(2.0, [_meters(0, delay=1.0),
                            _meters(1, delay=1.0)]) == (2, None)
    assert sc.observe(2.2, [_meters(0, delay=1.0),
                            _meters(1, delay=1.0)]) == (2, None)
    # contiguous idle burn (dt * resident_gb) retires one replica...
    n, rid = sc.observe(4.0, [_meters(0, idle=True),
                              _meters(1, idle=True)])
    assert (n, rid) == (1, 1)              # max burn, ties to high rid
    # ...but never below min_replicas
    assert sc.observe(6.0, [_meters(0, idle=True)]) == (1, None)
    assert [e.action for e in sc.events] == ["up", "down"]


def test_autoscaler_idle_burn_resets_on_work():
    cfg = AutoscalerConfig(min_replicas=1, max_replicas=2,
                           queue_delay_up_s=9.0, sustain=2,
                           idle_gb_s_down=1.5, cooldown_s=0.0)
    sc = Autoscaler(cfg, resident_gb=1.0)
    sc.observe(0.0, [_meters(0), _meters(1, idle=True)])
    sc.observe(1.0, [_meters(0), _meters(1, idle=True)])   # burn 1.0
    # replica 1 does work: its contiguous-idle meter must reset
    sc.observe(2.0, [_meters(0), _meters(1)])
    n, rid = sc.observe(3.0, [_meters(0), _meters(1, idle=True)])
    assert rid is None                      # only 1.0 GB-s since reset
    n, rid = sc.observe(4.0, [_meters(0), _meters(1, idle=True)])
    assert rid == 1                         # 2.0 GB-s >= 1.5 now
