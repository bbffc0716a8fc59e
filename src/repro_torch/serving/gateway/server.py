"""Asyncio HTTP front door for the serving gateway (stdlib only).

A minimal HTTP/1.1 server on ``asyncio`` streams — no web framework,
no new dependency — exposing:

  * ``POST /v1/completions``       OpenAI-style, token-id prompts
  * ``POST /v1/chat/completions``  token-id message contents
  * ``GET  /healthz``              liveness + per-replica health
  * ``GET  /metrics``              Prometheus text exposition (the
    telemetry registry; replica gauges refreshed at scrape time)
  * ``GET  /metrics.json``         router/replica meters + scale events
    (the pre-telemetry JSON payload, unchanged shape)

``stream: true`` answers with SSE (``data: {...}`` frames, closed by
``data: [DONE]``), fed from the per-request asyncio queue the engine
driver's step hook fills across the thread boundary. A client
disconnect (socket EOF or a failed write) cancels the request —
the engine recycles its KV slot mid-decode. Backpressure surfaces as
HTTP 429 with a ``Retry-After`` header; validation failures as HTTP
400 with the OpenAI error body naming the offending field
(``error.param``). Request priority rides the ``x-priority`` header
onto the scheduler's priority lanes.

One request per connection (``Connection: close``) — the gateway's
concurrency story is server-side continuous batching, not client-side
connection reuse.
"""
from __future__ import annotations

import asyncio
import json
import time

import numpy as np

from repro_torch.serving.gateway.driver import Backpressure, FAIL_TOKEN
from repro_torch.serving.gateway.protocol import (
    RequestError, chunk_body, completion_body, parse_completion, sse_event,
    SSE_DONE)
from repro_torch.serving.gateway.router import Router
from repro_torch.serving.scheduler import GenRequest

_MAX_BODY = 8 << 20
_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable"}


def _response(status: int, body: bytes, *, content_type: str,
              extra: dict | None = None) -> bytes:
    head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
            "Connection: close"]
    for k, v in (extra or {}).items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _json_response(status: int, obj: dict,
                   extra: dict | None = None) -> bytes:
    return _response(status, json.dumps(obj).encode(),
                     content_type="application/json", extra=extra)


SSE_HEADER = (b"HTTP/1.1 200 OK\r\n"
              b"Content-Type: text/event-stream\r\n"
              b"Cache-Control: no-cache\r\n"
              b"Connection: close\r\n\r\n")


async def _read_request(reader: asyncio.StreamReader):
    """-> (method, path, headers, body) or None on EOF/garbage."""
    line = await reader.readline()
    if not line:
        return None
    parts = line.decode("latin-1").split()
    if len(parts) < 3:
        return None
    method, path = parts[0].upper(), parts[1]
    headers = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    try:
        length = int(headers.get("content-length", "0") or "0")
    except ValueError:
        raise RequestError(400, "invalid Content-Length header")
    if length < 0:
        raise RequestError(400, "invalid Content-Length header")
    if length > _MAX_BODY:
        raise RequestError(413, "request body too large")
    body = await reader.readexactly(length) if length else b""
    return method, path, headers, body


class GatewayServer:
    """The async gateway: HTTP server + router + periodic autoscaler."""

    def __init__(self, router: Router, *, host: str = "127.0.0.1",
                 port: int = 0, autoscale_interval_s: float = 0.25):
        self.router = router
        self.host = host
        self.port = port
        self.autoscale_interval_s = autoscale_interval_s
        self._server: asyncio.base_events.Server | None = None
        self._autoscale_task: asyncio.Task | None = None

    async def start(self) -> tuple[str, int]:
        """Bind and start serving; returns (host, actual_port)."""
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.autoscale_interval_s > 0 \
                and self.router.scaler_cfg.max_replicas \
                > self.router.scaler_cfg.min_replicas:
            self._autoscale_task = asyncio.create_task(
                self._autoscale_loop())
        return self.host, self.port

    async def close(self) -> None:
        if self._autoscale_task is not None:
            self._autoscale_task.cancel()
            self._autoscale_task = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        await self._server.serve_forever()

    async def _autoscale_loop(self) -> None:
        while True:
            await asyncio.sleep(self.autoscale_interval_s)
            try:
                self.router.autoscale(time.monotonic())
            except Exception as e:           # keep the loop alive
                print(f"[gateway] autoscale error: {e!r}")

    # ------------------------------------------------------- handling

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        t0 = time.perf_counter()
        route = "other"
        try:
            req = await _read_request(reader)
            if req is None:
                return
            method, path, headers, body = req
            if path in ("/healthz", "/metrics", "/metrics.json",
                        "/v1/completions", "/v1/chat/completions"):
                route = path   # bounded route label set
            if path == "/healthz" and method == "GET":
                writer.write(_json_response(200, self._health()))
            elif path == "/metrics" and method == "GET":
                writer.write(self._prometheus())
            elif path == "/metrics.json" and method == "GET":
                writer.write(_json_response(200, self.router.metrics()))
            elif path in ("/v1/completions", "/v1/chat/completions"):
                if method != "POST":
                    writer.write(_json_response(
                        405, RequestError(405, "use POST").body()))
                else:
                    await self._completion(
                        reader, writer, headers, body,
                        chat=path.endswith("/chat/completions"))
            else:
                writer.write(_json_response(
                    404, RequestError(404, f"no route {path}").body()))
            await writer.drain()
        except RequestError as e:
            await self._send_error(writer, e)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception as e:
            await self._send_error(
                writer, RequestError(500, f"internal error: {e!r}",
                                     etype="server_error"))
        finally:
            tel = self.router.telemetry
            if tel.enabled:
                tel.router_http_seconds.labels(route=route).observe(
                    time.perf_counter() - t0)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _send_error(self, writer, err: RequestError) -> None:
        try:
            extra = {}
            if err.retry_after is not None:
                extra["Retry-After"] = f"{err.retry_after:g}"
            writer.write(_json_response(err.status, err.body(),
                                        extra=extra))
            await writer.drain()
        except (ConnectionError, OSError):
            pass

    def _prometheus(self) -> bytes:
        """Render the telemetry registry as text exposition 0.0.4,
        refreshing the per-replica gauges first. With telemetry
        disabled, serves an empty (but valid) exposition."""
        self.router.refresh_telemetry()
        registry = self.router.telemetry.registry
        text = registry.render_prometheus() if registry is not None \
            else "# telemetry disabled\n"
        return _response(
            200, text.encode(),
            content_type="text/plain; version=0.0.4; charset=utf-8")

    def _health(self) -> dict:
        live = self.router.live_replicas()
        return {"status": "ok" if live else "unhealthy",
                "replicas": {d.replica_id: d.healthy
                             for d in self.router.replicas.values()}}

    # ---------------------------------------------------- completions

    async def _completion(self, reader, writer, headers: dict,
                          raw: bytes, *, chat: bool) -> None:
        try:
            body = json.loads(raw.decode() or "null")
        except (json.JSONDecodeError, UnicodeDecodeError):
            raise RequestError(400, "request body is not valid JSON")
        try:
            priority = int(headers.get("x-priority", "0"))
        except ValueError:
            raise RequestError(400, "x-priority must be an integer",
                               param="x-priority")
        creq = parse_completion(body, chat=chat, priority=priority)
        rid = self.router.next_rid()
        gen = GenRequest(rid=rid, arrival=float("nan"),
                         prompt=np.asarray(creq.prompt, np.int32),
                         max_new_tokens=creq.max_tokens,
                         sampling=creq.sampling)
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def sink(ev):   # called from the step thread, under engine lock
            loop.call_soon_threadsafe(queue.put_nowait, ev)

        try:
            driver, handle = self.router.submit(gen, sink=sink)
        except Backpressure as e:
            raise RequestError(
                429, str(e), etype="rate_limit_exceeded",
                retry_after=e.retry_after) from None
        if handle.status == "rejected":
            raise RequestError(
                400, f"prompt ({len(creq.prompt)} tokens) + max_tokens "
                     f"({creq.max_tokens}) exceed the replica's KV slot "
                     f"capacity ({driver.engine.max_len} tokens)",
                param="max_tokens")
        req_id = f"{'chatcmpl' if chat else 'cmpl'}-{rid}"
        created = int(time.time())
        # a task that resolves when the client goes away: clients send
        # nothing after the body, so the next read only returns (EOF) or
        # fails once the peer closes — our cue to cancel mid-decode
        disconnected = asyncio.create_task(reader.read(1))
        try:
            if creq.stream:
                await self._stream(writer, driver, handle, creq, req_id,
                                   created, queue, disconnected)
            else:
                await self._unary(writer, driver, handle, creq, req_id,
                                  created, queue, disconnected)
        finally:
            disconnected.cancel()

    async def _next_event(self, queue, disconnected):
        """Next token event, or None the moment the client disconnects."""
        get = asyncio.create_task(queue.get())
        done, _ = await asyncio.wait(
            {get, disconnected}, return_when=asyncio.FIRST_COMPLETED)
        if get in done:
            return get.result()
        get.cancel()
        return None

    async def _unary(self, writer, driver, handle, creq, req_id, created,
                     queue, disconnected) -> None:
        tokens: list[int] = []
        while True:
            ev = await self._next_event(queue, disconnected)
            if ev is None:                      # client gone: free the slot
                self.router.cancel(driver, handle)
                return
            if ev.token >= 0:
                tokens.append(int(ev.token))
            if ev.done:
                break
        if ev.token == FAIL_TOKEN \
                or handle.finish_reason == "replica_failed":
            # the replica died mid-request: partial tokens are NOT a
            # success — surface a 5xx, never finish_reason "cancelled"
            raise RequestError(
                503, f"replica failed mid-request "
                     f"({len(tokens)} tokens generated)",
                etype="server_error")
        reason = handle.finish_reason or "cancelled"
        if reason == "cancelled" and not tokens:
            raise RequestError(503, "request cancelled server-side",
                               etype="server_error")
        m = handle.metrics()
        writer.write(_json_response(200, completion_body(
            req_id, creq, tokens, reason, created,
            metrics={"ttft_s": m.ttft, "tpot_s": m.tpot, "e2e_s": m.e2e,
                     "replica": driver.replica_id})))
        await writer.drain()

    async def _stream(self, writer, driver, handle, creq, req_id, created,
                      queue, disconnected) -> None:
        writer.write(SSE_HEADER)
        await writer.drain()
        try:
            while True:
                ev = await self._next_event(queue, disconnected)
                if ev is None:
                    self.router.cancel(driver, handle)
                    return
                if ev.token >= 0:
                    writer.write(sse_event(chunk_body(
                        req_id, creq, int(ev.token), None, created)))
                    await writer.drain()
                if ev.done:
                    break
            # the SSE 200 is already on the wire — a replica failure
            # surfaces as an explicit terminal finish_reason instead
            reason = "replica_failed" if ev.token == FAIL_TOKEN \
                else handle.finish_reason or "cancelled"
            writer.write(sse_event(chunk_body(req_id, creq, None, reason,
                                              created)))
            writer.write(SSE_DONE)
            await writer.drain()
        except (ConnectionError, OSError):
            # mid-stream disconnect caught on write: recycle the slot
            self.router.cancel(driver, handle)
