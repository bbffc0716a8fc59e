"""Wire protocol for the OpenAI-compatible serving gateway.

The gateway speaks OpenAI-style JSON over HTTP — `POST /v1/completions`
and `POST /v1/chat/completions` — with TOKEN-ID prompts (this repo
serves randomly-initialised reproduction models; there is no
tokenizer). Concretely:

  * completions: ``{"prompt": [1, 2, 3], "max_tokens": 16, ...}`` where
    `prompt` is one flat list of token ids (batched prompts are
    rejected — one request per sequence, continuous batching happens
    server-side);
  * chat: ``{"messages": [{"role": "user", "content": [1, 2, 3]}]}``
    where each message's `content` is a list of token ids; the prompt
    is the concatenation in message order;
  * ``stop`` is one token-id sequence (``[5, 6]``) or a list of them
    (``[[5, 6], [7]]``);
  * ``stream: true`` selects SSE chunks (``data: {...}\\n\\n`` frames,
    terminated by ``data: [DONE]``);
  * sampling fields (`temperature`, `top_p`, `top_k`, `seed`) map onto
    the engine's frozen ``SamplingParams`` — `temperature` defaults to
    0.0 (greedy), matching the engine, NOT OpenAI's 1.0;
  * request priority rides the ``x-priority`` header (an int; higher
    wins admission on the scheduler's priority lanes).

Validation failures surface as ``RequestError`` carrying an HTTP
status and an OpenAI-style body ``{"error": {"message", "type",
"param", "code"}}`` — engine-side ``SamplingValidationError``s map to
the same shape with the offending field in ``param``.

Everything here is pure data <-> data: no sockets, no engine — unit
testable without a server.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

from repro_torch.serving.scheduler import (SamplingParams,
                                          SamplingValidationError)


class RequestError(Exception):
    """Structured HTTP error with an OpenAI-style JSON body."""

    def __init__(self, status: int, message: str, *, param: str | None = None,
                 etype: str = "invalid_request_error",
                 retry_after: float | None = None):
        self.status = status
        self.message = message
        self.param = param
        self.etype = etype
        self.retry_after = retry_after
        super().__init__(message)

    def body(self) -> dict:
        return {"error": {"message": self.message, "type": self.etype,
                          "param": self.param, "code": self.status}}


def _token_list(value, param: str) -> tuple[int, ...]:
    if not isinstance(value, (list, tuple)) or len(value) == 0 \
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in value):
        raise RequestError(
            400, f"{param} must be a non-empty list of token ids (ints) — "
                 "this gateway serves token-id prompts (no tokenizer)",
            param=param)
    return tuple(int(t) for t in value)


def _parse_stop(value) -> tuple:
    """`stop`: one token-id sequence or a list of them."""
    if value is None:
        return ()
    if not isinstance(value, (list, tuple)) or len(value) == 0:
        raise RequestError(400, "stop must be a token-id sequence or a "
                                "list of token-id sequences", param="stop")
    if all(isinstance(t, int) and not isinstance(t, bool) for t in value):
        return (tuple(value),)
    return tuple(_token_list(s, "stop") for s in value)


def _number(body: dict, name: str, default, *, integer: bool = False):
    v = body.get(name, default)
    if v is None:
        return default
    ok = isinstance(v, int) and not isinstance(v, bool) if integer \
        else isinstance(v, (int, float)) and not isinstance(v, bool)
    if not ok:
        kind = "an integer" if integer else "a number"
        raise RequestError(400, f"{name} must be {kind}, got {v!r}",
                           param=name)
    return v


@dataclass(frozen=True)
class CompletionRequest:
    """A parsed, validated completion/chat request, engine-ready."""
    prompt: tuple        # token ids
    max_tokens: int
    sampling: SamplingParams
    stream: bool
    chat: bool
    model: str


def parse_completion(body, *, chat: bool,
                     priority: int = 0) -> CompletionRequest:
    """Validate a decoded JSON body into a ``CompletionRequest``;
    raises ``RequestError`` (HTTP 400) naming the offending field."""
    if not isinstance(body, dict):
        raise RequestError(400, "request body must be a JSON object")
    if chat:
        msgs = body.get("messages")
        if not isinstance(msgs, list) or len(msgs) == 0:
            raise RequestError(400, "messages must be a non-empty list",
                               param="messages")
        parts = []
        for i, m in enumerate(msgs):
            if not isinstance(m, dict) or "content" not in m:
                raise RequestError(
                    400, f"messages[{i}] must be an object with a "
                         "'content' list of token ids",
                    param=f"messages[{i}]")
            parts.extend(_token_list(m["content"],
                                     f"messages[{i}].content"))
        prompt = tuple(parts)
    else:
        if isinstance(body.get("prompt"), list) \
                and body["prompt"] and isinstance(body["prompt"][0], list):
            raise RequestError(
                400, "batched prompts are not supported — submit one "
                     "request per sequence (the server batches "
                     "continuously)", param="prompt")
        prompt = _token_list(body.get("prompt"), "prompt")
    max_tokens = _number(body, "max_tokens", 16, integer=True)
    if max_tokens < 1:
        raise RequestError(400, f"max_tokens must be >= 1, got {max_tokens}",
                           param="max_tokens")
    seed = _number(body, "seed", None, integer=True)
    try:
        sampling = SamplingParams(
            temperature=float(_number(body, "temperature", 0.0)),
            top_k=int(_number(body, "top_k", 0, integer=True)),
            top_p=float(_number(body, "top_p", 1.0)),
            seed=None if seed is None else int(seed),
            stop=_parse_stop(body.get("stop")),
            priority=int(priority))
    except SamplingValidationError as e:
        raise RequestError(400, e.message, param=e.param) from None
    stream = body.get("stream", False)
    if not isinstance(stream, bool):
        raise RequestError(400, "stream must be a boolean", param="stream")
    return CompletionRequest(
        prompt=prompt, max_tokens=int(max_tokens), sampling=sampling,
        stream=stream, chat=chat,
        model=str(body.get("model", "repro")))


# ---------------------------------------------------------- responses

def _choice(tokens: list[int], finish_reason: str | None, *, chat: bool,
            delta: bool = False) -> dict:
    """One `choices[0]` entry. Token ids are the canonical payload
    (`tokens`); `text` carries them space-joined for curl-friendliness."""
    text = " ".join(str(t) for t in tokens)
    if chat:
        msg = {"role": "assistant", "content": list(tokens)}
        body = {"delta" if delta else "message": msg}
    else:
        body = {"text": text, "tokens": list(tokens)}
    return {"index": 0, "finish_reason": finish_reason, **body}


def completion_body(req_id: str, creq: CompletionRequest, tokens: list[int],
                    finish_reason: str, created: int,
                    metrics: dict | None = None) -> dict:
    obj = "chat.completion" if creq.chat else "text_completion"
    body = {
        "id": req_id, "object": obj, "created": created,
        "model": creq.model,
        "choices": [_choice(tokens, finish_reason, chat=creq.chat)],
        "usage": {"prompt_tokens": len(creq.prompt),
                  "completion_tokens": len(tokens),
                  "total_tokens": len(creq.prompt) + len(tokens)},
    }
    if metrics is not None:
        body["metrics"] = metrics
    return body


def chunk_body(req_id: str, creq: CompletionRequest, token: int | None,
               finish_reason: str | None, created: int) -> dict:
    obj = "chat.completion.chunk" if creq.chat else "text_completion.chunk"
    tokens = [] if token is None else [int(token)]
    return {"id": req_id, "object": obj, "created": created,
            "model": creq.model,
            "choices": [_choice(tokens, finish_reason, chat=creq.chat,
                                delta=True)]}


def sse_event(obj: dict) -> bytes:
    return b"data: " + json.dumps(obj, separators=(",", ":")).encode() \
        + b"\n\n"


SSE_DONE = b"data: [DONE]\n\n"
