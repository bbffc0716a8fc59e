"""OpenAI-compatible async serving gateway.

Layers (each importable alone):

  * ``protocol`` — OpenAI-style JSON <-> engine types (token-id
    prompts, SSE framing, structured 400 errors);
  * ``driver``   — one replica: a ``ServingEngine`` session behind a
    background step-loop thread with event fan-out, backpressure, and
    cancel-on-disconnect;
  * ``router``   — least-outstanding-tokens load balancing over N
    replicas + the meter-driven autoscaler (queue-delay scale-up,
    idle-GB-s scale-down);
  * ``server``   — the stdlib asyncio HTTP/SSE front door.
"""
from repro_torch.serving.gateway.driver import (CANCEL_TOKEN,  # noqa: F401
                                                FAIL_TOKEN, Backpressure,
                                                EngineDriver, ReplicaMeters)
from repro_torch.serving.gateway.protocol import (  # noqa: F401
    CompletionRequest, RequestError, parse_completion)
from repro_torch.serving.gateway.router import (Autoscaler,  # noqa: F401
                                                AutoscalerConfig, Router,
                                                ScaleEvent)
from repro_torch.serving.gateway.server import GatewayServer  # noqa: F401
