"""Async streaming serving gateway over the paged runtime (PyTorch port
of `repro.api`; stdlib only around the engine).

driver  (EngineDriver)  — the one thread that owns an engine, stepping it
                          on the engine's own CUDA stream; jobs +
                          done-watchers cross the thread boundary
gateway (Gateway)       — asyncio HTTP front door: SSE token streaming,
                          n>1 parallel sampling via KV fork,
                          cancellation on disconnect, 429 backpressure,
                          /metrics, /healthz, /debug/trace, /debug/slo
protocol                — request schema + SSE / minimal HTTP framing
"""
from .driver import EngineDriver
from .gateway import Gateway
from .protocol import (CompletionRequest, ProtocolError, iter_sse,
                       parse_completion, sse_event)

__all__ = ["EngineDriver", "Gateway", "CompletionRequest",
           "ProtocolError", "iter_sse", "parse_completion", "sse_event"]
