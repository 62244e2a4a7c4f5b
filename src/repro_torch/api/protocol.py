"""Wire schema for the streaming gateway: request parsing, SSE framing.

The gateway speaks an OpenAI-style completions dialect over token ids —
this repo has no tokenizer, so `prompt` is a list of int token ids (the
same currency every benchmark and test in the repo trades in).  Parsing
is strict and total: every malformed field maps to a `ProtocolError`
with a client-usable message, never a traceback through the engine.

SSE framing follows the EventSource spec's `data:` lines.  The stream
carries one JSON event per sampled token (`{"index", "token"}`), one
finish event per sample index (`{"index", "finish_reason"}`), and a
final `[DONE]` sentinel — byte-parseable with `iter_sse` below, which
the load benchmark and the e2e tests both use.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple


class ProtocolError(ValueError):
    """Client error: maps to HTTP 400 with `.message` as the body."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


@dataclass
class CompletionRequest:
    """Validated `POST /v1/completions` body."""
    prompt: List[int]
    max_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    n: int = 1                       # parallel samples (KV fork-shared)
    stream: bool = True
    priority: int = 0
    deadline_s: Optional[float] = None
    spec: bool = True                # opt out of speculative decoding
    logprobs: bool = False           # per-token logprob + entropy in the
    #   stream / response (host-side O(vocab) per token when on)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ProtocolError(msg)


def parse_completion(body: bytes, *, vocab: Optional[int] = None,
                     max_n: int = 8,
                     max_prompt_len: Optional[int] = None
                     ) -> CompletionRequest:
    """Parse + validate a completions body; raises ProtocolError with a
    message safe to return to the client."""
    try:
        obj = json.loads(body.decode("utf-8") if body else "")
    except (ValueError, UnicodeDecodeError):
        raise ProtocolError("body is not valid JSON")
    _require(isinstance(obj, dict), "body must be a JSON object")

    prompt = obj.get("prompt")
    _require(isinstance(prompt, list) and len(prompt) > 0,
             "'prompt' must be a non-empty list of int token ids")
    _require(all(isinstance(t, int) and not isinstance(t, bool)
                 and t >= 0 for t in prompt),
             "'prompt' tokens must be non-negative ints")
    if vocab is not None:
        _require(all(t < vocab for t in prompt),
                 f"'prompt' token id out of range (vocab={vocab})")
    if max_prompt_len is not None:
        _require(len(prompt) < max_prompt_len,
                 f"'prompt' longer than max_seq-1 ({max_prompt_len - 1})")

    def _num(key, default, lo, hi, cast, kind):
        v = obj.get(key, default)
        _require(isinstance(v, (int, float)) and not isinstance(v, bool)
                 and math.isfinite(v) and lo <= v <= hi,
                 f"'{key}' must be a {kind} in [{lo}, {hi}]")
        return cast(v)

    req = CompletionRequest(
        prompt=list(prompt),
        max_tokens=_num("max_tokens", 16, 1, 1 << 20, int, "int"),
        temperature=_num("temperature", 0.0, 0.0, 1e3, float, "number"),
        top_k=_num("top_k", 0, 0, 1 << 20, int, "int"),
        top_p=_num("top_p", 1.0, 0.0, 1.0, float, "number"),
        n=_num("n", 1, 1, max_n, int, "int"),
        priority=_num("priority", 0, -(1 << 16), 1 << 16, int, "int"),
    )
    for key, default in (("stream", True), ("spec", True),
                         ("logprobs", False)):
        v = obj.get(key, default)       # strict bools: a JS client's
        _require(isinstance(v, bool),   # "false" string must 400, not
                 f"'{key}' must be a bool")     # silently invert its
        setattr(req, key, v)                    # meaning
    dl = obj.get("deadline_s")
    if dl is not None:
        _require(isinstance(dl, (int, float)) and not isinstance(dl, bool)
                 and math.isfinite(dl) and dl > 0,
                 "'deadline_s' must be a positive number")
        req.deadline_s = float(dl)
    return req


# ----------------------------------------------------------------------------
# SSE framing
# ----------------------------------------------------------------------------
DONE_SENTINEL = "[DONE]"


def sanitize(obj):
    """NaN/inf -> None recursively: the /metrics and SSE payloads must
    stay strict-JSON parseable for non-Python clients (json.dumps would
    happily emit bare NaN)."""
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def sse_event(obj: Dict) -> bytes:
    return b"data: " + json.dumps(sanitize(obj),
                                  separators=(",", ":")).encode() + b"\n\n"


def sse_done() -> bytes:
    return f"data: {DONE_SENTINEL}\n\n".encode()


def iter_sse(payload: bytes) -> Iterator[Dict]:
    """Parse a complete SSE byte stream into its JSON events (the
    `[DONE]` sentinel is consumed, not yielded).  Shared by the load
    generator and the e2e tests so both exercise the real framing."""
    for block in payload.split(b"\n\n"):
        line = block.strip()
        if not line.startswith(b"data: "):
            continue
        data = line[len(b"data: "):]
        if data.decode("utf-8", "replace") == DONE_SENTINEL:
            return
        yield json.loads(data)


# ----------------------------------------------------------------------------
# minimal HTTP/1.1 framing (stdlib-only; shared by server and clients)
# ----------------------------------------------------------------------------
def http_response(status: int, reason: str, headers: Dict[str, str],
                  body: bytes = b"") -> bytes:
    lines = [f"HTTP/1.1 {status} {reason}"]
    hdrs = dict(headers)
    hdrs.setdefault("Connection", "close")
    if body:
        hdrs.setdefault("Content-Length", str(len(body)))
    lines += [f"{k}: {v}" for k, v in hdrs.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + body


def json_response(status: int, reason: str, obj: Dict,
                  headers: Optional[Dict[str, str]] = None) -> bytes:
    body = json.dumps(sanitize(obj), indent=1).encode()
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    return http_response(status, reason, hdrs, body)


def error_response(status: int, reason: str, message: str,
                   headers: Optional[Dict[str, str]] = None) -> bytes:
    return json_response(status, reason,
                         {"error": {"message": message,
                                    "type": reason.lower().replace(" ",
                                                                   "_")}},
                         headers)


async def read_http_request(reader) -> Tuple[str, str, Dict[str, str],
                                             bytes]:
    """Read one HTTP/1.1 request from an asyncio StreamReader:
    (method, path, headers, body).  Raises ProtocolError on framing it
    cannot serve; raises asyncio.IncompleteReadError / ConnectionError
    on a socket that died mid-request (callers treat that as a
    disconnect, not a client error)."""
    try:
        request_line = await reader.readline()
    except ValueError:      # StreamReader limit overrun: line too long
        raise ProtocolError("request line too long")
    if not request_line:
        raise ConnectionError("client closed before sending a request")
    parts = request_line.decode("latin-1").split()
    if len(parts) != 3:
        raise ProtocolError("malformed request line")
    method, path = parts[0].upper(), parts[1]
    headers: Dict[str, str] = {}
    for _ in range(256):            # cap header LINES: an endless (or
        try:                        # colon-less) header stream must not
            line = await reader.readline()      # be read forever
        except ValueError:
            raise ProtocolError("header line too long")
        if line in (b"\r\n", b"\n", b""):
            break
        if b":" in line:
            k, v = line.decode("latin-1").split(":", 1)
            headers[k.strip().lower()] = v.strip()
    else:
        raise ProtocolError("too many headers")
    length = headers.get("content-length", "0")
    try:
        n = int(length)
    except ValueError:
        raise ProtocolError("bad Content-Length")
    if n < 0 or n > (1 << 22):
        raise ProtocolError("bad Content-Length")
    body = await reader.readexactly(n) if n else b""
    return method, path, headers, body
