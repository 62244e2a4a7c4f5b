"""Async streaming gateway over a fleet of `PagedServeEngine` replicas
(PyTorch port of `repro.api.gateway`).

This is the online front door the offline runtime was missing: traffic
arrives asynchronously, tokens stream back as they decode, and clients
disconnect whenever they like — the regime where edge-inference
latency/energy trade-offs actually bite.

Threading model: the asyncio event loop owns sockets, parsing, and
ROUTING; each replica's `EngineDriver` thread owns its engine.  A
request crosses over exactly twice — submission (a driver job on the
replica the router picked) and per-token fan-out
(`loop.call_soon_threadsafe` into the request's asyncio.Queue) — so
every engine stays lock-free and the event loop never blocks on the
card.

The gateway itself holds no engine state: it speaks only to a
`repro_torch.fleet.FleetRouter` (a single engine is wrapped in a one-replica
fleet, which keeps the classic `Gateway(engine)` construction — and
its semantics — unchanged).  Scale-out is `Gateway(FleetRouter([...]))`
with a dispatch policy; see repro_torch/fleet/.  The replicas may share
one card and one copy of the packed weights: each engine steps on its
own driver thread and CUDA stream.

Endpoints:
  POST /v1/completions   token-id prompt -> SSE token stream (or one
                         JSON body with stream=false).  `n > 1` samples
                         share the prompt's KV pages via
                         `PagedKVCache.fork` (copy-on-write tails) and
                         always land on ONE replica.  `logprobs=true`
                         adds per-token logprob + entropy.
  GET  /metrics          fleet-aggregated engine summary + latency
                         histograms + per-replica breakdown + gateway
                         counters, strict JSON.
  GET  /healthz          liveness: 200 while >= 1 replica serves, 503
                         only when the whole fleet is down.  With SLOs
                         configured, `degraded: true` while any alert
                         state machine sits at `page` — orchestrators
                         distinguish "up" from "meeting objectives"
                         without killing a serving replica.
  GET  /debug/slo        SLO objectives + burn-rate alert states +
                         recent transitions + per-replica drift audit
                         (obs/slo.py, obs/drift.py).  The gateway runs
                         the evaluation loop (`FleetRouter.poll_slo`)
                         as a background task while serving.

Overload: admission is fleet-level load shedding — a request is 429'd
(honest Retry-After from the least-loaded replica's measured decode
rate) only when EVERY live replica is at its per-replica pending cap,
so open-loop arrivals cannot OOM any paged pool from the outside.

Cancellation: a client that disconnects mid-stream (or mid-prefill)
aborts its samples on whichever replica currently owns them, which
frees KV pages and lanes and decrefs (never frees) shared prefix pages.
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs

import numpy as np

from repro_torch.obs.export import chrome_trace, prometheus_text
from repro_torch.obs.trace import get_tracer

from .protocol import (CompletionRequest, ProtocolError, error_response,
                       http_response, json_response, parse_completion,
                       read_http_request, sse_done, sse_event)

_SSE_HEADERS = (b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: text/event-stream\r\n"
                b"Cache-Control: no-cache\r\n"
                b"Connection: close\r\n\r\n")

# bumped whenever the /metrics JSON payload changes shape, so
# check_bench.py and external scrapers can detect format drift instead
# of misreading renamed keys.  v2: added schema_version itself, the
# sim_* energy metrics, and the fleet aggregation of both.  v3: fleet
# percentiles recomputed from merged quantile sketches (empty metrics
# now ABSENT instead of NaN), per-replica `drift` audit blocks, and the
# optional top-level `slo` section.
METRICS_SCHEMA_VERSION = 3


def _finish_reason(req, eos_id: Optional[int]) -> str:
    if req.cancelled:
        return "cancelled"
    if req.rejected:
        return "rejected"
    if req.truncated:
        return "truncated"
    if (eos_id is not None and req.out_tokens
            and req.out_tokens[-1] == eos_id):
        return "stop"
    return "length"


class Gateway:
    """Serve an already-built engine or fleet.  The gateway takes
    ownership of stepping: nothing else may call `engine.step()`/`run()`
    on any replica while the gateway is running."""

    def __init__(self, engine_or_router, *, max_pending: Optional[int] = None,
                 max_n: int = 8, access_log=None, slos=None,
                 slo_policy=None, slo_poll_s: float = 0.25):
        """`slos`: optional SLO spec strings / `SLOSpec`s (obs/slo.py)
        installed on the router; the gateway then runs the burn-rate +
        drift evaluation loop every `slo_poll_s` while serving.
        `slo_policy` overrides the `BurnRatePolicy` (timescale!)."""
        assert (max_pending is None or max_pending >= 0) and max_n >= 1
        # deferred: repro_torch.fleet pulls in repro_torch.api.driver,
        # whose package __init__ imports this module — a top-level import
        # would cycle
        from repro_torch.fleet import FleetRouter
        if isinstance(engine_or_router, FleetRouter):
            self.router = engine_or_router
        else:       # classic single-engine construction: a fleet of one
            # max_pending None defers to the engine's ServeConfig
            self.router = FleetRouter([engine_or_router],
                                      policy="least-loaded",
                                      max_pending=max_pending)
        self.max_n = max_n
        # n>1 rides PagedKVCache.fork, an attention-only capability;
        # recurrent-state families serve n independent lanes instead
        self._can_fork = self.engine.model.supports_paged()
        self.counters: Dict[str, int] = {
            "http_requests": 0, "accepted_samples": 0, "rejected_429": 0,
            "bad_requests": 0, "disconnects": 0, "completed_samples": 0}
        self._server: Optional[asyncio.AbstractServer] = None
        self.tracer = get_tracer()
        self.slo_poll_s = slo_poll_s
        self._slo_task: Optional[asyncio.Task] = None
        if slos:
            self.router.set_slos(slos, policy=slo_policy)
        # structured access log: one JSON line per /v1/completions
        # request (path string or an open file-like); None = silent
        self._access_log = None
        self._access_log_own = False
        if access_log is not None:
            if hasattr(access_log, "write"):
                self._access_log = access_log
            else:
                self._access_log = open(access_log, "a")
                self._access_log_own = True

    def _log_access(self, **fields) -> None:
        if self._access_log is None:
            return
        self._access_log.write(
            json.dumps(fields, separators=(",", ":")) + "\n")
        self._access_log.flush()

    # -- single-engine compatibility surface ---------------------------
    @property
    def engine(self):
        """Replica 0's engine: model metadata (vocab, max_seq, eos) is
        identical fleet-wide by FleetRouter's construction contract."""
        return self.router.replicas[0].engine

    @property
    def driver(self):
        """Replica 0's driver (the classic one-engine handle; fleet
        code should address `router.replicas[i].driver`)."""
        return self.router.replicas[0].driver

    @property
    def _inflight(self) -> int:
        return sum(rep.pending for rep in self.router.replicas)

    @property
    def max_pending(self) -> int:
        """Fleet admission capacity in samples (sum of per-replica
        caps)."""
        return sum(rep.max_pending for rep in self.router.replicas)

    # -- lifecycle ------------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 0
                    ) -> Tuple[str, int]:
        self.router.start()
        self._server = await asyncio.start_server(self._handle, host,
                                                  port)
        # evaluation heartbeat: drift audit always, burn-rate alerting
        # when SLOs are configured.  A poll reads only lock-free
        # published snapshots, so this costs microseconds per tick.
        self._slo_task = asyncio.get_running_loop().create_task(
            self._slo_loop())
        sock = self._server.sockets[0].getsockname()
        return sock[0], sock[1]

    async def _slo_loop(self) -> None:
        while True:
            await asyncio.sleep(self.slo_poll_s)
            try:
                self.router.poll_slo()
            except Exception:
                # observability must never take down serving; the next
                # tick retries
                pass

    async def stop(self) -> None:
        if self._slo_task is not None:
            self._slo_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._slo_task
            self._slo_task = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        # router.stop() joins every engine thread (a mid-flight jitted
        # step can take seconds): keep it off the event loop
        await asyncio.get_running_loop().run_in_executor(
            None, self.router.stop)
        if self._access_log_own and self._access_log is not None:
            self._access_log.close()
            self._access_log = None

    async def serve_forever(self, host: str = "127.0.0.1",
                            port: int = 8151) -> None:
        h, p = await self.start(host, port)
        print(f"[api] gateway listening on http://{h}:{p} "
              f"(POST /v1/completions, GET /metrics; "
              f"{len(self.router.replicas)} replica(s), "
              f"policy={self.router.policy.name})")
        try:
            await self._server.serve_forever()
        finally:
            await self.stop()

    # -- connection handling -------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self.counters["http_requests"] += 1
        try:
            try:
                method, path, _, body = await read_http_request(reader)
            except ProtocolError as e:
                self.counters["bad_requests"] += 1
                writer.write(error_response(400, "Bad Request", e.message))
                return
            except (ConnectionError, asyncio.IncompleteReadError,
                    asyncio.LimitOverrunError):
                return
            route, _, query = path.partition("?")
            qs = parse_qs(query) if query else {}
            if method == "POST" and route == "/v1/completions":
                await self._completions(body, reader, writer)
            elif method == "GET" and route in ("/metrics", "/v1/metrics"):
                payload = await self._metrics()
                if qs.get("format", [""])[0] == "prometheus":
                    text = prometheus_text(payload)
                    writer.write(http_response(
                        200, "OK",
                        {"Content-Type":
                         "text/plain; version=0.0.4; charset=utf-8"},
                        text.encode()))
                else:
                    writer.write(json_response(200, "OK", payload))
            elif method == "GET" and route == "/debug/trace":
                # Chrome trace-event JSON of everything the process
                # tracer holds — load the body directly in Perfetto.
                # 404 (not an empty trace) when tracing is off, so a
                # misconfigured capture fails loudly.
                if not self.tracer.enabled:
                    writer.write(error_response(
                        404, "Not Found",
                        "tracing disabled: start with --trace or "
                        "REPRO_TRACE=1"))
                else:
                    writer.write(json_response(
                        200, "OK", chrome_trace(self.tracer)))
            elif method == "GET" and route == "/debug/slo":
                # objectives, burn rates, alert states, transitions,
                # per-replica drift audit — always 200: with no SLOs
                # configured the body says so (worst "ok", empty specs)
                # rather than 404ing a legitimate health question
                writer.write(json_response(
                    200, "OK", self.router.slo_payload()))
            elif method == "GET" and path == "/healthz":
                # fleet liveness: 200 while any replica serves (a probe
                # must not kill a gateway that is degraded, not down);
                # 503 — never 200-with-false — once the whole fleet is
                # dead, so a status-code probe sees the failure
                alive = self.router.alive
                errors = {str(rep.id): repr(rep.error)
                          for rep in self.router.replicas
                          if rep.error is not None}
                # degraded: serving, but some SLO state machine sits at
                # `page` — still 200 (a liveness probe must not kill a
                # slow-but-serving fleet); orchestrators that care read
                # the flag or /debug/slo
                worst = self.router.worst_alert_level()
                body = {"ok": alive,
                        "degraded": bool(alive and worst == "page"),
                        "slo_worst": worst,
                        "n_live": self.router.n_live,
                        "n_replicas": len(self.router.replicas),
                        "error": errors or None}
                writer.write(json_response(200 if alive else 503,
                                           "OK" if alive
                                           else "Service Unavailable",
                                           body))
            else:
                writer.write(error_response(404, "Not Found",
                                            f"no route {method} {path}"))
        except (ConnectionResetError, BrokenPipeError):
            self.counters["disconnects"] += 1
        finally:
            with contextlib.suppress(Exception):
                if not writer.is_closing():
                    await writer.drain()
                writer.close()
                await writer.wait_closed()

    # -- /v1/completions -----------------------------------------------
    def _build_requests(self, creq: CompletionRequest, q: asyncio.Queue,
                        loop) -> List:
        from repro_torch.serve import SamplingParams, ServeRequest
        sampling = SamplingParams(temperature=creq.temperature,
                                  top_k=creq.top_k, top_p=creq.top_p)
        reqs_by_rid: Dict[int, object] = {}

        if creq.logprobs:
            def on_token(rid: int, tok: int) -> None:  # driver thread
                # _emit appended this token's (logprob, entropy) just
                # before calling us, so the tail entry is ours — capture
                # it NOW (driver thread), not when the queue drains
                lp, ent = reqs_by_rid[rid].out_logprobs[-1]
                loop.call_soon_threadsafe(q.put_nowait,
                                          ("token", rid, (tok, lp, ent)))
        else:
            def on_token(rid: int, tok: int) -> None:  # driver thread
                loop.call_soon_threadsafe(q.put_nowait,
                                          ("token", rid, tok))

        prompt = np.asarray(creq.prompt, np.int32)
        primary = ServeRequest(prompt=prompt,
                               max_new_tokens=creq.max_tokens, rid=0,
                               priority=creq.priority,
                               deadline_s=creq.deadline_s,
                               sampling=sampling, spec=creq.spec,
                               logprobs=creq.logprobs,
                               on_token=on_token)
        reqs = [primary]
        for i in range(1, creq.n):
            reqs.append(ServeRequest(
                prompt=prompt.copy(), max_new_tokens=creq.max_tokens,
                rid=i, priority=creq.priority, deadline_s=creq.deadline_s,
                sampling=sampling, spec=creq.spec,
                logprobs=creq.logprobs, on_token=on_token,
                fork_from=primary if self._can_fork else None))
        for r in reqs:
            reqs_by_rid[r.rid] = r
        return reqs

    async def _completions(self, body: bytes,
                           reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        t_arrive = time.monotonic()
        try:
            creq = parse_completion(body, vocab=self.engine.model.cfg.vocab,
                                    max_n=self.max_n,
                                    max_prompt_len=self.engine.max_seq)
        except ProtocolError as e:
            self.counters["bad_requests"] += 1
            self._log_access(rid=None, status=400, reason=e.message)
            writer.write(error_response(400, "Bad Request", e.message))
            return
        if not self.router.alive:
            # fail fast: submitting to a dead fleet would hang this
            # handler forever and leak the admission budget
            self._log_access(rid=None, status=503,
                             reason="engine driver not running")
            writer.write(error_response(
                503, "Service Unavailable", "engine driver not running"))
            return

        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def on_done(req) -> None:                     # driver thread
            loop.call_soon_threadsafe(self._sample_done, q, req)

        prompt = np.asarray(creq.prompt, np.int32)
        reqs = self._build_requests(creq, q, loop)
        # process-unique tracing ids, assigned before submission so the
        # engine's span events carry them; reqs[0]'s id labels the
        # whole group in the access log and the gateway lifecycle span
        for r in reqs:
            r.trace_id = self.tracer.next_request_id()
        rid0 = reqs[0].trace_id
        if self.tracer.enabled:
            self.tracer.instant("request_arrive", cat="gateway",
                                rid=rid0,
                                rids=[r.trace_id for r in reqs],
                                n=creq.n, prompt_len=len(creq.prompt),
                                stream=creq.stream)
        # route -> dispatch, retrying on a replica that died between the
        # pick and the submit; accounting (pending + accepted_samples)
        # moves BEFORE the await so a burst of concurrent arrivals sees
        # each other's reservations — admission is event-loop-side state
        while True:
            rep = self.router.route(prompt, creq.n)
            if rep is None:     # every live replica saturated: shed
                self.counters["rejected_429"] += 1
                retry = self.router.retry_after_s()
                if self.tracer.enabled:
                    self.tracer.instant("request_shed", cat="gateway",
                                        rid=rid0, retry_after_s=retry)
                self._log_access(rid=rid0, status=429,
                                 reason="fleet saturated",
                                 retry_after_s=retry)
                writer.write(error_response(
                    429, "Too Many Requests",
                    f"{self._inflight} samples in flight of "
                    f"{self.max_pending} allowed fleet-wide; retry "
                    f"shortly", {"Retry-After": str(retry)}))
                return
            self.counters["accepted_samples"] += creq.n
            fut = self.router.dispatch(rep, reqs, on_done)
            try:
                eids = await asyncio.wrap_future(fut)
                break
            except RuntimeError:    # replica died before the job ran:
                self.router.dispatch_failed(rep, reqs)      # roll back
                self.counters["accepted_samples"] -= creq.n
                if not self.router.alive:
                    self._log_access(rid=rid0, status=503,
                                     reason="engine driver not running")
                    writer.write(error_response(
                        503, "Service Unavailable",
                        "engine driver not running"))
                    return
                # survivors exist: re-route the same group
        del eids    # engine ids are replica-local; aborts go by request
        ctx = {"first": None, "tokens": 0}
        if creq.stream:
            status = await self._stream_sse(creq, q, reqs, reader,
                                            writer, ctx)
        else:
            status = await self._respond_json(creq, q, reqs, writer, ctx)
        t_done = time.monotonic()
        ttft = (ctx["first"] - t_arrive
                if ctx["first"] is not None else None)
        if self.tracer.enabled:
            self.tracer.complete("request", t_arrive, t_done - t_arrive,
                                 cat="gateway", rid=rid0,
                                 replica=rep.id, status=status,
                                 tokens=ctx["tokens"])
        self._log_access(rid=rid0, replica=rep.id,
                         policy=self.router.policy.name, status=status,
                         n=creq.n, prompt_len=len(creq.prompt),
                         ttft_s=ttft, tokens=ctx["tokens"],
                         dur_s=t_done - t_arrive)

    def _sample_done(self, q: asyncio.Queue, req) -> None:
        self.router.release(req)
        self.counters["completed_samples"] += 1
        q.put_nowait(("done", req.rid, req))

    async def _abort(self, reqs: List) -> None:
        self.counters["disconnects"] += 1
        await self.router.cancel(reqs)

    async def _next_event(self, q: asyncio.Queue,
                          reader: asyncio.StreamReader,
                          eof_box: List) -> Optional[Tuple]:
        """Next fan-out event, or None when the client went away.
        `eof_box[0]` is the pending 1-byte read watching the client
        socket: a read error or b'' (EOF — SSE clients hold their write
        side open for the connection's life, so EOF means gone) is a
        disconnect, while a stray trailing byte (e.g. a CRLF after the
        body) just re-arms the watch instead of killing the stream."""
        get = asyncio.ensure_future(q.get())
        while True:
            await asyncio.wait({get, eof_box[0]},
                               return_when=asyncio.FIRST_COMPLETED)
            if get.done():
                return get.result()
            try:
                data = eof_box[0].result()
            except (ConnectionError, OSError):
                data = b""
            if not data:
                get.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await get
                return None
            eof_box[0] = asyncio.ensure_future(reader.read(1))

    def _token_event(self, creq, rid: int, payload) -> Dict:
        if creq.logprobs:
            tok, lp, ent = payload
            return {"index": rid, "token": tok,
                    "logprob": lp, "entropy": ent}
        return {"index": rid, "token": payload}

    async def _stream_sse(self, creq, q, reqs, reader, writer,
                          ctx: Dict) -> str:
        writer.write(_SSE_HEADERS)
        eof_box = [asyncio.ensure_future(reader.read(1))]
        try:
            await writer.drain()
            remaining = creq.n
            while remaining:
                event = await self._next_event(q, reader, eof_box)
                if event is None:       # client went away mid-stream:
                    await self._abort(reqs)   # abort the whole group
                    return "disconnect"
                kind, rid, payload = event
                if kind == "token":
                    if ctx["first"] is None:
                        ctx["first"] = time.monotonic()
                    ctx["tokens"] += 1
                    writer.write(sse_event(
                        self._token_event(creq, rid, payload)))
                else:
                    remaining -= 1
                    writer.write(sse_event(
                        {"index": rid,
                         "finish_reason": _finish_reason(
                             payload, self.engine.eos_id),
                         "n_tokens": len(payload.out_tokens)}))
                await writer.drain()
            writer.write(sse_done())
            await writer.drain()
            return "ok"
        except (ConnectionResetError, BrokenPipeError):
            await self._abort(reqs)
            return "disconnect"
        finally:
            eof_box[0].cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await eof_box[0]

    async def _respond_json(self, creq, q, reqs, writer,
                            ctx: Dict) -> str:
        """Non-streaming mode: there is nothing incremental to deliver,
        so the client socket is NOT watched for EOF — a legal HTTP
        half-close (shutdown of the write side after the request) must
        not abort the work.  A truly-gone client surfaces as a failed
        response write instead."""
        try:
            remaining = creq.n
            while remaining:
                kind, _, payload = await q.get()
                if kind == "token":
                    if ctx["first"] is None:
                        ctx["first"] = time.monotonic()
                    ctx["tokens"] += 1
                if kind == "done":
                    remaining -= 1
            choices = []
            for r in reqs:
                choice = {"index": r.rid, "tokens": list(r.out_tokens),
                          "finish_reason": _finish_reason(
                              r, self.engine.eos_id)}
                if creq.logprobs:
                    choice["logprobs"] = [
                        {"logprob": lp, "entropy": ent}
                        for lp, ent in r.out_logprobs]
                choices.append(choice)
            writer.write(json_response(200, "OK", {
                "choices": choices,
                "usage": {"prompt_tokens": len(creq.prompt),
                          "completion_tokens": sum(
                              len(r.out_tokens) for r in reqs)}}))
            await writer.drain()
            return "ok"
        except (ConnectionResetError, BrokenPipeError):
            await self._abort(reqs)
            return "disconnect"

    # -- /metrics -------------------------------------------------------
    async def _metrics(self) -> Dict:
        """Fleet rollup + per-replica breakdown.  Top-level "engine" /
        "histograms" keep the classic single-engine schema (aggregated
        across live replicas); "fleet" carries the per-replica truth —
        including entries for drained and dead replicas, which aggregate
        as absent, never as a KeyError."""
        payload = await self.router.fleet_metrics()
        payload["schema_version"] = METRICS_SCHEMA_VERSION
        if payload["engine"] is None:
            payload.setdefault("error", "engine driver not running")
        payload["gateway"] = {**self.counters,
                              "inflight": self._inflight,
                              "max_pending": self.max_pending}
        return payload
