"""The port's streaming gateway (`repro_torch.api`) against the JAX
package's (`repro.api`), on the CPU, over real sockets.

Every behaviour of `tests/test_api_gateway.py` is one case run against
both packages (parametrised over `repro` and `repro_torch`), so the two
are held to the same outcome: SSE and JSON completions, greedy streams
equal to the package's own offline engine (and, across packages, to
each other), n > 1 through `PagedKVCache.fork`, cancellation on
disconnect freeing every page, a deterministic 429 with Retry-After,
503s from a dead driver, framing limits, logprobs, `/metrics`.  The
wire helpers (`parse_completion`, `sanitize`, `iter_sse`,
`read_http_request`) accept and refuse the same bodies with the same
messages.

Both packages serve the JAX package's tiny gateway model (2 layers, d
32, vocab 64), its weights carried across with
`repro_torch.convert.from_numpy_tree`.  Float weights with f32 KV pools
(and INT4 weights with INT8 pools for the cross-package streams): the
two packages' logits differ by f32 summation order only
(`tests/test_torch_model.py`), so their greedy streams are equal.

Waits are on events and futures (a wrapped `dispatch`, the access log,
the driver's job futures), never on fixed-deadline polls.
"""
import asyncio
import json
import threading
import types

import numpy as np
import pytest

import repro.api as jax_api
import repro.api.protocol as jax_protocol
import repro.fleet as jax_fleet
import repro.serve as jax_serve

import repro_torch.api as port_api
import repro_torch.api.protocol as port_protocol
import repro_torch.fleet as port_fleet
import repro_torch.serve as port_serve

from test_torch_model import _pair

PKGS = ["repro", "repro_torch"]
TINY = dict(name="s", family="dense", n_layers=2, d_model=32, n_heads=2,
            n_kv_heads=2, d_ff=64, vocab=64, head_dim=16)
KV = {"fp": "f32", "int4": "int8"}


def pkg(name, precision="fp"):
    """One package's gateway surface and the tiny model in it."""
    jm, jp, tm, tp = _pair(TINY, precision)
    if name == "repro":
        ns = dict(api=jax_api, protocol=jax_protocol, fleet=jax_fleet,
                  serve=jax_serve, model=jm, params=jp, kw={})
    else:
        ns = dict(api=port_api, protocol=port_protocol, fleet=port_fleet,
                  serve=port_serve, model=tm, params=tp,
                  kw={"device": "cpu"})
    p = types.SimpleNamespace(name=name, precision=precision, **ns)

    def engine(model=None, params=None, **geom):
        geom.setdefault("max_batch", 4)
        geom.setdefault("max_seq", 64)
        geom.setdefault("page_size", 8)
        cfg = p.serve.ServeConfig(precision=precision,
                                  kv_dtype=KV[precision], **geom)
        return p.serve.PagedServeEngine(
            p.model if model is None else model,
            p.params if params is None else params, cfg, **p.kw)
    p.engine = engine
    return p


def offline(p, prompts, max_new, **geom):
    eng = p.engine(**geom)
    reqs = [p.serve.ServeRequest(prompt=np.asarray(q, np.int32).copy(),
                                 max_new_tokens=max_new, rid=i)
            for i, q in enumerate(prompts)]
    eng.run(reqs)
    return [r.out_tokens for r in reqs]


# ----------------------------------------------------------------------------
# wire helpers (a client over real sockets)
# ----------------------------------------------------------------------------
async def raw_post(host, port, payload: bytes, path="/v1/completions"):
    reader, writer = await asyncio.open_connection(host, port)
    writer.write((f"POST {path} HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(payload)}\r\n\r\n"
                  ).encode() + payload)
    await writer.drain()
    data = await reader.read()
    writer.close()
    return data


async def post(host, port, body: dict):
    return await raw_post(host, port, json.dumps(body).encode())


async def get(host, port, path):
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    return data


def status(raw: bytes) -> int:
    return int(raw.split(b"\r\n", 1)[0].split()[1])


def body(raw: bytes) -> bytes:
    return raw.partition(b"\r\n\r\n")[2]


def stream_tokens(p, raw: bytes):
    """index -> [tokens], plus finish events, from an SSE response."""
    toks, fins = {}, {}
    for e in p.api.iter_sse(body(raw)):
        if "token" in e:
            toks.setdefault(e["index"], []).append(e["token"])
        elif "finish_reason" in e:
            fins[e["index"]] = e["finish_reason"]
    return toks, fins


def count_dispatches(router):
    """Wrap `router.dispatch` (the gateway's admission point): returns
    `wait(n)`, a coroutine that resolves once n groups were accepted."""
    orig, seen = router.dispatch, []
    cond = asyncio.Condition()

    def dispatch(rep, reqs, on_done):
        fut = orig(rep, reqs, on_done)
        seen.append(rep.id)

        async def note():
            async with cond:
                cond.notify_all()
        asyncio.ensure_future(note())
        return fut
    router.dispatch = dispatch

    async def wait(n, timeout=30):
        async with cond:
            await asyncio.wait_for(cond.wait_for(lambda: len(seen) >= n),
                                   timeout)
        return list(seen)
    return wait


class AccessSink:
    """A file-like access log: the gateway writes one JSON line at the
    end of each /v1/completions handler, after a disconnect's cancel ran
    on the driver."""

    def __init__(self):
        self.lines = []
        self.changed = asyncio.Event()

    def write(self, text):
        self.lines.append(json.loads(text))
        self.changed.set()

    def flush(self):
        pass

    async def wait_status(self, st, timeout=30):
        async def loop():
            while not any(ln["status"] == st for ln in self.lines):
                self.changed.clear()
                await self.changed.wait()
        await asyncio.wait_for(loop(), timeout)


async def on_driver(driver, fn):
    return await asyncio.wrap_future(driver.call(fn))


def page_audit(e):
    return (e.cache.n_free_or_cached(), e.cache.allocator.n_pages,
            e.n_running, e.scheduler.n_queued, e.telemetry.cancelled)


# ----------------------------------------------------------------------------
# streams: gateway == offline engine, in each package and across them
# ----------------------------------------------------------------------------
PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [40, 2, 9, 9]]


def _gateway_streams(p, prompts, max_new):
    async def run():
        gw = p.api.Gateway(p.engine(), max_pending=16)
        host, port = await gw.start()
        try:
            return await asyncio.gather(*[
                post(host, port, {"prompt": q, "max_tokens": max_new})
                for q in prompts])
        finally:
            await gw.stop()
    out = []
    for raw in asyncio.run(run()):
        assert status(raw) == 200
        toks, fins = stream_tokens(p, raw)
        assert fins[0] == "length"
        out.append(toks[0])
    return out


@pytest.mark.parametrize("precision", ["fp", "int4"])
def test_gateway_sse_greedy_streams_equal_offline_and_jax(precision):
    streams = {}
    for name in PKGS:
        p = pkg(name, precision)
        got = _gateway_streams(p, PROMPTS, 6)
        assert got == offline(p, PROMPTS, 6), name
        streams[name] = got
    assert streams["repro_torch"] == streams["repro"]


@pytest.mark.parametrize("name", PKGS)
def test_gateway_json_mode_and_usage(name):
    p = pkg(name)

    async def run():
        gw = p.api.Gateway(p.engine(), max_pending=16)
        host, port = await gw.start()
        try:
            return await post(host, port, {"prompt": [1, 2, 3],
                                           "max_tokens": 4,
                                           "stream": False})
        finally:
            await gw.stop()

    raw = asyncio.run(run())
    assert status(raw) == 200
    out = json.loads(body(raw))
    assert len(out["choices"]) == 1
    assert out["choices"][0]["tokens"] == offline(p, [[1, 2, 3]], 4)[0]
    assert out["usage"] == {"prompt_tokens": 3, "completion_tokens": 4}


# ----------------------------------------------------------------------------
# n > 1 parallel sampling via PagedKVCache.fork
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("name", PKGS)
def test_gateway_parallel_sampling_forks_share_prompt_pages(name):
    p = pkg(name)

    async def run():
        gw = p.api.Gateway(p.engine(), max_pending=16)
        host, port = await gw.start()
        try:
            raw = await post(host, port, {
                "prompt": list(range(1, 18)), "max_tokens": 8,
                "temperature": 1.5, "n": 4})
            metrics = json.loads(body(await get(host, port, "/metrics")))
        finally:
            await gw.stop()
        return raw, metrics

    raw, metrics = asyncio.run(run())
    assert status(raw) == 200
    toks, fins = stream_tokens(p, raw)
    assert sorted(toks) == [0, 1, 2, 3]
    assert all(len(v) == 8 for v in toks.values())
    assert set(fins.values()) == {"length"}
    eng = metrics["engine"]
    assert eng["kv_pages_shared"] > 0
    assert eng["fork_admissions"] == 3
    assert eng["prefill_tokens_skipped"] >= 3 * 16
    assert len({tuple(v) for v in toks.values()}) > 1


@pytest.mark.parametrize("precision", ["fp", "int4"])
@pytest.mark.parametrize("name", PKGS)
def test_gateway_greedy_forks_match_primary(name, precision):
    p = pkg(name, precision)

    async def run():
        gw = p.api.Gateway(p.engine(), max_pending=16)
        host, port = await gw.start()
        try:
            return await post(host, port, {"prompt": list(range(1, 14)),
                                           "max_tokens": 6, "n": 3})
        finally:
            await gw.stop()

    toks, _ = stream_tokens(p, asyncio.run(run()))
    assert toks[1] == toks[0] and toks[2] == toks[0]
    assert toks[0] == offline(p, [list(range(1, 14))], 6)[0]


# ----------------------------------------------------------------------------
# cancellation on client disconnect
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("name", PKGS)
def test_gateway_disconnect_mid_stream_frees_all_pages(name):
    p = pkg(name)

    async def run():
        sink = AccessSink()
        gw = p.api.Gateway(p.engine(n_pages=32), max_pending=16,
                           access_log=sink)
        host, port = await gw.start()
        try:
            payload = json.dumps({"prompt": [3, 4, 5, 6, 7, 8, 9, 10, 11],
                                  "max_tokens": 50, "n": 2,
                                  "temperature": 1.0}).encode()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                          f"Content-Length: {len(payload)}\r\n\r\n"
                          ).encode() + payload)
            await writer.drain()
            first = await reader.readuntil(b'"token"')   # streaming
            writer.close()                  # hang up mid-generation
            await writer.wait_closed()
            # the handler logs only after the driver ran the cancel
            await sink.wait_status("disconnect")
            state = await on_driver(gw.driver, page_audit)
        finally:
            await gw.stop()
        return first, state, gw.counters

    first, state, counters = asyncio.run(run())
    free_or_cached, n_pages, running, queued, cancelled = state
    assert first.startswith(b"HTTP/1.1 200")
    assert counters["disconnects"] >= 1
    assert cancelled >= 1
    assert running == 0 and queued == 0
    assert free_or_cached == n_pages


# ----------------------------------------------------------------------------
# backpressure and dead drivers
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("name", PKGS)
def test_gateway_429_with_retry_after_when_saturated(name):
    """The driver is parked on an event, so the first request pins the
    admission budget; the second sheds with Retry-After."""
    p = pkg(name)

    async def run():
        gw = p.api.Gateway(p.engine(), max_pending=1)
        host, port = await gw.start()
        accepted = count_dispatches(gw.router)
        gate = threading.Event()
        try:
            gw.driver.call(lambda e: gate.wait(30))     # park the driver
            first = asyncio.ensure_future(
                post(host, port, {"prompt": [1, 2], "max_tokens": 2}))
            await accepted(1)
            second = await post(host, port,
                                {"prompt": [3, 4], "max_tokens": 2})
            gate.set()
            first_raw = await first
        finally:
            gate.set()
            await gw.stop()
        return first_raw, second, dict(gw.counters)

    first_raw, second, counters = asyncio.run(run())
    assert status(first_raw) == 200
    assert status(second) == 429
    assert b"retry-after: 1\r\n" in second.lower()
    assert "error" in json.loads(body(second))
    assert counters["rejected_429"] == 1 and counters["accepted_samples"] == 1


@pytest.mark.parametrize("name", PKGS)
def test_gateway_healthz_503_when_driver_dead(name):
    p = pkg(name)

    async def run():
        gw = p.api.Gateway(p.engine(), max_pending=8)
        host, port = await gw.start()
        try:
            ok = await get(host, port, "/healthz")
            gw.driver.stop()
            dead = await get(host, port, "/healthz")
        finally:
            await gw.stop()
        return ok, dead

    ok, dead = asyncio.run(run())
    assert status(ok) == 200 and json.loads(body(ok))["ok"] is True
    assert status(dead) == 503 and json.loads(body(dead))["ok"] is False


@pytest.mark.parametrize("name", PKGS)
def test_gateway_completions_503_when_driver_dead(name):
    p = pkg(name)

    async def run():
        gw = p.api.Gateway(p.engine(), max_pending=8)
        host, port = await gw.start()
        try:
            gw.driver.stop()
            raw = await post(host, port, {"prompt": [1, 2],
                                          "max_tokens": 2})
            inflight = gw._inflight
        finally:
            await gw.stop()
        return raw, inflight

    raw, inflight = asyncio.run(run())
    assert status(raw) == 503
    assert inflight == 0


@pytest.mark.parametrize("name", PKGS)
def test_driver_fatal_step_error_fails_watchers_and_later_calls(name):
    """A fatal step fails every watched request once and every later
    job; the engine's flight recorder is dumped (port: its driver thread
    also runs a CUDA-less engine without a stream)."""
    p = pkg(name)
    dumped = []

    class ExplodingEngine:
        busy = True

        def __init__(self):
            self._eid = 0
            self.recorder = types.SimpleNamespace(
                record=lambda kind, **kw: dumped.append(kind),
                dump=lambda reason: dumped.append(reason) or "/dev/null")

        def submit(self, r):
            r.eid = self._eid
            self._eid += 1

        def step(self):
            raise RuntimeError("device on fire")

    drv = p.api.EngineDriver(ExplodingEngine())
    req = types.SimpleNamespace(done=False, cancelled=False, rid=0, eid=-1)
    fired = []
    drv.submit([req], fired.append)
    drv.start()
    drv._thread.join(30)
    assert not drv.alive and isinstance(drv.error, RuntimeError)
    assert req.done and req.cancelled
    assert fired == [req]
    assert dumped == ["fatal", "RuntimeError('device on fire')"]
    assert drv.flight_path == "/dev/null"
    with pytest.raises(RuntimeError, match="engine driver not running"):
        drv.call(lambda e: None).result(timeout=5)


# ----------------------------------------------------------------------------
# HTTP surface
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("name", PKGS)
def test_gateway_http_errors_and_framing_limits(name):
    p = pkg(name)

    async def run():
        gw = p.api.Gateway(p.engine(), max_pending=4)
        host, port = await gw.start()
        out = []
        try:
            out.append(await raw_post(host, port, b"not json"))
            out.append(await get(host, port, "/nope"))
            for raw_req in [
                    b"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                    b"Content-Length: -1\r\n\r\n",
                    b"GARBAGE\r\n\r\n",
                    b"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                    b"Content-Length: 99999999999\r\n\r\n"]:
                reader, writer = await asyncio.open_connection(host, port)
                writer.write(raw_req)
                await writer.drain()
                out.append(await reader.read())
                writer.close()
            out.append(await get(host, port, "/healthz"))
            out.append(await get(host, port, "/debug/trace"))
            out.append(await get(host, port, "/debug/slo"))
        finally:
            await gw.stop()
        return out, dict(gw.counters)

    out, counters = asyncio.run(run())
    assert [status(r) for r in out] == [400, 404, 400, 400, 400, 200, 404,
                                        200]
    assert json.loads(body(out[0]))["error"]["message"] == \
        "body is not valid JSON"
    assert json.loads(body(out[5]))["n_live"] == 1
    slo = json.loads(body(out[7]))
    assert slo["worst"] == "ok" and set(slo["drift"]) == {"0"}
    assert counters["bad_requests"] == 4


@pytest.mark.parametrize("name", PKGS)
def test_gateway_metrics_percentiles_histograms_and_config(name):
    p = pkg(name)

    async def run():
        gw = p.api.Gateway(p.engine(), max_pending=16)
        host, port = await gw.start()
        try:
            for _ in range(2):
                await post(host, port, {"prompt": [1, 2, 3],
                                        "max_tokens": 4})
            raw = await get(host, port, "/metrics")
            prom = await get(host, port, "/metrics?format=prometheus")
        finally:
            await gw.stop()
        return raw, prom

    raw, prom = asyncio.run(run())
    m = json.loads(body(raw))
    eng = m["engine"]
    for key in ("ttft_p50_s", "ttft_p95_s", "ttft_p99_s", "itl_p50_s",
                "itl_p95_s", "itl_p99_s", "queue_p95_s", "cancelled",
                "fork_admissions", "sim_energy_j"):
        assert key in eng, key
    hist = m["histograms"]
    for h in hist.values():
        assert len(h["counts"]) == len(h["edges_s"]) - 1
    assert sum(hist["ttft_s"]["counts"]) == 2
    assert m["gateway"]["accepted_samples"] == 2
    assert m["gateway"]["inflight"] == 0
    assert m["schema_version"] == 3
    assert m["config"]["policy"] == "least-loaded"
    assert m["config"]["max_pending"] == 32
    assert m["fleet"]["n_replicas"] == 1
    text = body(prom).decode()
    assert "repro_engine_requests_total 2" in text
    assert "NaN" not in text


@pytest.mark.parametrize("name", PKGS)
def test_gateway_stray_trailing_byte_does_not_abort_stream(name):
    p = pkg(name)

    async def run():
        gw = p.api.Gateway(p.engine(), max_pending=8)
        host, port = await gw.start()
        try:
            payload = json.dumps({"prompt": [1, 2, 3],
                                  "max_tokens": 5}).encode()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                          f"Content-Length: {len(payload)}\r\n\r\n"
                          ).encode() + payload + b"\r\n")
            await writer.drain()
            raw = await reader.read()
            writer.close()
        finally:
            await gw.stop()
        return raw

    raw = asyncio.run(run())
    assert status(raw) == 200
    toks, fins = stream_tokens(p, raw)
    assert len(toks[0]) == 5 and fins[0] == "length"
    assert b"[DONE]" in raw


@pytest.mark.parametrize("name", PKGS)
def test_gateway_json_mode_survives_client_half_close(name):
    p = pkg(name)

    async def run():
        gw = p.api.Gateway(p.engine(), max_pending=8)
        host, port = await gw.start()
        try:
            payload = json.dumps({"prompt": [2, 3, 4], "max_tokens": 3,
                                  "stream": False}).encode()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                          f"Content-Length: {len(payload)}\r\n\r\n"
                          ).encode() + payload)
            await writer.drain()
            writer.write_eof()
            raw = await reader.read()
            writer.close()
        finally:
            await gw.stop()
        return raw

    raw = asyncio.run(run())
    assert status(raw) == 200
    out = json.loads(body(raw))
    assert len(out["choices"][0]["tokens"]) == 3
    assert out["choices"][0]["finish_reason"] == "length"


@pytest.mark.parametrize("name", PKGS)
def test_gateway_logprobs_round_trip(name):
    p = pkg(name)

    async def run():
        gw = p.api.Gateway(p.engine(), max_pending=8)
        host, port = await gw.start()
        try:
            on = await post(host, port, {"prompt": [1, 2, 3],
                                         "max_tokens": 4,
                                         "logprobs": True})
            off = await post(host, port, {"prompt": [1, 2, 3],
                                          "max_tokens": 4})
            both = await post(host, port, {"prompt": [1, 2, 3],
                                           "max_tokens": 4, "n": 2,
                                           "stream": False,
                                           "logprobs": True})
        finally:
            await gw.stop()
        return on, off, both

    on, off, both = asyncio.run(run())
    on_events = [e for e in p.api.iter_sse(body(on)) if "token" in e]
    assert len(on_events) == 4
    assert all(e["logprob"] == 0.0 and e["entropy"] == 0.0
               for e in on_events)
    assert all("logprob" not in e for e in p.api.iter_sse(body(off)))
    choices = json.loads(body(both))["choices"]
    for c in choices:
        assert len(c["logprobs"]) == len(c["tokens"])
    assert choices[0]["tokens"] == choices[1]["tokens"] \
        == [e["token"] for e in on_events]


# ----------------------------------------------------------------------------
# the wire helpers: the same bodies accepted and refused with the same
# messages in both packages
# ----------------------------------------------------------------------------
BAD_BODIES = [
    b"", b"[1,2]", b'{"prompt": "hi"}', b'{"prompt": []}',
    b'{"prompt": [1, -2]}', b'{"prompt": [1, 99]}', b'{"prompt": [true]}',
    b'{"prompt": [1], "max_tokens": 0}', b'{"prompt": [1], "n": 99}',
    b'{"prompt": [1], "temperature": -1}', b'{"prompt": [1], "top_p": 2.0}',
    b'{"prompt": [1], "top_k": 1.5e400}',
    b'{"prompt": [1], "deadline_s": 0}', b'{"prompt": [1], "stream": "no"}',
    b'{"prompt": [1], "spec": "false"}', b'{"prompt": [1], "logprobs": 1}',
    b'{"prompt": [1, 2, 3, 4, 5, 6, 7, 8]}', b"\xff\xfe",
]
GOOD_BODIES = [
    b'{"prompt": [1, 2], "n": 2, "stream": false}',
    b'{"prompt": [1], "spec": false, "temperature": 0.7, "top_k": 5}',
    b'{"prompt": [3], "deadline_s": 2.5, "priority": -3, "logprobs": true}',
]


def _parse(protocol, raw):
    try:
        return "ok", vars(protocol.parse_completion(
            raw, vocab=64, max_n=8, max_prompt_len=8))
    except protocol.ProtocolError as e:
        return "error", e.message


@pytest.mark.parametrize("raw", BAD_BODIES + GOOD_BODIES)
@pytest.mark.parametrize("name", PKGS)
def test_parse_completion_same_verdict_and_message(name, raw):
    want = _parse(jax_protocol, raw)
    assert want[0] == ("ok" if raw in GOOD_BODIES else "error")
    assert _parse(pkg(name).protocol, raw) == want


@pytest.mark.parametrize("name", PKGS)
def test_sanitize_sse_framing_and_iter_sse_agree(name):
    proto = pkg(name).protocol
    obj = {"a": float("nan"), "b": [1.0, float("inf")], "c": {"d": 2}}
    assert proto.sanitize(obj) == {"a": None, "b": [1.0, None],
                                   "c": {"d": 2}}
    events = [{"index": 0, "token": 5}, {"index": 1, "logprob": -0.5},
              {"index": 0, "finish_reason": "length", "n_tokens": 1}]
    wire = b"".join(proto.sse_event(e) for e in events) + proto.sse_done()
    assert wire == b"".join(jax_protocol.sse_event(e) for e in events) \
        + jax_protocol.sse_done()
    assert list(proto.iter_sse(wire + b"data: {}\n\n")) == events
    assert proto.error_response(429, "Too Many Requests", "m",
                                {"Retry-After": "3"}) == \
        jax_protocol.error_response(429, "Too Many Requests", "m",
                                    {"Retry-After": "3"})


def _read_request(protocol, raw):
    async def parse():
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        return await protocol.read_http_request(reader)
    try:
        return "ok", asyncio.run(parse())
    except protocol.ProtocolError as e:
        return "error", e.message


REQUESTS = [
    b"GET / HTTP/1.1\r\n" + b"".join(b"x%d: y\r\n" % i for i in range(1000))
    + b"\r\n",
    b"POST /p HTTP/1.1\r\nA: 1\r\nContent-Length: 2\r\n\r\nhi",
    b"POST /p HTTP/1.1\r\nContent-Length: x\r\n\r\n",
    b"POST /p HTTP/1.1\r\nContent-Length: 4194305\r\n\r\n",
    b"ONLY TWO\r\n\r\n",
]


@pytest.mark.parametrize("raw", REQUESTS)
@pytest.mark.parametrize("name", PKGS)
def test_read_http_request_same_verdicts(name, raw):
    assert _read_request(pkg(name).protocol, raw) == \
        _read_request(jax_protocol, raw)
