"""The port's fleet-facing configuration, launcher and legacy shims
against the JAX package's, on the CPU.

  * `ServeConfig`: the same defaults and `as_dict()` (what `/metrics`
    reports), `replicas > 1` accepted, `tp > 1` still refused by the
    port (tensor parallelism is not in it yet).
  * The launcher: `--gateway` over `--replicas` engines that share one
    copy of the weights, its refusals with the JAX launcher's exact
    texts, the deprecated `--quant` alias; and a real `--gateway
    --replicas 2` process answering over HTTP.
  * The seed-API shim `ServeEngine` / `Request` and the deprecated
    `PagedServeEngine(max_batch=...)` keyword arguments: the JAX
    package's warning, and its token streams on the same weights.
"""
import asyncio
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jax_launch
import repro.serve as jax_serve
import repro.serve.engine as jax_engine

import repro_torch.launch.serve as port_launch
import repro_torch.serve as port_serve
import repro_torch.serve.engine as port_engine
from repro_torch.api import Gateway

from test_torch_gateway import body, get, pkg, post, status

CONFIGS = [dict(), dict(precision="int4"),
           dict(precision="int8", kv_dtype="f32", replicas=2,
                policy="prefix", max_pending=5, max_batch=3),
           dict(precision="fp", kv_dtype="int8", seed=7, n_pages=40)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_serve_config_defaults_and_as_dict_equal_jax(kw):
    port, ref = port_serve.ServeConfig(**kw), jax_serve.ServeConfig(**kw)
    assert port.as_dict() == ref.as_dict()
    assert list(port.as_dict()) == list(ref.as_dict())
    assert (port.quantized(), port.weight_bits()) == \
        (ref.quantized(), ref.weight_bits())


def test_serve_config_accepts_replicas_and_refuses_tp():
    assert port_serve.ServeConfig(replicas=2).replicas == 2
    with pytest.raises(NotImplementedError, match="tp=2"):
        port_serve.ServeConfig(tp=2)
    with pytest.raises(ValueError):
        port_serve.ServeConfig(replicas=0)


# ----------------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------------
SMALL = ["--smoke", "--requests", "2", "--tokens", "3", "--max-seq", "32",
         "--page-size", "8"]


def _jax_exit(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(SystemExit) as e:
        jax_launch.main()
    return str(e.value)


@pytest.mark.parametrize("argv", [
    ["--replicas", "2"], ["--slo"], ["--slo", "error_rate < 0.1"],
    ["--precision", "int8", "--quant", "int4"], ["--replicas", "0"]],
    ids=["replicas-without-gateway", "slo-without-gateway", "slo-spec",
         "precision-and-quant", "no-replica"])
def test_launcher_refusals_use_jax_texts(monkeypatch, argv):
    want = _jax_exit(monkeypatch, SMALL + argv)
    with pytest.raises(SystemExit) as e:
        port_launch.main(SMALL + argv + ["--device", "cpu"])
    assert str(e.value) == want
    assert want.startswith(("--", "pass --precision"))


def test_launcher_quant_alias_warns_and_serves_that_precision(monkeypatch):
    with pytest.warns(DeprecationWarning, match="--quant is deprecated"):
        with contextlib.redirect_stdout(io.StringIO()):
            eng, reqs = port_launch.main(SMALL + ["--quant", "int8",
                                                  "--device", "cpu"])
    assert eng.config.precision == "int8"
    assert eng.summary()["sim_w_bits"] == 8
    assert all(len(r.out_tokens) == 3 for r in reqs)
    monkeypatch.setattr(sys, "argv", ["serve"] + SMALL + ["--quant", "bf16"])
    with pytest.warns(DeprecationWarning, match="--quant is deprecated"):
        with contextlib.redirect_stdout(io.StringIO()):
            jax_launch.main()


def test_launcher_gateway_replicas_share_weights(monkeypatch):
    """`--gateway --replicas 2`: one FleetRouter over two engines that
    share every packed tensor, each with its own pools and runner; the
    SLO flags reach the router."""
    seen = {}

    async def fake_serve_forever(self, host, port):
        seen.update(gw=self, host=host, port=port)
    monkeypatch.setattr(Gateway, "serve_forever", fake_serve_forever)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        port_launch.main(SMALL + [
            "--gateway", "--replicas", "2", "--policy", "prefix",
            "--max-pending", "5", "--slo", "ttft_p95_s < 1.5",
            "--slo-timescale", "0.01", "--port", "0", "--device", "cpu"])
    router = seen["gw"].router
    a, b = (rep.engine for rep in router.replicas)
    assert seen["port"] == 0 and router.policy.name == "prefix"
    assert router.max_pending == 5 and seen["gw"].max_pending == 10
    assert a.config.replicas == 2 and b.config is a.config
    leaves = (lambda p: [p["embed"].data, p["blocks"]["attn"]["wq"].data,
                         p["blocks"]["ffn"]["w_down"].scales])
    assert [t.data_ptr() for t in leaves(a.params)] == \
        [t.data_ptr() for t in leaves(b.params)]
    assert a.cache.pools is not b.cache.pools and a.runner is not b.runner
    assert [s.spec for s in router.slo.slos] == ["ttft_p95_s < 1.5"]
    assert router.slo.policy.timescale == 0.01
    assert "SLOs: ttft_p95_s < 1.5" in out.getvalue()


def test_launcher_gateway_process_serves_two_replicas_over_http():
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--gateway",
         "--replicas", "2", "--policy", "rr", "--port", "0", "--device",
         "cpu"] + SMALL, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    try:
        for line in proc.stdout:
            if line.startswith("[api] gateway listening on http://"):
                break
        else:
            pytest.fail(f"no gateway line: {proc.stderr.read()}")
        host, port = line.split("http://")[1].split()[0].rsplit(":", 1)
        port = int(port)

        async def run():
            raws = await asyncio.gather(*[
                post(host, port, {"prompt": [1, 2, 3 + i], "max_tokens": 3})
                for i in range(2)])
            return raws, json.loads(body(await get(host, port, "/metrics")))
        raws, m = asyncio.run(run())
    finally:
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    assert [status(r) for r in raws] == [200, 200]
    assert m["fleet"]["n_replicas"] == 2 and m["fleet"]["policy"] == "rr"
    assert [r["dispatches"] for r in m["fleet"]["replicas"].values()] == \
        [1, 1]
    assert m["config"]["replicas"] == 2
    assert m["engine"]["requests"] == 2.0
    assert "[api] gateway stopped" in out, err


# ----------------------------------------------------------------------------
# legacy shims
# ----------------------------------------------------------------------------
LEGACY_PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [40, 2, 9, 9],
                  [17, 3]]


def test_serve_engine_shim_streams_equal_jax():
    streams = {}
    for name, serve, kw in (("repro", jax_serve, {}),
                            ("repro_torch", port_serve,
                             {"device": "cpu"})):
        p = pkg(name)
        eng = serve.ServeEngine(p.model, p.params, n_slots=2, max_seq=24,
                                **kw)
        reqs = [serve.Request(prompt=np.asarray(q, np.int32),
                              max_new_tokens=5)
                for q in LEGACY_PROMPTS]
        eng.run(reqs)
        assert all(r.done and len(r.out_tokens) == 5 for r in reqs)
        assert eng.stats["tokens"] == 20 and eng.throughput() > 0
        assert eng.engine.config.page_size == 8
        assert eng.engine.config.kv_dtype == "bf16"
        streams[name] = [r.out_tokens for r in reqs]
        paged = serve.PagedServeEngine(p.model, p.params,
                                       eng.engine.config, **kw)
        sreqs = [serve.ServeRequest(prompt=np.asarray(q, np.int32),
                                    max_new_tokens=5, rid=i)
                 for i, q in enumerate(LEGACY_PROMPTS)]
        paged.run(sreqs)
        assert [r.out_tokens for r in sreqs] == streams[name]
    assert streams["repro_torch"] == streams["repro"]


def _legacy_run(monkeypatch, name, serve, engine_mod, kv, kw):
    p = pkg(name)
    monkeypatch.setattr(engine_mod, "_legacy_warned", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = serve.PagedServeEngine(p.model, p.params, max_batch=2,
                                     max_seq=32, page_size=8, kv_dtype=kv,
                                     prefill_chunk=4, seed=3, **kw)
        serve.PagedServeEngine(p.model, p.params, max_batch=2,
                               max_seq=32, page_size=8, **kw)
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, DeprecationWarning)]
    reqs = [serve.ServeRequest(prompt=np.asarray(q, np.int32),
                               max_new_tokens=6, rid=i)
            for i, q in enumerate(LEGACY_PROMPTS)]
    eng.run(reqs)
    with pytest.raises(ValueError) as both:
        serve.PagedServeEngine(p.model, p.params, serve.ServeConfig(),
                               max_batch=2, **kw)
    return (msgs, eng.config.as_dict(), [r.out_tokens for r in reqs],
            str(both.value))


@pytest.mark.parametrize("kv", ["f32", "bf16"])
def test_deprecated_engine_kwargs_warn_once_and_give_jax_streams(
        monkeypatch, kv):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[kv]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[kv]
    got = _legacy_run(monkeypatch, "repro_torch", port_serve, port_engine,
                      tdt, {"device": "cpu"})
    want = _legacy_run(monkeypatch, "repro", jax_serve, jax_engine, jdt, {})
    assert got == want
    assert len(got[0]) == 1 and "deprecated" in got[0][0]
    assert got[1]["precision"] == "fp" and got[1]["kv_dtype"] == kv
