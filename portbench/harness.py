"""The port's benchmark harness: one run of one cell.

A cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`configs/<config>.json`: the model's published sizes, the serving
settings, the weights' scales, the limit of the output check) and a
traffic mix (`traffic/<mix>.json`, read by `workload.py`, driven by
`loops/<kind>.py`).  A run, in order:

  1. builds the port's kernels, or finds them built in the checkout;
  2. draws the weights on the card from the seed (`weights.py`) in the
     form they are served in and hands them to `PagedServeEngine`;
  3. warms up: one request through the cell's two step shapes, a
     prefill chunk and a decode step, each captured as a CUDA graph;
  4. measures for `--seconds`: every client has a request in flight
     from the window's opening on (`--trace 1` also records the
     tracer's spans, each step's work, and a device trace of a
     sub-window);
  5. frees the engine and checks what the window served against the
     plain reference (`reference/`, `correct.py`);
  6. prints the result line.

End-to-end metrics come from the client's side of the loop, per-layer
metrics from the readers in `metrics/<name>.py`, each given the run's
records (`Run`).
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

import correct as correct_mod
import weights
import workload

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PROFILE_S = 1.0             # device-traced sub-window of a traced run


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(man: dict, name: str) -> dict:
    for cell in man["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str, smoke: bool = False) -> dict:
    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    if smoke:
        sm = conf["smoke"]
        conf = {**conf, "model": {**conf["model"], **sm["model"]},
                "serve": {**conf["serve"], **sm["serve"]}}
    return conf


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` under the benchmark, by path (names may hold
    dots)."""
    key = f"portbench_{kind}_{name}"
    if key not in sys.modules:
        path = HERE / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def counts_for(family: str):
    return load_module("counts", family)


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


# ----------------------------------------------------------------------
# the port
def program_config(conf: dict, z: dict, smoke: bool):
    """The port's ModelConfig for this file's sizes, at the serving
    dtype; at full size the sizes must be the port's registered ones."""
    import dataclasses

    from repro_torch.configs import get_config
    base = get_config(conf["arch"])
    if z["family"] == "dense":
        kw = dict(n_layers=z["layers"], d_model=z["d"], n_heads=z["heads"],
                  n_kv_heads=z["kv_heads"], d_ff=z["ff"], vocab=z["vocab"],
                  head_dim=z["hd"], rope_theta=z["theta"],
                  norm_eps=z["eps"], tie_embeddings=z["tied"],
                  qkv_bias=True)
    else:
        m = conf["model"]
        ssm = dataclasses.replace(
            base.ssm, mlstm_heads=z["heads"], slstm_every=z["per"],
            proj_factor_mlstm=m["mlstm_proj_factor"],
            proj_factor_slstm=m["slstm_ffn_proj_factor"],
            conv_width=z["conv"])
        kw = dict(n_layers=z["layers"], d_model=z["d"], n_heads=z["heads"],
                  n_kv_heads=z["heads"], vocab=z["vocab"],
                  norm_eps=z["eps"], tie_embeddings=z["tied"], ssm=ssm)
    cfg = base.replace(**kw)
    if not smoke and cfg != base:
        raise SystemExit(f"{conf['arch']}: the configuration file's sizes "
                         "are not the port's registered ones")
    return cfg.replace(dtype="float32", remat=False)


def check_layout(model, conf: dict) -> None:
    """The port's parameter tree and packing against `leaf_table`."""
    from repro_torch.quant.ptq import quantize_structs
    from repro_torch.quant.qarray import QTensor
    packed = quantize_structs(model.param_specs(), bits=4,
                              group=conf["serve"]["quant_group"])

    def flat(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, path + (k,))
        else:
            yield path, tree
    theirs = dict(flat(packed))
    ours = {lf.path: lf for lf in weights.leaf_table(conf)}
    if set(theirs) != set(ours):
        raise SystemExit(f"leaf tree differs from the port's: "
                         f"{sorted(set(theirs) ^ set(ours))}")
    for path, lf in ours.items():
        t = theirs[path]
        ok = tuple(t.shape) == lf.shape and isinstance(t, QTensor) == \
            lf.packed
        if ok and lf.packed:
            ok = t.group == lf.group and t.axis == (-1 if lf.table else -2)
        if not ok:
            raise SystemExit(f"leaf {'/'.join(path)}: the port packs "
                             f"{t} where the benchmark draws {lf}")


def program_params(drawn: Dict[tuple, weights.Drawn]) -> dict:
    """The drawn leaves as the port's parameter tree (QTensor for a
    packed leaf)."""
    from repro_torch.quant.qarray import QTensor
    tree: dict = {}
    for path, dr in drawn.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        lf = dr.leaf
        node[path[-1]] = (QTensor(dr.data, dr.scales, 4, lf.group,
                                  -1 if lf.table else -2, lf.shape)
                          if lf.packed else dr.value)
    return tree


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


# ----------------------------------------------------------------------
@dataclass
class Run:
    """What a traced run recorded, for the per-layer readers."""
    device: str
    window_s: float = 0.0           # the window, to its last step's end
    spans: List[dict] = field(default_factory=list)
    calls: List[dict] = field(default_factory=list)
    timeline: Any = None            # devtrace.Timeline
    prof_calls: List[dict] = field(default_factory=list)
    timeline_ok: bool = False


class StepLog:
    """Each step's model calls, read from the requests' progress around
    it (the traced run only)."""

    def __init__(self, engine, sent, z, serve, counts):
        self.engine, self.sent, self.z, self.serve = engine, sent, z, serve
        self.counts = counts
        self.calls: List[dict] = []
        self.step_t0: List[float] = []
        self.n_steps = 0
        self._before = None

    def before(self) -> None:
        eng = self.engine
        self._before = (eng.prefill_calls, eng.decode_calls,
                        {id(r): (r.req.prefill_done, len(r.req.out_tokens))
                         for r in self.sent if not r.req.done})
        self.step_t0.append(time.perf_counter())

    def after(self, now: float) -> None:
        p0, d0, prog = self._before
        eng, z, sv, C = self.engine, self.z, self.serve, self.counts
        group, b = sv["quant_group"], sv["max_batch"]
        prefill, decode, held = [], [], []
        for r in self.sent:
            if id(r) not in prog:
                continue
            req = r.req
            pd0, n0 = prog[id(r)]
            p = max(pd0, req.prefix_cached)
            q = req.prefill_done - p if req.prefill_done > pd0 else 0
            if q > 0:
                prefill.append((p, q))
            dn = len(req.out_tokens) - n0 - (
                1 if q > 0 and req.prefill_remaining == 0 else 0)
            if dn > 0:
                decode.append(r.prompt_len + len(req.out_tokens) - 1)
            elif req.prefill_done > 0 and not req.done and \
                    req.prefill_remaining > 0:
                held.append(req.prefill_done)
        idx = self.n_steps
        self.n_steps += 1
        if eng.prefill_calls > p0:
            m = b * sv["prefill_chunk"]
            self.calls.append(dict(
                kind="prefill", step=idx, m=m,
                least=C.least_prefill(z, group, prefill),
                kernels=C.kernel_calls(z, group, m)))
        if eng.decode_calls > d0:
            totals = decode + held
            totals += [0] * (b - len(totals))
            kern = C.kernel_calls(z, group, b)
            kern.update(C.attention_calls(
                z, sv["page_size"], sv["max_seq"] // sv["page_size"],
                totals))
            self.calls.append(dict(kind="decode", step=idx, m=b,
                                   least=C.least_decode(z, group, decode),
                                   kernels=kern))


# ----------------------------------------------------------------------
def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", smoke: bool = False,
             fault=None, keep: dict = None) -> dict:
    """One run; returns the result object (see `main`).  `device="cpu"`
    with `smoke=True` is the CPU rehearsal at the configuration's smoke
    sizes; `fault(engine)` breaks the engine under the window (the
    checks' faults); `keep["served"]` receives the compared sample."""
    import torch
    man = manifest()
    cell = cell_of(man, name)
    conf = load_config(cell["config"], smoke)
    mix = workload.load(cell["traffic"],
                        conf["smoke"]["traffic"] if smoke else None)
    z = weights.dims(conf)
    sv = conf["serve"]
    counts = counts_for(z["family"])
    loop = load_module("loops", mix["loop"])

    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import DecoderLM
    from repro_torch.obs import get_tracer
    from repro_torch.serve import (PagedServeEngine, SamplingParams,
                                   ServeConfig, ServeRequest)
    on_card = device == "cuda"
    if on_card:
        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = program_config(conf, z, smoke)
    model = DecoderLM(cfg)
    check_layout(model, conf)
    limit_w = power_limit() if on_card else None
    engine = PagedServeEngine(
        model, program_params(weights.draw(conf, seed, device)),
        ServeConfig(precision=sv["precision"], kv_dtype=sv["kv_dtype"],
                    quant_group=sv["quant_group"],
                    max_batch=sv["max_batch"], max_seq=sv["max_seq"],
                    page_size=sv["page_size"],
                    prefill_chunk=sv["prefill_chunk"],
                    prefix_cache=sv["prefix_cache"], seed=seed),
        device=device)
    greedy = SamplingParams()

    # warm-up: a prompt of two chunks, then decode steps
    chunk, b = sv["prefill_chunk"], sv["max_batch"]
    warm = ServeRequest(prompt=(np.arange(chunk + 1) * 7 % z["vocab"]
                                ).astype(np.int32),
                        max_new_tokens=3, sampling=greedy)
    engine.run([warm])
    shapes = sorted(tuple(s["shape"]) for s in engine.runner.steps())
    if shapes != sorted([(b, chunk), (b, 1)]) or (on_card and not all(
            s["captured"] for s in engine.runner.steps())):
        raise SystemExit(f"warm-up left step shapes {shapes}")
    if fault is not None:
        fault(engine)
    tracer = get_tracer()
    tracer.disable()
    tracer.clear()
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    p0, d0 = engine.prefill_calls, engine.decode_calls
    plans = workload.client_plans(mix, seed, z["vocab"])

    def make_request(plan, rid, stamp):
        return ServeRequest(
            prompt=plan.prompt, max_new_tokens=plan.max_new_tokens,
            rid=rid, sampling=greedy,
            on_token=lambda _rid, _tok: stamp(time.perf_counter()))

    sent: list = []
    hooks = loop.Hooks()
    log = prof = timeline = None
    state = {"on": False, "mark": None, "first": 0}
    if trace:
        from devtrace import Profiler
        log = StepLog(engine, sent, z, sv, counts)
        tracer.enable()
        prof = Profiler() if on_card else None
        # the device trace covers the window's last PROFILE_S seconds and
        # is read after it closes
        t_prof = time.perf_counter() + max(0.0, seconds - PROFILE_S)

        def before():
            log.before()
            if state["on"]:
                state["mark"] = prof.mark()
                state["mark"].__enter__()

        def after(now):
            if state["mark"] is not None:
                state["mark"].__exit__(None, None, None)
                state["mark"] = None
            log.after(now)
            if prof is not None and not state["on"] and now >= t_prof:
                prof.start()
                state.update(on=True, first=log.n_steps)
        hooks = loop.Hooks(before, after)

    setup_s = time.perf_counter() - t_start
    gc.collect()
    gc.disable()
    try:
        t_open, t_close = loop.run(engine, plans, make_request, seconds,
                                   mix.get("think_s", 0.0), hooks, sent)
    finally:
        gc.enable()
    t_end = time.perf_counter()
    if state["on"]:
        timeline = prof.stop()
        timeline.steps = (state["first"], log.n_steps)
    if on_card:
        torch.cuda.synchronize()
        window_peak = torch.cuda.max_memory_allocated()
        dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                   count=cell["chips"],
                   memory_peak_bytes=int(max(setup_peak, window_peak)))
        if limit_w is not None:
            dev["power_limit_w"] = limit_w
    else:
        window_peak = _held_bytes(engine)
        dev = dict(platform="cpu", kind="cpu", count=1,
                   memory_peak_bytes=window_peak)
    launches = launch_counts()
    n_prefill = engine.prefill_calls - p0
    n_decode = engine.decode_calls - d0
    spans = [e for e in tracer.events() if e["ph"] == "X"] if trace else []
    tracer.disable()
    tracer.clear()

    # end-to-end, from the clients' side
    stamps = [t for r in sent for t in r.times if t_open <= t <= t_close]
    gaps = [b2 - a for r in sent for a, b2 in zip(r.times, r.times[1:])
            if t_open <= a and b2 <= t_close]
    ttft = [r.times[0] - r.t_submit for r in sent
            if r.times and t_open <= r.times[0] <= t_close]
    e2e = {"tokens_per_s": len(stamps) / seconds,
           "itl_p95_ms": float(np.percentile(gaps, 95)) * 1e3 if gaps
           else None,
           "ttft_p50_ms": float(np.median(ttft)) * 1e3 if ttft else None,
           "peak_mem_gb": window_peak / 1e9,
           "setup_s": setup_s}

    metrics: Dict[str, dict] = {}
    if not trace:
        for m in man["end_to_end"]:
            if name in m.get("workloads", [name]) and \
                    e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    breakdown = None
    if trace:
        run = Run(device=device, window_s=t_end - t_open, spans=[
                      s for s in spans if t_open <= s["t_s"] <= t_close],
                  calls=log.calls)
        if timeline is not None:
            lo, hi = timeline.steps
            run.timeline = timeline
            run.prof_calls = [c for c in log.calls if lo <= c["step"] < hi]
            want = sum(counts.launches(z)[c["kind"]].get("cim_gemv", 0)
                       for c in run.prof_calls)
            # the trace is whole when it holds every `cim_gemv` launch
            run.timeline_ok = want > 0 and timeline.count("cim_gemv") == want
            dev["busy_s"] = timeline.busy_s()
            dev["window_s"] = timeline.window_s
            from devtrace import idle_gaps
            ops = sorted(timeline.by_name().items(),
                         key=lambda kv: -kv[1])[:10]
            idle = sorted(idle_gaps(timeline, log.step_t0[lo:hi],
                                    run.spans).items(),
                          key=lambda kv: -kv[1])[:10]
            breakdown = {"device_ops": [[k, v] for k, v in ops],
                         "idle_gaps": [[k, v] for k, v in idle]}
        for m in man["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            val = load_module("metrics", m["name"]).read(run)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}

    # the output check, with the engine and its state freed
    finished = [r for r in sent if r.req.done and not r.req.rejected
                and len(r.req.out_tokens) == r.max_new_tokens]
    failed = sum(1 for r in sent if r.req.rejected or r.req.truncated
                 or r.req.cancelled)
    served = correct_mod.sample(finished, seed)
    if keep is not None:
        keep["served"] = served
    n_attempted = len(sent)
    del engine, sent, log, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    read = correct_mod.readings(conf, z, seed, device, served) \
        if served else {}
    checks: Dict[str, dict] = {
        k: {"value": read.get(k), "limit": lim}
        for k, lim in conf["correct"].items()}
    if on_card:
        per_call = counts.launches(z)
        off = 0
        for k, n in launches.items():
            want = (n_prefill * per_call["prefill"].get(k, 0)
                    + n_decode * per_call["decode"].get(k, 0))
            off += abs(n - want)
        checks["launches_off"] = {"value": off, "limit": 0}
    ok = failed == 0 and all(
        c["value"] is not None and c["limit"] is not None
        and c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(ok), "attempted": n_attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["readings"] = read
    out["checks"] = checks
    return out


def _held_bytes(engine) -> int:
    """Bytes of the engine's tensors (the CPU rehearsal's memory)."""
    import torch

    def walk(t):
        if isinstance(t, dict):
            return sum(walk(v) for v in t.values())
        if isinstance(t, torch.Tensor):
            return t.numel() * t.element_size()
        if hasattr(t, "data") and hasattr(t, "scales"):
            return walk(t.data) + walk(t.scales)
        return 0
    return walk(engine.params) + walk(engine.state)


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cell_of(manifest(), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), t_start)
    bad = forbidden_loaded()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
