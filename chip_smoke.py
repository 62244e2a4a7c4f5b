#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is retried or skipped):
  1. device: the card's name and power limit; build the CUDA kernels
     from src/repro_torch/csrc (one nvcc per source, in parallel).
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at qwen2.5-3b shapes, with a stated tolerance; then the time
     of one decode step's worth of calls (36 layers, batch 4, weights
     cold in L2) against its bound, the plain version's time and, where
     one PyTorch call computes the same function, that call's time.
  3. full model: qwen2.5-3b at full width (36 layers, INT4 weights drawn
     from a seed on the card, INT8 paged KV) served by PagedServeEngine:
     4 requests of 16-64 prompt tokens, 16 new tokens each, greedy.  The
     kernel launch counters are zeroed right before and read right
     after; each must equal its per-call count times the calls made.
  4. card vs CPU: a 2-layer full-width copy, one prefill chunk and one
     decode step through serve_step on the card (kernels) and on the CPU
     (plain versions) from the same weights.
  5. summary: a `{"kernels": [...]}` line, the card line, and last
     `{"ok": true, "device": {...}}`.

Imports nothing of the JAX package.  Needs the repository's src/ next to
this file; with no CUDA device it exits non-zero before printing any
result.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
TOL_REL = 1e-4                  # kernels vs plain, f32: |err| <= 1e-4 *
TOL_ABS = 1e-6                  #   max|plain| + 1e-6 (sum-order ulps)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of `fn`, CUDA events around `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int = 20) -> float:
    """Mean ms per replay of a CUDA graph capturing `fn`: the device time
    of its kernels with the host's per-launch cost taken out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_time_ms(graph.replay, iters)
    del graph
    return ms


class Checks:
    """Kernel-vs-plain comparisons, kept per kernel: the worst case by
    error over tolerance."""

    def __init__(self):
        self.worst = {}

    def compare(self, name: str, label: str, out, ref) -> None:
        import torch
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL_REL * float(ref.float().abs().max()) + TOL_ABS
        ok = err <= tol and math.isfinite(err)
        log(f"check {name:18s} {label:46s} max_abs_err {err:.3e} "
            f"tol {tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} {label}: max_abs_err {err} > tol {tol}")
        w = self.worst.get(name)
        if w is None or err / tol > w[0] / w[1]:
            self.worst[name] = (err, tol, label)


def build_full_model(device):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_model
    cfg = get_config("qwen2.5-3b").replace(dtype="float32", remat=False)
    return build_model(cfg, "int4", 128, device, seed=0)


def phase_kernels(model, params, device, checks: Checks):
    """Correctness at qwen2.5-3b shapes, then decode-step timings."""
    import torch
    from repro_torch.kernels.cim_gemv import cim_gemv, cim_gemv_plain
    from repro_torch.kernels.paged_flash_decode import (paged_decode_plain,
                                                        paged_flash_decode)
    from repro_torch.kernels.swiglu_gemv import swiglu_plain, swiglu_qgemv
    from repro_torch.quant.qarray import quantize

    cfg = model.cfg
    L, d, f, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    H, G = cfg.n_heads * cfg.hd(), cfg.n_kv_heads * cfg.hd()
    gen = torch.Generator(device=device).manual_seed(1)
    attn = params["blocks"]["attn"]
    ffn = params["blocks"]["ffn"]
    table = params["embed"]
    g_down = ffn["w_down"].group
    if d == 2048 and f == 11008 and g_down != 86:
        fail(f"qwen2.5-3b w_down group {g_down}, expected 86")

    # int8 counterparts of the same shapes and groups, packed on the card
    def q8(shape, like, axis=0):
        return quantize(torch.randn(shape, generator=gen, device=device)
                        * 0.02, 8, like.group, axis=axis)
    int8 = {"wq": q8((d, H), attn["wq"]), "wk": q8((d, G), attn["wk"]),
            "w_down": q8((f, d), ffn["w_down"]),
            "table": q8((V, d), table, 1),
            "w_gate": q8((d, f), ffn["w_gate"]),
            "w_up": q8((d, f), ffn["w_up"])}
    int4 = {"wq": attn["wq"][0], "wk": attn["wk"][0],
            "w_down": ffn["w_down"][0], "table": table,
            "w_gate": ffn["w_gate"][0], "w_up": ffn["w_up"][0]}

    for bits, ws in ((4, int4), (8, int8)):
        for m in (1, 4, 128):
            for name, k in (("wq", d), ("wk", d), ("w_down", f),
                            ("table", d)):
                w = ws[name]
                x = torch.randn(m, k, generator=gen, device=device)
                n = w.data.shape[0] if w.axis == -1 else w.data.shape[1]
                label = (f"int{bits} {name} {k}->{n} g{w.group} M={m}")
                checks.compare("cim_gemv", label, cim_gemv(x, w),
                               cim_gemv_plain(x, w))
            x = torch.randn(m, d, generator=gen, device=device)
            checks.compare("swiglu_qgemv",
                           f"int{bits} {d}->{f} g{ws['w_gate'].group} M={m}",
                           swiglu_qgemv(x, ws["w_gate"], ws["w_up"]),
                           swiglu_plain(x, ws["w_gate"], ws["w_up"]))
    del int8

    # paged decode: 4 lanes, 2 kv heads x 8 query heads, hd 128, ps 16,
    # shuffled tables, ragged lengths up to 1024
    b, g, qpk, hd, ps, max_pages = 4, cfg.n_kv_heads, cfg.q_per_kv(), \
        cfg.hd(), 16, 64
    n_pages = b * max_pages

    def pools(kind, layers=1):
        kf = torch.randn(layers, n_pages, ps, g, hd, generator=gen,
                         device=device)
        vf = torch.randn(layers, n_pages, ps, g, hd, generator=gen,
                         device=device)
        if kind == "bf16":
            return kf.bfloat16(), vf.bfloat16(), None, None
        ks = (kf.abs().amax(-1).clamp_min(1e-8) / 127).half()
        vs = (vf.abs().amax(-1).clamp_min(1e-8) / 127).half()
        kq = torch.round(kf / ks[..., None].float()).clamp(-127, 127)
        vq = torch.round(vf / vs[..., None].float()).clamp(-127, 127)
        return kq.to(torch.int8), vq.to(torch.int8), ks, vs

    q = torch.randn(b, g, qpk, hd, generator=gen, device=device)
    tables = torch.randperm(n_pages, generator=gen, device=device
                            ).reshape(b, max_pages).int()
    lengths = torch.tensor([1024, 777, 301, 45], dtype=torch.int32,
                           device=device)
    for kind, window, cap in (("int8", 0, 0.0), ("bf16", 0, 0.0),
                              ("int8", 200, 0.0), ("int8", 0, 30.0)):
        kp, vp, ks, vs = pools(kind)
        sc = (ks[0], vs[0]) if ks is not None else (None, None)
        checks.compare(
            "paged_flash_decode",
            f"{kind} pools b={b} len<=1024 window={window} cap={cap}",
            paged_flash_decode(q, kp[0], vp[0], tables, lengths, window,
                               cap, *sc),
            paged_decode_plain(q, kp[0], vp[0], tables, lengths, window,
                               cap, *sc))
    zl = lengths.clone()
    zl[3] = 0
    kp, vp, ks, vs = pools("int8")
    out = paged_flash_decode(q, kp[0], vp[0], tables, zl, 0, 0.0, ks[0],
                             vs[0])
    ref = paged_decode_plain(q, kp[0], vp[0], tables, zl, 0, 0.0, ks[0],
                             vs[0])
    keep = zl > 0
    checks.compare("paged_flash_decode", "int8 pools, a length-0 lane",
                   out[keep], ref[keep])
    torch.cuda.synchronize()
    log(f"length-0 lane: kernel max|out| {float(out[3].abs().max()):.3e} "
        f"(zeros), plain max|out| {float(ref[3].abs().max()):.3e} "
        "(mean of masked rows); the engine drops this row")

    # ---- timings: one decode step's calls at batch 4, 36 layers -------
    M = 4
    x = torch.randn(M, d, generator=gen, device=device)
    xd = torch.randn(M, f, generator=gen, device=device)
    layers = [{k: attn[k][i] for k in ("wq", "wk", "wv", "wo")}
              | {k: ffn[k][i] for k in ("w_gate", "w_up", "w_down")}
              for i in range(L)]

    def cim_step(fn):
        for lw in layers:
            for k in ("wq", "wk", "wv"):
                fn(x, lw[k])
            fn(x, lw["wo"])
            fn(xd, lw["w_down"])
        fn(x, table)

    cim_bytes = sum(lw[k].nbytes_packed() for lw in layers
                    for k in ("wq", "wk", "wv", "wo", "w_down")) \
        + table.nbytes_packed()
    cim_out = sum(lw[k].data.shape[1] for lw in layers
                  for k in ("wq", "wk", "wv", "wo", "w_down")) + V
    cim_in = L * (3 * d + H + f) + d
    cim_flops = 2 * M * (sum(lw[k].orig_shape[0] * lw[k].orig_shape[1]
                             for lw in layers
                             for k in ("wq", "wk", "wv", "wo", "w_down"))
                         + V * d)
    cim_bytes += 4 * M * (cim_in + cim_out)

    def sw_step(fn):
        for lw in layers:
            fn(x, lw["w_gate"], lw["w_up"])

    sw_bytes = sum(lw["w_gate"].nbytes_packed() + lw["w_up"].nbytes_packed()
                   for lw in layers) + L * 4 * M * (d + f)
    sw_flops = L * 2 * 2 * M * d * f

    kp, vp, ks, vs = pools("int8", layers=L)

    def pd_step(fn):
        for i in range(L):
            fn(q, kp[i], vp[i], tables, lengths, 0, 0.0, ks[i], vs[i])

    tokens = int(lengths.sum())
    pd_bytes = L * (tokens * g * (2 * hd + 2 * 2) + 2 * q.numel() * 4
                    + b * (max_pages + 1) * 4)
    pd_flops = L * tokens * g * qpk * hd * 4

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    timings = {}
    for name, step, plain, nbytes, flops in (
            ("cim_gemv", cim_step, cim_gemv_plain, cim_bytes, cim_flops),
            ("swiglu_qgemv", sw_step, swiglu_plain, sw_bytes, sw_flops),
            ("paged_flash_decode", pd_step, paged_decode_plain, pd_bytes,
             pd_flops)):
        kernel_fn = {"cim_gemv": cim_gemv, "swiglu_qgemv": swiglu_qgemv,
                     "paged_flash_decode": paged_flash_decode}[name]
        ms = graph_time_ms(lambda: step(kernel_fn))
        eager_ms = cuda_time_ms(lambda: step(kernel_fn), iters=10)
        plain_ms = cuda_time_ms(lambda: step(plain), iters=2, warmup=1)
        b_ms, b_by = bound(nbytes, flops)
        timings[name] = dict(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None,
                             step_bytes=nbytes)
        log(f"time {name:18s} one decode step (M={M}, {L} layers): "
            f"kernel {ms:.4f} ms (graph replay; eager dispatch "
            f"{eager_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB), "
            f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s")
    # where cim_gemv's time goes: each projection over 36 layers, and the
    # logits table once
    for k, xin in (("wq", x), ("wk", x), ("wo", x), ("w_down", xd)):
        ws = [lw[k] for lw in layers]
        t = graph_time_ms(lambda: [cim_gemv(xin, w) for w in ws])
        nb = sum(w.nbytes_packed() for w in ws)
        log(f"time cim_gemv part {k:6s} x{L}: {t:.4f} ms, "
            f"{nb / 1e6:.2f} MB, {nb / (t * 1e-3) / 1e12:.3f} TB/s")
    t = graph_time_ms(lambda: cim_gemv(x, table))
    log(f"time cim_gemv part table  x1: {t:.4f} ms, "
        f"{table.nbytes_packed() / 1e6:.2f} MB, "
        f"{table.nbytes_packed() / (t * 1e-3) / 1e12:.3f} TB/s")
    for n_live in (64, 1024):
        ln = torch.full((b,), n_live, dtype=torch.int32, device=device)
        t = graph_time_ms(lambda: [paged_flash_decode(
            q, kp[i], vp[i], tables, ln, 0, 0.0, ks[i], vs[i])
            for i in range(L)])
        log(f"time paged_flash_decode x{L}, all {b} lanes at length "
            f"{n_live}: {t:.4f} ms")
    del kp, vp, ks, vs
    torch.cuda.empty_cache()
    return timings


def phase_full_model(model, params, device):
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import PagedServeEngine, ServeConfig, ServeRequest

    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(16, 65, size=4)]
    n_new = 16
    eng = PagedServeEngine(model, params, ServeConfig(
        precision="int4", kv_dtype="auto", max_batch=4, max_seq=128,
        page_size=16, prefill_chunk=16), device=device)
    reqs = [ServeRequest(prompt=p, max_new_tokens=n_new, rid=i)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for r in reqs:
        eng.submit(r)
    decode_ms = []
    reset_launch_counts()
    t_run = time.perf_counter()
    while eng.busy:
        pre = eng.prefill_calls
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if eng.prefill_calls == pre:
            decode_ms.append((time.perf_counter() - t0) * 1e3)
    run_s = time.perf_counter() - t_run
    counts = launch_counts()
    m = eng.summary()
    gen_tokens = sum(len(r.out_tokens) for r in reqs)
    log(f"full model: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
        f"vocab={cfg.vocab}, prompts {[len(p) for p in prompts]}, "
        f"{gen_tokens} tokens generated in {run_s:.2f} s")
    if gen_tokens != 4 * n_new or not all(r.done for r in reqs):
        fail(f"generated {gen_tokens} tokens, expected {4 * n_new}")
    for r in reqs:
        if not all(0 <= t < cfg.vocab for t in r.out_tokens):
            fail(f"token out of range in request {r.rid}")
    calls = eng.prefill_calls + eng.decode_calls
    expect = {"cim_gemv": (5 * cfg.n_layers + 1) * calls,
              "swiglu_qgemv": cfg.n_layers * calls,
              "paged_flash_decode": cfg.n_layers * eng.decode_calls}
    log(f"serve_step calls: {eng.prefill_calls} prefill + "
        f"{eng.decode_calls} decode; launches {counts}, expected {expect}")
    if counts != expect or min(counts.values()) <= 0:
        fail(f"kernel launches {counts} != expected {expect}")
    per_step = 5 * cfg.n_layers + 1 + 2 * cfg.n_layers
    med = float(np.median(decode_ms)) if decode_ms else float("nan")
    result = {
        "tokens": gen_tokens,
        "decode_tok_s": eng.throughput(),
        "decode_step_ms_median": med,
        "decode_steps": len(decode_ms),
        "ttft_p50_ms": m["ttft_p50_s"] * 1e3,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_decode_step": per_step,
        "launches": counts,
    }
    log("full model result " + json.dumps(result))
    profile_decode_step(model, params, eng, device)
    return counts


def profile_decode_step(model, params, eng, device, steps: int = 3):
    """torch.profiler over a few batch-4 decode `serve_step` calls on the
    engine's pools (lanes at length 64): host wall time per step against
    the device time of the kernels it ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b, mp = eng.max_batch, eng.cache.max_pages
    tables = torch.arange(b * mp, dtype=torch.int32,
                          device=device).reshape(b, mp)
    lengths = torch.full((b,), 64, dtype=torch.int32, device=device)
    ones = torch.ones(b, dtype=torch.int32, device=device)
    tok = torch.zeros((b, 1), dtype=torch.int32, device=device)

    def step():
        model.serve_step(params, eng.cache.pools, {"tokens": tok}, tables,
                         lengths, ones)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = {}
    n_dev = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dur = e.time_range.end - e.time_range.start
            by_name[e.name] = by_name.get(e.name, 0.0) + dur
            n_dev += 1
    dev_ms = sum(by_name.values()) / 1e3 / steps
    if n_dev == 0:
        log(f"decode step profile: wall {wall_ms:.3f} ms/step; device "
            "time not measured (the profiler recorded no CUDA events)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"decode step profile: wall {wall_ms:.3f} ms/step, device "
        f"{dev_ms:.3f} ms/step busy ({100 * dev_ms / wall_ms:.1f} %), "
        f"{n_dev / steps:.0f} device events/step; top: " + "; ".join(
            f"{n[:60]} {d / 1e3 / steps:.3f} ms" for n, d in top))


def phase_card_vs_cpu(device):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_model
    from repro_torch.models.common import tree_to

    cfg = get_config("qwen2.5-3b").replace(dtype="float32", remat=False,
                                           n_layers=2)
    model, params_cpu = build_model(cfg, "int4", 128, "cpu", seed=2)
    outs = {}
    for dev in ("cpu", device):
        p = tree_to(params_cpu, dev)
        cache = {"attn": {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                          for k, v in model.paged_cache_specs(
                              16, 16, torch.int8)["attn"].items()}}
        tables = torch.arange(16, dtype=torch.int32, device=dev).reshape(2, 8)
        g = torch.Generator().manual_seed(3)
        tok = torch.randint(0, cfg.vocab, (2, 16), generator=g).to(dev)
        lengths = torch.zeros(2, dtype=torch.int32, device=dev)
        n_new = torch.tensor([16, 11], dtype=torch.int32, device=dev)
        pre, _ = model.serve_step(p, cache, {"tokens": tok}, tables,
                                  lengths, n_new)
        dec, _ = model.serve_step(p, cache, {"tokens": tok[:, :1]}, tables,
                                  lengths + n_new,
                                  torch.ones(2, dtype=torch.int32,
                                             device=dev))
        outs[str(dev)] = torch.cat([pre[0], pre[1, :11], dec[:, 0]]).cpu()
        del p, cache
    ref, got = outs["cpu"], outs[str(device)]
    if got.shape != (29, cfg.vocab) or not torch.isfinite(got).all():
        fail(f"card logits {tuple(got.shape)} not finite / wrong shape")
    err = float((got - ref).abs().max())
    # f32 sum order plus int8 KV rows that round one step apart
    tol = 5e-3 * max(1.0, float(ref.abs().max()))
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    agree = (got.argmax(-1) == ref.argmax(-1))[clear]
    log(f"card vs CPU, 2-layer full width: max logit diff {err:.3e} "
        f"(tol {tol:.3e}, max|logit| {float(ref.abs().max()):.3f}); "
        f"argmax agrees on {int(agree.sum())}/{int(clear.sum())} rows "
        "with a top-2 gap above tol")
    if err > tol or not bool(agree.all()):
        fail("card and CPU logits disagree")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"the port's package is not next to this script ({src})")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_all = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    kind = torch.cuda.get_device_name(0)
    log(f"device {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    from repro_torch.kernels import _build
    import repro_torch.kernels.cim_gemv as cim_gemv
    import repro_torch.kernels.paged_flash_decode as paged_flash_decode
    import repro_torch.kernels.swiglu_gemv as swiglu_gemv
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"built {built or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    model, params = build_full_model(device)
    torch.cuda.synchronize()
    log(f"qwen2.5-3b INT4 weights drawn and packed on the card in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    checks = Checks()
    timings = phase_kernels(model, params, device, checks)
    counts = phase_full_model(model, params, device)
    del params
    torch.cuda.empty_cache()
    phase_card_vs_cpu(device)

    mods = {"cim_gemv": cim_gemv, "swiglu_qgemv": swiglu_gemv,
            "paged_flash_decode": paged_flash_decode}
    kernels = []
    for name, mod in mods.items():
        err, tol, label = checks.worst[name]
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": counts[name],
            "max_abs_err": err, "max_err": err, "tol": tol,
            "worst_case": label,
            "ms": t["ms"], "eager_ms": t["eager_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "timed": "one decode step's calls, batch 4, 36 layers; ms is "
                     "CUDA-graph replay, eager_ms host-dispatched"})
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
