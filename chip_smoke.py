#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is retried or skipped):
  1. device: the card's name and power limit; build the five CUDA
     kernels from src/repro_torch/csrc (one nvcc per source, in
     parallel), and beside them one `-Xptxas -v` compile of each
     split-KV source, of cim_gemv.cu and of swiglu_gemv.cu (registers,
     stack, spills).
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at qwen2.5-3b shapes, with a stated tolerance; cim_gemv and
     swiglu_qgemv also at M = 9 (past an M tile), 20 and 128, on weights
     whose rows are not 16-byte aligned and on the 172 -> 68 shape with
     groups of 43, every call twice (bitwise equal); the split-KV
     kernels (`paged_flash_verify` too) also at their split boundaries,
     at batch 1, for rows that see no key (compared in full), and
     called twice (bitwise equal); `paged_flash_verify` also at s = 9
     and 24 (more than one block of rows).  Then the time of one decode
     step's worth of calls (36 layers, batch 4, weights cold in L2), of
     a verify step's cim_gemv and swiglu_qgemv calls (M = 20), one
     verify step's `paged_flash_verify` calls (s = 5) and 36
     `flash_decode` calls, each against its bound, the plain version's
     time and, where one PyTorch call computes the same function, that
     call's time; the three split-KV kernels also at batch 1 over 4096
     keys, each with its fold / merge split.  A CUDA graph of one
     cim_gemv call, and of one swiglu_qgemv call at M = 4 and at M =
     20, holds one node, a kernel; of one verify call, at most two (the
     fold, then the merge).
  3. full model: qwen2.5-3b at full width (36 layers, INT4 weights drawn
     from a seed on the card, INT8 paged KV) served by PagedServeEngine:
     two waves of 4 requests of 16-64 prompt tokens, 16 new tokens each,
     greedy; first with the steps as CUDA graphs (the engine's default),
     then eagerly (`eager=True`), and the greedy streams must agree.
     The kernel launch counters are zeroed right before each run and
     read right after; each must equal its per-call count times the
     calls made (a replay counts the kernels its capture recorded).
     Each (step, shape) is captured once and its graph holds one call's
     kernels; two replays of the decode graph on the same inputs are
     bitwise equal.  Logged beside each other: decode step wall median,
     host ms per step (wall - the replay's device ms), TTFT p50 per
     wave, peak memory.  A profile of a decode step, eager and as a
     replay, must show no second cim_gemv or swiglu_qgemv pass
     (`reduce_kernel`, `epilogue_kernel`).  Each wave's EdgeCIM
     energy meter must have charged exactly the decode tokens served;
     wave 2's `sim_*` keys (cost-model output, labelled so) are logged
     beside the decode tokens/s measured on the card.  The graph engine
     then serves a third wave with the tracer on: its `prefill_chunk` /
     `decode_step` spans must equal the engine's calls, and every
     request must have one submit, admit and finish in the flight
     recorder, and its Chrome trace is written under build/chip_smoke/.
     Wave 3's prompts are then served four more times, tracer off, on,
     off, on, and the decode step wall medians with the tracer off and
     on are logged beside wave 2's.
  4. speculative decoding: the same model and engine with
     SpecConfig(drafter="ngram", k=4) on prompts that repeat a motif,
     32 new tokens each, against the same prompts without speculation;
     then a short run with the launcher's 1-layer draft model; each
     speculative run as CUDA graphs and once more eagerly, streams
     compared.  Counters as in phase 3: `paged_flash_verify` must run
     36 times per verify call.  Graphs as in phase 3, the draft model's
     steps too.  A profile of one verify step, eager and as a replay,
     splits its device time.  The n-gram run as graphs, eager and its
     statistics stay untraced; a further n-gram graph run, traced, logs
     the median `spec_draft` and `spec_verify` span per verify call, and
     its spans' drafted / accepted sums must equal the telemetry's (and
     the flight recorder's).
  5. decode_attention: the public entry point over a contiguous cache,
     36 calls at qwen2.5-3b's attention shape, through `flash_decode`.
  6. card vs CPU: a 2-layer full-width copy, one prefill chunk and one
     decode step through serve_step on the card (kernels) and on the CPU
     (plain versions) from the same weights.
  7. summary: a `{"kernels": [...]}` line, the card line, and last
     `{"ok": true, "device": {...}}`.

Imports nothing of the JAX package.  Needs the repository's src/ next to
this file; with no CUDA device it exits non-zero before printing any
result.
"""
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
TOL_REL = 1e-4                  # kernels vs plain, f32: |err| <= 1e-4 *
TOL_ABS = 1e-6                  #   max|plain| + 1e-6 (sum-order ulps)
LOGIT_TOL = 5e-3                # model logits, relative to max(1, max|logit|):
                                #   f32 sum order plus int8 KV rows that
                                #   round one step apart


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


def bound(nbytes: float, flops: float):
    """(least ms, what sets it): bytes over the HBM rate or f32
    operations over the f32 rate, whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


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

    def repeat(self, name: str, label: str, first, second) -> None:
        """Two calls on the same inputs must agree bit for bit."""
        import torch
        torch.cuda.synchronize()
        same = torch.equal(first, second)
        log(f"check {name:18s} {label:46s} second call bitwise "
            f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            fail(f"{name} {label}: two calls on the same inputs differ")


def start_ptxas(names=("paged_flash_decode", "paged_flash_verify",
                       "flash_decode", "cim_gemv", "swiglu_gemv")):
    """One extra compile of the split-KV sources, cim_gemv.cu and
    swiglu_gemv.cu with `-Xptxas -v`, started beside the build:
    registers, stack, static shared memory and spills per kernel."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    return [(n, subprocess.Popen(
        [_build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o",
         str(_build.BUILD_DIR / f"ptxas-{n}.o"),
         str(_build.CSRC / f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for n in names]


def log_ptxas(procs) -> None:
    kern = re.compile(r"(flash_decode_kernel|decode_kernel|verify_kernel|"
                      r"merge_kernel)(?:I(a|f|13__nv_bfloat16)Li(\d+)E)?")
    types = {"a": "int8", "f": "f32", "13__nv_bfloat16": "bf16"}
    # cim_gemv and swiglu_qgemv: <bits, M tile, copy bytes>
    qkern = re.compile(r"(cols_kernel|rows_kernel|swiglu_kernel)"
                       r"ILi(\d+)ELi(\d+)ELi(\d+)E")
    for name, proc in procs:
        text, _ = proc.communicate(timeout=600)
        if proc.returncode:
            fail(f"nvcc -Xptxas -v failed for {name}.cu:\n{text}")
        fn, spill, rows = None, "", []
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k, qk = kern.search(m.group(1)), qkern.search(m.group(1))
                fn = (f"{qk.group(1)}<int{qk.group(2)},MT{qk.group(3)},"
                      f"{qk.group(4)}B>" if qk else
                      f"{k.group(1)}<{types.get(k.group(2), '')},"
                      f"{k.group(3) or ''}>" if k else m.group(1)[:40])
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                spill = (f"stack {m.group(1)} B, spills {m.group(2)}/"
                         f"{m.group(3)} B")
                continue
            m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$",
                          line)
            if m and fn:
                smem = f", static smem {m.group(2)} B" if m.group(2) else ""
                rows.append(f"{fn} {m.group(1)} regs, {spill}{smem}")
                fn = None
        log(f"ptxas {name}.cu: " + "; ".join(rows))


def build_full_model(device):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_model
    cfg = get_config("qwen2.5-3b").replace(dtype="float32", remat=False)
    return build_model(cfg, "int4", 128, device, seed=0)


def phase_kernels(model, params, device, checks: Checks):
    """Correctness at qwen2.5-3b shapes, then decode-step timings."""
    import torch
    from repro_torch.kernels.cim_gemv import (cim_gemv, cim_gemv_plain,
                                              smem_bytes, split_plan,
                                              vec_bytes)
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.flash_decode import plan as flash_plan
    from repro_torch.kernels.paged_flash_decode import (decode_plan,
                                                        paged_decode_plain,
                                                        paged_flash_decode,
                                                        paged_flash_verify,
                                                        paged_verify_plain,
                                                        verify_plan)
    from repro_torch.kernels.split_decode import (sm_count, verify_geometry,
                                                  verify_smem_bytes)
    from repro_torch.kernels import swiglu_gemv as sw
    from repro_torch.kernels.swiglu_gemv import swiglu_plain, swiglu_qgemv
    from repro_torch.quant.qarray import QTensor, quantize

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

    # cim_gemv: the 16-byte instantiation at every main-path shape, and
    # the 4-byte one on weights whose rows are not 16-byte aligned (a
    # copy 4 bytes into a buffer, and the 172 -> 68 test shape)
    def shifted(w):
        flat = torch.empty(w.data.numel() + 4, dtype=w.data.dtype,
                           device=device)
        data = flat[4:].view(w.data.shape)
        data.copy_(w.data)
        return QTensor(data, w.scales, w.bits, w.group, w.axis,
                       w.orig_shape)

    for bits, ws in ((4, int4), (8, int8)):
        odd = quantize(torch.randn(172, 68, generator=gen, device=device),
                       bits, 43)
        # swiglu_qgemv: gate/up at qwen2.5-3b's shape, the same copied 4
        # bytes into a buffer (the 4-byte instantiation), the 172 -> 68
        # shape with groups of 43
        sw_cases = [("gate/up", d, ws["w_gate"], ws["w_up"]),
                    ("gate/up at +4 B", d, shifted(ws["w_gate"]),
                     shifted(ws["w_up"])),
                    ("odd", 172, odd,
                     quantize(torch.randn(172, 68, generator=gen,
                                          device=device), bits, 43))]
        cases = [("wq", d, ws["wq"]), ("wk", d, ws["wk"]),
                 ("w_down", f, ws["w_down"]), ("table", d, ws["table"]),
                 ("wq at +4 B", d, shifted(ws["wq"])),
                 ("table at +4 B", d, shifted(ws["table"])),
                 ("odd", 172, odd)]
        for m in (1, 4, 9, 20, 128):     # 9: past an M tile; 20: a verify
            for name, k, w in cases:     #   step's b * (k + 1)
                x = torch.randn(m, k, generator=gen, device=device)
                n = w.data.shape[0] if w.axis == -1 else w.data.shape[1]
                row = w.data.shape[1] if w.axis == -1 else n
                label = (f"int{bits} {name} {k}->{n} g{w.group} M={m} "
                         f"{vec_bytes(w, row)}B")
                out = cim_gemv(x, w)
                checks.compare("cim_gemv", label, out, cim_gemv_plain(x, w))
                checks.repeat("cim_gemv", label, out, cim_gemv(x, w))
            for name, k, wg, wu in sw_cases:
                x = torch.randn(m, k, generator=gen, device=device)
                ff = wg.data.shape[1]
                label = (f"int{bits} {name} {k}->{ff} g{wg.group} M={m} "
                         f"{min(vec_bytes(wg, ff), vec_bytes(wu, ff))}B")
                out = swiglu_qgemv(x, wg, wu)
                checks.compare("swiglu_qgemv", label, out,
                               swiglu_plain(x, wg, wu))
                checks.repeat("swiglu_qgemv", label, out,
                              swiglu_qgemv(x, wg, wu))
    del int8

    # paged decode: 4 lanes, 2 kv heads x 8 query heads, hd 128, ps 16,
    # shuffled tables, ragged lengths up to 1024
    b, g, qpk, hd, ps, max_pages = 4, cfg.n_kv_heads, cfg.q_per_kv(), \
        cfg.hd(), 16, 64
    n_pages = b * max_pages

    def pools(kind, layers=1, n_pages=n_pages):
        kf = torch.randn(layers, n_pages, ps, g, hd, generator=gen,
                         device=device)
        vf = torch.randn(layers, n_pages, ps, g, hd, generator=gen,
                         device=device)
        if kind == "f32":
            return kf, vf, None, None
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
    checks.compare("paged_flash_decode", "int8 pools, a length-0 lane",
                   paged_flash_decode(q, kp[0], vp[0], tables, zl, 0, 0.0,
                                      ks[0], vs[0]),
                   paged_decode_plain(q, kp[0], vp[0], tables, zl, 0, 0.0,
                                      ks[0], vs[0]))

    # split-KV cases: the plan's split boundary (`chunk` keys), lengths on
    # it and one past it, length 1 and 0, a window across a boundary,
    # every pool type, batch 1; every lane compared in full (a length-0
    # lane gets the mean of V over its whole table)
    n_split, chunk = decode_plan(b, g, max_pages, ps, sm_count(device))
    log(f"plan paged_flash_decode b={b} g={g} max_pages={max_pages} "
        f"ps={ps}: n_split {n_split}, chunk {chunk} keys, "
        f"{b * g * n_split} blocks")
    edge = torch.tensor([chunk, chunk + 1, 1, 0], dtype=torch.int32,
                        device=device)
    cross = torch.tensor([2 * chunk + 7, 777, chunk + 5, 0],
                         dtype=torch.int32, device=device)
    for kind, lv, window, cap in (
            ("int8", edge, 0, 0.0), ("bf16", edge, 0, 0.0),
            ("f32", edge, 0, 0.0), ("int8", cross, 20, 0.0),
            ("f32", cross, 20, 30.0), ("int8", edge, 0, 30.0)):
        kp, vp, ks, vs = pools(kind)
        sc = (ks[0], vs[0]) if ks is not None else (None, None)
        args = (q, kp[0], vp[0], tables, lv, window, cap, *sc)
        out = paged_flash_decode(*args)
        checks.compare(
            "paged_flash_decode",
            f"{kind} pools b={b} len {lv.tolist()} window={window} "
            f"cap={cap}", out, paged_decode_plain(*args))
        checks.repeat("paged_flash_decode", f"{kind} len {lv.tolist()}",
                      out, paged_flash_decode(*args))
    for kind in ("int8", "f32"):
        kp, vp, ks, vs = pools(kind)
        sc = (ks[0], vs[0]) if ks is not None else (None, None)
        for n in (1, chunk, 1024):
            l1 = torch.tensor([n], dtype=torch.int32, device=device)
            args = (q[:1].contiguous(), kp[0], vp[0], tables[:1], l1, 0,
                    0.0, *sc)
            checks.compare("paged_flash_decode",
                           f"{kind} pools batch 1 len {n}",
                           paged_flash_decode(*args),
                           paged_decode_plain(*args))

    # paged verify: windows of s = 1, 2, 5 at the same shapes; lane 0's
    # window crosses a page boundary, lane 1's ends at the table's last
    # row.  Split-KV cases: lane 0's first row ends on the plan's split
    # boundary, lane 1's first row one past it, length 0; window 1 with
    # windows past the table (rows that see no key: the mean of V over
    # the table); s = 9 and 24 (72 and 192 rows: more than one block of
    # rows).  Every lane compared in full, every case called twice.
    n_keys = max_pages * ps
    for kind, s, lens, window, cap in (
            [(kd, sv, "tail", 0, 0.0) for kd in ("int8", "bf16", "f32")
             for sv in (1, 2, 5)]
            + [("int8", 5, "tail", 200, 0.0), ("int8", 5, "tail", 0, 30.0),
               ("f32", 2, "tail", 200, 30.0)]
            + [(kd, 5, "edge", 0, 0.0) for kd in ("int8", "bf16", "f32")]
            + [("int8", 2, "edge", 0, 30.0), ("int8", 5, "edge", 20, 0.0),
               ("int8", 5, "past", 1, 0.0), ("f32", 2, "past", 1, 30.0),
               ("int8", 9, "tail", 0, 0.0), ("bf16", 24, "edge", 0, 0.0)]):
        kp, vp, ks, vs = pools(kind)
        sc = (ks[0], vs[0]) if ks is not None else (None, None)
        qv = torch.randn(b, s, g, qpk, hd, generator=gen, device=device)
        _, vchunk = verify_plan(b, g, s, qpk, max_pages, ps,
                                sm_count(device))
        lv = torch.tensor({
            "tail": [3 * ps - 1, n_keys - s, 301, 45],
            "edge": [vchunk - 1, vchunk, 0, n_keys - s],
            "past": [n_keys - 2, n_keys - 1, n_keys + 3, 0]}[lens],
            dtype=torch.int32, device=device)
        args = (qv, kp[0], vp[0], tables, lv, window, cap, *sc)
        label = (f"{kind} pools s={s} len {lv.tolist()} window={window} "
                 f"cap={cap}")
        out = paged_flash_verify(*args)
        checks.compare("paged_flash_verify", label, out,
                       paged_verify_plain(*args))
        checks.repeat("paged_flash_verify", label, out,
                      paged_flash_verify(*args))
    kp, vp, ks, vs = pools("int8")
    q1 = torch.randn(b, 1, g, qpk, hd, generator=gen, device=device)
    checks.compare(
        "paged_flash_verify", "int8 s=1 vs paged_flash_decode(lengths + 1)",
        paged_flash_verify(q1, kp[0], vp[0], tables, lengths - 1, 0, 0.0,
                           ks[0], vs[0])[:, 0],
        paged_flash_decode(q1[:, 0].contiguous(), kp[0], vp[0], tables,
                           lengths, 0, 0.0, ks[0], vs[0]))
    del kp, vp, ks, vs

    # flash_decode over a contiguous cache: b*g = 8 rows of 8 query heads
    bg = b * g
    qf = torch.randn(bg, qpk, hd, generator=gen, device=device)
    for dt in (torch.float32, torch.bfloat16):
        for S, pos, window, cap in ((1024, 0, 0, 0.0), (1024, 300, 0, 0.0),
                                    (1024, 1023, 0, 0.0),
                                    (1024, 900, 200, 0.0),
                                    (1024, 700, 0, 30.0),
                                    (1000, 999, 0, 0.0)):
            kc = torch.randn(bg, S, hd, generator=gen, device=device).to(dt)
            vc = torch.randn(bg, S, hd, generator=gen, device=device).to(dt)
            checks.compare(
                "flash_decode",
                f"{str(dt)[6:]} S={S} pos={pos} window={window} cap={cap}",
                flash_decode(qf, kc, vc, pos, window, cap),
                flash_decode_plain(qf, kc, vc, pos, window, cap))
    pos_t = torch.tensor(511, dtype=torch.int32, device=device)
    checks.compare("flash_decode", "f32 S=1000 pos=511 as a device tensor",
                   flash_decode(qf, kc.float(), vc.float(), pos_t),
                   flash_decode_plain(qf, kc.float(), vc.float(), 511))
    # split-KV cases: pos on and one past a split boundary, a window
    # across one, no visible key (pos < 0; a window past the cache: the
    # mean of V over all S keys), batch 1 (b*g = 2), repeat bitwise
    n_split, chunk = flash_plan(bg, 1024, sm_count(device))
    log(f"plan flash_decode b*g={bg} S=1024: n_split {n_split}, chunk "
        f"{chunk} keys, {bg * n_split} blocks")
    for dt, rows, S, pos, window, cap in (
            (torch.float32, bg, 1024, chunk - 1, 0, 0.0),
            (torch.float32, bg, 1024, chunk, 0, 0.0),
            (torch.bfloat16, bg, 1024, 2 * chunk + 7, 20, 0.0),
            (torch.float32, bg, 1024, 2 * chunk + 7, 20, 30.0),
            (torch.float32, bg, 1024, -1, 0, 0.0),
            (torch.bfloat16, bg, 1000, 5000, 10, 0.0),
            (torch.float32, 2, 4096, 4095, 0, 0.0),
            (torch.float32, 2, 4096, 1, 0, 0.0)):
        qx = qf[:rows].contiguous()
        kc = torch.randn(rows, S, hd, generator=gen, device=device).to(dt)
        vc = torch.randn(rows, S, hd, generator=gen, device=device).to(dt)
        label = (f"{str(dt)[6:]} b*g={rows} S={S} pos={pos} "
                 f"window={window} cap={cap}")
        out = flash_decode(qx, kc, vc, pos, window, cap)
        checks.compare("flash_decode", label, out,
                       flash_decode_plain(qx, kc, vc, pos, window, cap))
        checks.repeat("flash_decode", label, out,
                      flash_decode(qx, kc, vc, pos, window, cap))
    del kc, vc

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

    timings = {}

    def time_kernel(name, what, step, kernel_fn, plain, nbytes, flops,
                    library=None, key=None):
        """`step(fn)` runs one step's calls of `fn`; kernel time is a
        CUDA-graph replay, eager and plain are dispatched one by one.
        Stored under `key` (default: the kernel's name)."""
        ms = graph_time_ms(lambda: step(kernel_fn))
        eager_ms = cuda_time_ms(lambda: step(kernel_fn), iters=10)
        plain_ms = cuda_time_ms(lambda: step(plain), iters=2, warmup=1)
        lib_ms = graph_time_ms(lambda: step(library)) if library else None
        b_ms, b_by = bound(nbytes, flops)
        timings[key or name] = dict(
            ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, bound_share=b_ms / ms, library_ms=lib_ms,
            step_bytes=nbytes, step_flops=flops, timed=what)
        lib = f"{lib_ms:.4f} ms" if library else "none"
        log(f"time {name:18s} {what}: kernel {ms:.4f} ms (graph replay; "
            f"eager dispatch {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"library {lib}, bound {b_ms:.4f} ms ({b_by}: "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), "
            f"bound share {100 * b_ms / ms:.2f} %, "
            f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, "
            f"{flops / (ms * 1e-3) / 1e12:.3f} TFLOP/s")

    what = f"one decode step's calls, batch {M}, {L} layers"
    time_kernel("cim_gemv", what, cim_step, cim_gemv, cim_gemv_plain,
                cim_bytes, cim_flops)
    # a verify step's 181 calls: M = 20 rows (batch 4 x k + 1 = 5)
    Mv = 20
    xv20 = torch.randn(Mv, d, generator=gen, device=device)
    xd20 = torch.randn(Mv, f, generator=gen, device=device)

    def cim_verify_step(fn):
        for lw in layers:
            for k in ("wq", "wk", "wv", "wo"):
                fn(xv20, lw[k])
            fn(xd20, lw["w_down"])
        fn(xv20, table)

    time_kernel("cim_gemv", f"one verify step's calls, M={Mv}, {L} layers",
                cim_verify_step, cim_gemv, cim_gemv_plain,
                cim_bytes + 4 * (Mv - M) * (cim_in + cim_out),
                cim_flops * Mv // M, key="cim_gemv verify")
    # the plan of each call and its block's shared memory
    for k, w, mm in (("wq", layers[0]["wq"], M), ("wk", layers[0]["wk"], M),
                     ("w_down", layers[0]["w_down"], M), ("table", table, M),
                     ("w_down", layers[0]["w_down"], Mv),
                     ("table", table, Mv)):
        lay = "table" if w.axis == -1 else "cols"
        kk = w.orig_shape[1] if w.axis == -1 else w.orig_shape[0]
        nn = w.data.shape[0] if w.axis == -1 else w.data.shape[1]
        stored = w.data.shape[1] if w.axis == -1 else w.data.shape[0]
        pl = split_plan(lay, mm, stored, nn, w.bits, sm_count(device))
        log(f"plan cim_gemv {k} M={mm}: M tile {pl.mt}, {pl.splits} splits "
            f"of {pl.rows} rows, {pl.blocks} blocks, "
            f"{smem_bytes(lay, pl, mm, kk, w.bits, w.group)} B shared memory")
    # one call is one kernel on the device
    for k, w, xin in (("wq", layers[0]["wq"], x),
                      ("w_down", layers[0]["w_down"], xd),
                      ("table", table, x)):
        n_k = kernels_per_call(lambda: cim_gemv(xin, w))
        log(f"cim_gemv {k} M={M}: {n_k} device kernel(s) per call (nodes "
            "of a CUDA graph of one call)")
        if n_k != 1:
            fail(f"cim_gemv {k}: {n_k} device kernels per call, expected 1")
    time_kernel("swiglu_qgemv", what, sw_step, swiglu_qgemv, swiglu_plain,
                sw_bytes, sw_flops)

    def sw_verify_step(fn):
        for lw in layers:
            fn(xv20, lw["w_gate"], lw["w_up"])

    time_kernel("swiglu_qgemv", f"one verify step's calls, M={Mv}, {L} "
                "layers", sw_verify_step, swiglu_qgemv, swiglu_plain,
                sw_bytes + L * 4 * (Mv - M) * (d + f), sw_flops * Mv // M,
                key="swiglu_qgemv verify")
    wg0 = layers[0]["w_gate"]
    for mm, xin in ((M, x), (Mv, xv20)):
        pl = sw.split_plan(mm, wg0.data.shape[0], f, wg0.bits, wg0.group,
                           sm_count(device))
        smem = sw.smem_bytes(pl, mm, wg0.bits, wg0.group)
        per_sm = sw.blocks_per_sm(smem)
        log(f"plan swiglu_qgemv M={mm}: M tile {pl.mt}, {pl.splits} splits "
            f"of {pl.rows} rows, {pl.blocks} blocks, {per_sm} per SM, "
            f"{pl.blocks / (per_sm * sm_count(device)):.2f} waves, {smem} B "
            "shared memory")
        n_k = kernels_per_call(lambda: swiglu_qgemv(xin, wg0,
                                                    layers[0]["w_up"]))
        log(f"swiglu_qgemv M={mm}: {n_k} device kernel(s) per call (nodes "
            "of a CUDA graph of one call)")
        if n_k != 1:
            fail(f"swiglu_qgemv M={mm}: {n_k} device kernels per call, "
                 "expected 1")
    n_split, chunk = decode_plan(b, g, max_pages, ps, sm_count(device))
    log(f"plan paged_flash_decode (timed) b={b} g={g} max_pages="
        f"{max_pages} ps={ps}: n_split {n_split}, chunk {chunk} keys, "
        f"{b * g * n_split} blocks")
    time_kernel("paged_flash_decode", what + ", lengths 1024/777/301/45",
                pd_step, paged_flash_decode, paged_decode_plain, pd_bytes,
                pd_flops)
    device_split("paged_flash_decode x36, batch 4",
                 lambda: pd_step(paged_flash_decode))
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

    # the single-user edge point: batch 1 at length 4096 (256 pages)
    mp1, n1 = 256, 4096
    kp, vp, ks, vs = pools("int8", layers=L, n_pages=mp1)
    q1 = torch.randn(1, g, qpk, hd, generator=gen, device=device)
    t1 = torch.randperm(mp1, generator=gen, device=device)[None].int()
    l1 = torch.tensor([n1], dtype=torch.int32, device=device)
    n_split, chunk = decode_plan(1, g, mp1, ps, sm_count(device))
    log(f"plan paged_flash_decode (timed) b=1 g={g} max_pages={mp1} "
        f"ps={ps}: n_split {n_split}, chunk {chunk} keys, "
        f"{g * n_split} blocks")

    def pd1_step(fn):
        for i in range(L):
            fn(q1, kp[i], vp[i], t1, l1, 0, 0.0, ks[i], vs[i])

    time_kernel("paged_flash_decode",
                f"{L} calls, batch 1, length {n1}, int8", pd1_step,
                paged_flash_decode, paged_decode_plain,
                L * (n1 * g * (2 * hd + 2 * 2) + 2 * q1.numel() * 4
                     + (mp1 + 1) * 4),
                L * n1 * g * qpk * hd * 4, key="paged_flash_decode b1")
    device_split("paged_flash_decode x36, batch 1, length 4096",
                 lambda: pd1_step(paged_flash_decode))
    del kp, vp, ks, vs

    # one verify step: s = 5 (k = 4) at lengths 1024/777/301/45 before the
    # window, over a table of 72 pages so every window row has its page
    sv, mpv = 5, 72
    kp, vp, ks, vs = pools("int8", layers=L, n_pages=b * mpv)
    tv = torch.randperm(b * mpv, generator=gen, device=device
                        ).reshape(b, mpv).int()
    qv = torch.randn(b, sv, g, qpk, hd, generator=gen, device=device)

    def pv_step(fn):
        for i in range(L):
            fn(qv, kp[i], vp[i], tv, lengths, 0, 0.0, ks[i], vs[i])

    def pv_cost(lens, q, n_tab):
        """(bytes, flops) of 36 verify calls: the K/V rows the windows
        see, q in and out, tables and lengths; q.k and p.v per visible
        key of each row."""
        rows = sum(lens) + len(lens) * sv
        keys = sum(sv * n + sv * (sv + 1) // 2 for n in lens)
        return (L * (rows * g * (2 * hd + 2 * 2) + 2 * q.numel() * 4
                     + len(lens) * (n_tab + 1) * 4),
                L * keys * g * qpk * hd * 4)

    def log_verify_plan(bb, n_tab, what):
        n_split, chunk = verify_plan(bb, g, sv, qpk, n_tab, ps,
                                     sm_count(device))
        warps, z = verify_geometry(sv * qpk)
        log(f"plan paged_flash_verify ({what}) b={bb} g={g} s={sv} "
            f"qpk={qpk} max_pages={n_tab} ps={ps}: n_split {n_split}, "
            f"chunk {chunk} keys, {bb * g * n_split * z} blocks of "
            f"{warps} warps, {verify_smem_bytes(1, hd, warps)} B shared "
            "memory (int8)")

    log_verify_plan(b, mpv, "timed")
    time_kernel("paged_flash_verify",
                f"one verify step's calls, batch {b}, s={sv}, {L} layers, "
                "lengths 1024/777/301/45", pv_step, paged_flash_verify,
                paged_verify_plain, *pv_cost(lengths.tolist(), qv, mpv))
    device_split("paged_flash_verify x36, batch 4, s=5",
                 lambda: pv_step(paged_flash_verify))
    n_k = kernels_per_call(lambda: paged_flash_verify(
        qv, kp[0], vp[0], tv, lengths, 0, 0.0, ks[0], vs[0]))
    log(f"paged_flash_verify batch {b} s={sv}: {n_k} device kernel(s) per "
        "call (nodes of a CUDA graph of one call)")
    if n_k > 2:
        fail(f"paged_flash_verify: {n_k} device kernels per call, expected "
             "a fold and a merge")
    del kp, vp, ks, vs

    # the single-user edge point: batch 1, s = 5, length 4096 before the
    # window, over a table of 260 pages
    mpv1, nv1 = 260, 4096
    kp, vp, ks, vs = pools("int8", layers=L, n_pages=mpv1)
    qv1 = torch.randn(1, sv, g, qpk, hd, generator=gen, device=device)
    tv1 = torch.randperm(mpv1, generator=gen, device=device)[None].int()
    lv1 = torch.tensor([nv1], dtype=torch.int32, device=device)
    args = (qv1, kp[0], vp[0], tv1, lv1, 0, 0.0, ks[0], vs[0])
    out = paged_flash_verify(*args)
    checks.compare("paged_flash_verify", f"int8 pools batch 1 s={sv} len "
                   f"{nv1}", out, paged_verify_plain(*args))
    checks.repeat("paged_flash_verify", f"int8 batch 1 len {nv1}", out,
                  paged_flash_verify(*args))
    log_verify_plan(1, mpv1, "timed")

    def pv1_step(fn):
        for i in range(L):
            fn(qv1, kp[i], vp[i], tv1, lv1, 0, 0.0, ks[i], vs[i])

    time_kernel("paged_flash_verify",
                f"{L} calls, batch 1, s={sv}, length {nv1}, int8", pv1_step,
                paged_flash_verify, paged_verify_plain,
                *pv_cost([nv1], qv1, mpv1), key="paged_flash_verify b1")
    device_split("paged_flash_verify x36, batch 1, s=5, length 4096",
                 lambda: pv1_step(paged_flash_verify))
    del kp, vp, ks, vs

    # flash_decode: 36 calls at b*g = 8, S = 1024, pos = 1023, each layer
    # on its own f32 cache (302 MB in all, past the 50 MB L2)
    S, pos = 1024, 1023
    kcs = [torch.randn(bg, S, hd, generator=gen, device=device)
           for _ in range(L)]
    vcs = [torch.randn(bg, S, hd, generator=gen, device=device)
           for _ in range(L)]

    def fd_step(fn):
        for i in range(L):
            fn(qf, kcs[i], vcs[i], pos)

    def sdpa(qx, kx, vx, p):
        return torch.nn.functional.scaled_dot_product_attention(
            qx, kx[:, :p + 1], vx[:, :p + 1])

    lib_err = float((flash_decode(qf, kcs[0], vcs[0], pos)
                     - sdpa(qf, kcs[0], vcs[0], pos)).abs().max())
    log(f"flash_decode vs scaled_dot_product_attention (the library call "
        f"timed below, not the plain version): max_abs_err {lib_err:.3e}")
    fd_bytes = L * (2 * bg * (pos + 1) * hd * 4 + 2 * qf.numel() * 4)
    fd_flops = L * bg * qpk * (pos + 1) * hd * 4
    n_split, chunk = flash_plan(bg, S, sm_count(device))
    log(f"plan flash_decode (timed) b*g={bg} S={S}: n_split {n_split}, "
        f"chunk {chunk} keys, {bg * n_split} blocks")
    time_kernel("flash_decode", f"{L} calls, b*g={bg}, S={S}, pos={pos}, "
                "f32 cache", fd_step, flash_decode, flash_decode_plain,
                fd_bytes, fd_flops, library=sdpa)
    device_split(f"flash_decode x36, b*g={bg}, S={S}",
                 lambda: fd_step(flash_decode))
    del kcs, vcs

    # batch 1 (b*g = 2) at S = 4096, pos = 4095
    S, pos, bg1 = 4096, 4095, 2
    q1 = qf[:bg1].contiguous()
    kcs = [torch.randn(bg1, S, hd, generator=gen, device=device)
           for _ in range(L)]
    vcs = [torch.randn(bg1, S, hd, generator=gen, device=device)
           for _ in range(L)]
    n_split, chunk = flash_plan(bg1, S, sm_count(device))
    log(f"plan flash_decode (timed) b*g={bg1} S={S}: n_split {n_split}, "
        f"chunk {chunk} keys, {bg1 * n_split} blocks")

    def fd1_step(fn):
        for i in range(L):
            fn(q1, kcs[i], vcs[i], pos)

    time_kernel("flash_decode", f"{L} calls, b*g={bg1}, S={S}, pos={pos}, "
                "f32 cache", fd1_step, flash_decode, flash_decode_plain,
                L * (2 * bg1 * (pos + 1) * hd * 4 + 2 * q1.numel() * 4),
                L * bg1 * qpk * (pos + 1) * hd * 4, library=sdpa,
                key="flash_decode b1")
    device_split(f"flash_decode x36, b*g={bg1}, S={S}",
                 lambda: fd1_step(flash_decode))
    del kcs, vcs
    torch.cuda.empty_cache()
    return timings


def step_launches(cfg, s: int, verify: bool = False, packed: bool = True):
    """Kernel launches of one model step call of width s (its graph
    holds the same): packed weights go to cim_gemv / swiglu_qgemv, a
    decode step's attention to paged_flash_decode, a verify window's to
    paged_flash_verify."""
    L = cfg.n_layers
    return {"cim_gemv": (5 * L + 1) if packed else 0,
            "swiglu_qgemv": L if packed else 0,
            "paged_flash_decode": L if s == 1 else 0,
            "paged_flash_verify": L if verify else 0, "flash_decode": 0}


def check_graphs(label, eng, allowed, required):
    """Every step call of `eng` went through a CUDA graph captured once
    per (step, shape): `allowed` maps (step, shape) to the kernels one
    call launches, which its graph must hold; each of `required` was
    replayed.  Logs capture seconds and replays."""
    steps = eng.runner.steps()
    got = {(st["fn"], tuple(st["shape"])): st for st in steps}
    if not eng.runner.graphs or not all(st["captured"] for st in steps):
        fail(f"{label}: steps not captured as CUDA graphs: {steps}")
    if not set(required) <= set(got) <= set(allowed):
        fail(f"{label}: graphs {sorted(got)}, expected {sorted(required)} "
             f"and at most {sorted(allowed)}")
    for key, st in got.items():
        if st["launches_per_call"] != allowed[key]:
            fail(f"{label}: graph {key} holds {st['launches_per_call']} "
                 f"kernel launches a call, expected {allowed[key]}")
        if key in required and st["replays"] <= 0:
            fail(f"{label}: graph {key} was never replayed")
    log(f"{label} graphs, each captured once: " + "; ".join(
        f"{fn} {list(shape)} capture {st['capture_s']:.3f} s, "
        f"{st['replays']} replays, kernels a call "
        + json.dumps({k: v for k, v in st["launches_per_call"].items()
                      if v})
        for (fn, shape), st in got.items()))
    return {f"{fn} {list(shape)}": {"capture_s": st["capture_s"],
                                    "replays": st["replays"]}
            for (fn, shape), st in got.items()}


def replay_check(label, eng, fn, shape, iters: int = 20) -> float:
    """Device ms of one replay of the engine's graph of (fn, shape)
    (CUDA events), and two replays on its static inputs bitwise equal
    in logits and pools.  Direct replays: no launch is counted."""
    import torch
    graph, logits = eng.runner.graph_of(fn, shape)
    ms = cuda_time_ms(graph.replay, iters)
    snaps = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        snaps.append((logits.clone(), [v.clone() for v in
                                       eng.cache.pools["attn"].values()]))
    same = torch.equal(snaps[0][0], snaps[1][0]) and all(
        torch.equal(a, b) for a, b in zip(snaps[0][1], snaps[1][1]))
    log(f"check {label} graph {list(shape)}: two replays on the same "
        f"inputs bitwise {'equal' if same else 'DIFFERENT'} (logits and "
        f"pools); replay device {ms:.3f} ms")
    if not same:
        fail(f"{label}: two replays of one graph differ")
    return ms


def run_wave(eng, wave, n_new, first_rid):
    """Submit one wave of requests and step the engine until it drains,
    on a fresh Telemetry and energy meter.  Returns (requests, wall ms of
    each step that made no prefill call, the wave's summary)."""
    import torch
    from repro_torch.serve import ServeRequest
    from repro_torch.serve.telemetry import Telemetry

    eng.telemetry = Telemetry()
    eng.energy.reset()
    batch = [ServeRequest(prompt=p, max_new_tokens=n_new, rid=first_rid + i)
             for i, p in enumerate(wave)]
    for r in batch:
        eng.submit(r)
    decode_ms = []
    while eng.busy:
        pre = eng.prefill_calls
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if eng.prefill_calls == pre:
            decode_ms.append((time.perf_counter() - t0) * 1e3)
    m = eng.summary()
    if m["sim_decode_tokens"] != eng.telemetry.decode_tokens:
        fail(f"energy meter charged {m['sim_decode_tokens']} decode tokens, "
             f"the engine served {eng.telemetry.decode_tokens}")
    return batch, decode_ms, m


def phase_full_model(model, params, device, card):
    """Serve the same two waves of requests with the steps as CUDA
    graphs (the default) and eagerly (eager=True), in that order; the
    graph engine then serves a third wave with the tracer on."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import chrome_trace, get_tracer
    from repro_torch.serve import PagedServeEngine, ServeConfig

    cfg = model.cfg
    rng = np.random.default_rng(0)
    waves = [[rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
              for n in rng.integers(16, 65, size=4)] for _ in range(3)]
    n_new = 16

    def serve(eager):
        eng = PagedServeEngine(model, params, ServeConfig(
            precision="int4", kv_dtype="auto", max_batch=4, max_seq=128,
            page_size=16, prefill_chunk=16), device=device, eager=eager)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reqs, decode_ms, ttft, wave_ms, sims = [], [], [], [], []
        reset_launch_counts()
        t_run = time.perf_counter()
        # wave 1 captures the graphs; wave 2 (new prompts, no prefix
        # hit) runs on captured graphs
        for wave in waves[:2]:
            batch, ms, m = run_wave(eng, wave, n_new, len(reqs))
            reqs += batch
            decode_ms += ms
            wave_ms.append(ms)
            sims.append(m)
            ttft.append(m["ttft_p50_s"] * 1e3)
        run_s = time.perf_counter() - t_run
        counts = launch_counts()
        mode = "eager" if eager else "graph"
        gen_tokens = sum(len(r.out_tokens) for r in reqs)
        log(f"full model ({mode}): {cfg.name} {cfg.n_layers} layers "
            f"d={cfg.d_model} vocab={cfg.vocab}, prompts "
            f"{[len(r.prompt) for r in reqs]}, {gen_tokens} tokens "
            f"generated in {run_s:.2f} s")
        if gen_tokens != len(reqs) * n_new or not all(r.done for r in reqs):
            fail(f"generated {gen_tokens} tokens, expected "
                 f"{len(reqs) * n_new}")
        for r in reqs:
            if not all(0 <= t < cfg.vocab for t in r.out_tokens):
                fail(f"token out of range in request {r.rid}")
        calls = eng.prefill_calls + eng.decode_calls
        expect = {"cim_gemv": (5 * cfg.n_layers + 1) * calls,
                  "swiglu_qgemv": cfg.n_layers * calls,
                  "paged_flash_decode": cfg.n_layers * eng.decode_calls,
                  "paged_flash_verify": 0, "flash_decode": 0}
        log(f"serve_step calls ({mode}): {eng.prefill_calls} prefill + "
            f"{eng.decode_calls} decode; launches {counts}, expected "
            f"{expect}")
        if counts != expect or min(counts["cim_gemv"],
                                   counts["swiglu_qgemv"],
                                   counts["paged_flash_decode"]) <= 0:
            fail(f"kernel launches {counts} != expected {expect}")
        return dict(eng=eng, reqs=reqs, counts=counts, run_s=run_s,
                    decode_ms=float(np.median(decode_ms)),
                    decode_steps=len(decode_ms), ttft_ms=ttft,
                    wave_ms=wave_ms, sims=sims,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    graph, eager = serve(False), serve(True)
    eng = graph["eng"]

    # the EdgeCIM cost model's reading of wave 2, beside what the card did
    sim = graph["sims"][1]
    log(f"EdgeCIM cost model (simulated for the paper's CIM accelerator, "
        f"not a measurement of this card), wave 2: sim_tokens_per_j "
        f"{sim['sim_tokens_per_j']!r}, sim_tokens_per_s "
        f"{sim['sim_tokens_per_s']!r}, sim_energy_j {sim['sim_energy_j']!r}, "
        f"sim_w_bits {sim['sim_w_bits']!r}, sim_decode_tokens "
        f"{sim['sim_decode_tokens']!r}; measured on the card ({card}): "
        f"{sim['decode_tokens_per_s']!r} decode tokens/s")

    # wave 3, graphs, tracer on: spans and recorder events against the
    # engine's own call counts
    tracer = get_tracer()
    tracer.clear()
    tracer.enable()
    pre, dec = eng.prefill_calls, eng.decode_calls
    try:
        batch, traced_ms, _ = run_wave(eng, waves[2], n_new, 8)
    finally:
        tracer.disable()
    spans = {}
    for e in tracer.events():
        spans[e["name"]] = spans.get(e["name"], 0) + 1
    want = {"prefill_chunk": eng.prefill_calls - pre,
            "decode_step": eng.decode_calls - dec}
    got = {k: spans.get(k, 0) for k in want}
    events = eng.recorder.snapshot()
    per_req = {r.eid: [e["kind"] for e in events if e.get("eid") == r.eid]
               for r in batch}
    log(f"tracer on (wave 3): events {json.dumps(spans)}; spans {got}, "
        f"engine calls {want}; recorder {eng.recorder.pushes} pushes, "
        f"{eng.recorder.dropped} dropped; per request "
        f"{sorted(set(map(tuple, per_req.values())))}")
    if got != want:
        fail(f"tracer spans {got} != engine calls {want}")
    for eid, kinds in per_req.items():
        if [kinds.count(k) for k in ("submit", "admit", "finish")] != [1] * 3:
            fail(f"flight recorder, request {eid}: events {kinds}")
    trace_path = Path(__file__).resolve().parent / "build" / "chip_smoke"
    trace_path.mkdir(parents=True, exist_ok=True)
    trace_path = trace_path / "trace_wave3.json"
    doc = chrome_trace(tracer)
    trace_path.write_text(json.dumps(doc))
    tracer.clear()
    log(f"Chrome trace of wave 3: {len(doc['traceEvents'])} events -> "
        f"{trace_path}")
    # the tracer's cost: wave 3's prompts four more times (prefix hits
    # in all four), tracer off, on, off, on
    by_mode = {False: [], True: []}
    for k, on in enumerate((False, True, False, True)):
        if on:
            tracer.enable()
        try:
            by_mode[on] += run_wave(eng, waves[2], n_new, 12 + 4 * k)[1]
        finally:
            tracer.disable()
            tracer.clear()
    w2_ms = float(np.median(graph["wave_ms"][1]))
    off_ms = float(np.median(by_mode[False]))
    on_ms = float(np.median(by_mode[True]))
    log(f"decode step wall median, graphs, recorder on: wave 2 (tracer off) "
        f"{w2_ms:.3f} ms over {len(graph['wave_ms'][1])} steps; waves 4-7 "
        f"(wave 3's prompts, in turns) tracer off {off_ms:.3f} ms over "
        f"{len(by_mode[False])} steps, tracer on {on_ms:.3f} ms over "
        f"{len(by_mode[True])} steps")
    name = f"{cfg.name}.serve_step"
    graphs = check_graphs("full model", eng, {
        (name, (4, 16)): step_launches(cfg, 16),
        (name, (4, 1)): step_launches(cfg, 1)},
        [(name, (4, 16)), (name, (4, 1))])
    check_identity("graphs vs eager (full model)", eager["reqs"],
                   graph["reqs"], model, params, device)
    replay_ms = replay_check("full model decode", eng, model.serve_step,
                             (4, 1))
    result = {
        "tokens": sum(len(r.out_tokens) for r in graph["reqs"]),
        "decode_tok_s": graph["sims"][1]["decode_tokens_per_s"],
        "decode_steps": graph["decode_steps"],
        "launches_per_decode_step": sum(step_launches(cfg, 1).values()),
        "launches": graph["counts"],
        "graphs": graphs,
        "decode_replay_device_ms": replay_ms,
        "decode_step_ms_median_wave2": w2_ms,
        "decode_step_ms_median_tracer_off": off_ms,
        "decode_step_ms_median_tracer_on": on_ms,
        "sim_wave2": {k: v for k, v in sim.items()
                      if k.startswith("sim_")},
    }
    for mode, run in (("graph", graph), ("eager", eager)):
        result[mode] = {
            "decode_step_ms_median": run["decode_ms"],
            "host_ms_per_decode_step": run["decode_ms"] - replay_ms,
            "device_busy_share": replay_ms / run["decode_ms"],
            "ttft_p50_ms_wave1": run["ttft_ms"][0],
            "ttft_p50_ms_wave2": run["ttft_ms"][1],
            "max_memory_allocated_gb": run["peak_gb"],
            "run_s": run["run_s"]}
    log("full model result " + json.dumps(result))
    names = profile_step(model, params, eng, device)
    # cim_gemv's kernels live in an anonymous namespace; PyTorch's own
    # reductions (at::native::reduce_kernel) are the model's glue
    ours = [n for n in names if n.startswith("void (anonymous namespace)::")]
    stale = [n for n in ours
             if "reduce_kernel" in n or "epilogue_kernel" in n]
    log("decode step profile: kernels of the port "
        + ", ".join(sorted({re.sub(r"^void \(anonymous namespace\)::|\(.*",
                                   "", n) for n in ours}))
        + f"; a second cim_gemv or swiglu_qgemv pass (reduce_kernel, "
        f"epilogue_kernel) {'present' if stale else 'absent'}")
    if not ours or stale:
        fail(f"decode step profile: no kernel of the port seen, or a "
             f"second cim_gemv or swiglu_qgemv pass ran: {stale}")
    return graph["counts"], result


def profile_step(model, params, eng, device, s: int = 1, steps: int = 3):
    """torch.profiler over a few batch-4 model steps on the engine's
    pools (lanes at length 64): decode `serve_step` calls for s = 1,
    `paged_verify_step` windows of s tokens otherwise; first eagerly,
    then as replays of a CUDA graph (a `StepRunner` of its own, captured
    before the profile).  Host wall time per step against the device
    time of the kernels it ran.  Returns {kernel name: device us} of
    both."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import StepRunner

    b, mp = eng.max_batch, eng.cache.max_pages
    host = (np.zeros((b, s), np.int32),
            np.arange(b * mp, dtype=np.int32).reshape(b, mp),
            np.full(b, 64, np.int32), np.full(b, s, np.int32))
    tok, tables, lengths, n_new = (torch.from_numpy(a).to(device)
                                   for a in host)
    fn = model.serve_step if s == 1 else model.paged_verify_step
    what = "decode step" if s == 1 else f"verify step (s={s})"
    runner = StepRunner(device)

    def eager():
        fn(params, eng.cache.pools, {"tokens": tok}, tables, lengths, n_new)

    def replay():
        runner(fn, params, eng.cache.pools, *host)
    names = {}
    for mode, step in (("eager", eager), ("graph replay", replay)):
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        by_name, n_dev = device_times(prof)
        for k, v in by_name.items():
            names[k] = names.get(k, 0.0) + v
        dev_ms = sum(by_name.values()) / 1e3 / steps
        if n_dev == 0:
            log(f"{what} profile ({mode}): wall {wall_ms:.3f} ms/step; "
                "device time not measured (the profiler recorded no CUDA "
                "events)")
            continue
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"{what} profile ({mode}): wall {wall_ms:.3f} ms/step, device "
            f"{dev_ms:.3f} ms/step busy ({100 * dev_ms / wall_ms:.1f} %), "
            f"{n_dev / steps:.0f} device events/step; top: " + "; ".join(
                f"{n[:60]} {d / 1e3 / steps:.3f} ms" for n, d in top))
    return names


def device_times(prof):
    """({kernel name: device us summed}, device events) of a profile."""
    from torch.autograd import DeviceType
    by_name, n = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
            n += 1
    return by_name, n


def kernels_per_call(call) -> int:
    """Device kernels one call of `call` enqueues, after a warm-up call:
    the nodes of a CUDA graph captured around it, which must all be
    kernels (a memset or a copy fails the run).  Counted in the graph,
    not with torch.profiler: in a long process the profiler can drop a
    short profile's kernel events."""
    import torch
    from repro_torch.kernels import _build
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        call()
    dot = _build.BUILD_DIR / "call.dot"
    graph.debug_dump(str(dot))
    nodes = re.findall(r'"graph_\d+_node_\d+"\[[^\]]*?label="\{(\w+)',
                       dot.read_text())
    dot.unlink()
    if set(nodes) - {"KERNEL"}:
        fail(f"one call enqueues device operations other than kernels: "
             f"{nodes}")
    return len(nodes)


def device_split(label, step, steps: int = 3) -> None:
    """Device time per call of `step` by kernel name (torch.profiler),
    logged: how a step's time divides between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_name, n = device_times(prof)
    if not by_name:
        log(f"device split {label}: not measured (no CUDA events)")
        return
    parts = sorted(by_name.items(), key=lambda kv: -kv[1])
    names = [re.sub(r"^void |\(anonymous namespace\)::|\(.*", "", k)[:60]
             for k, _ in parts]
    log(f"device split {label}: {n / steps:.0f} kernels per step; "
        + "; ".join(f"{nm} {v / 1e3 / steps:.4f} ms"
                    for nm, (_, v) in zip(names, parts)))


def top2_gap(model, params, device, tokens):
    """(gap between the two largest logits after `tokens`, the logit
    tolerance): one prefill chunk through `serve_step` on a fresh pool."""
    import torch
    n, ps = len(tokens), 16
    pages = -(-n // ps)
    cache = {"attn": {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                      for k, v in model.paged_cache_specs(
                          pages, ps, torch.int8)["attn"].items()}}
    logits, _ = model.serve_step(
        params, cache, {"tokens": torch.tensor(tokens[None], device=device)},
        torch.arange(pages, dtype=torch.int32, device=device)[None],
        torch.zeros(1, dtype=torch.int32, device=device),
        torch.tensor([n], dtype=torch.int32, device=device))
    row = logits[0, n - 1].float()
    top = row.topk(2).values
    return (float(top[0] - top[1]),
            LOGIT_TOL * max(1.0, float(row.abs().max())))


def check_identity(label, base, spec, model, params, device) -> int:
    """Greedy streams of two runs (with and without speculation, or
    eager and as CUDA graphs) must be equal.  The one exception: a first
    divergence at a step whose top-two target logits lie within the
    logit tolerance (the two paths sum in another order), which is
    logged.  Returns the number of such requests."""
    import numpy as np
    near_ties = 0
    for rb, rs in zip(base, spec):
        a, b = rb.out_tokens, rs.out_tokens
        if len(b) > len(a) or a[:len(b)] != b:
            if len(b) > len(a):
                fail(f"{label}: request {rs.rid} emitted {len(b)} tokens, "
                     f"more than the {len(a)} compared")
            t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            gap, tol = top2_gap(model, params, device, np.concatenate(
                [rb.prompt, np.asarray(a[:t], np.int32)]))
            log(f"{label}: request {rs.rid} diverges at token {t} "
                f"({a[t]} vs {b[t]}); target top-2 gap {gap:.3e}, logit "
                f"tol {tol:.3e}")
            if gap > tol:
                fail(f"{label}: request {rs.rid} diverges at token {t} with "
                     f"a top-2 gap {gap:.3e} above the tolerance {tol:.3e}")
            near_ties += 1
    log(f"{label}: streams identical for {len(spec) - near_ties} of "
        f"{len(spec)} requests; {near_ties} diverge at a near-tie")
    return near_ties


def spec_split(eng, events, step_ms):
    """The spec phase's spans of a traced run: in each verify-only step
    (the steps of the wall median `step_ms`), the drafting ms and the
    call with its acceptance walk.  The spans' sums of drafted and
    accepted tokens over the whole run must equal the engine's
    telemetry (and the recorder's, when it dropped nothing)."""
    import numpy as np
    draft, verify, n_verify = [], [], 0
    ver = [e for e in events if e["name"] == "spec_verify"]
    for e in ver:
        n_verify += e["args"]["drafted"] > 0
    for lo, hi in eng.verify_windows:
        inside = {e["name"]: e["dur_s"] * 1e3 for e in events
                  if lo <= e["t_s"] <= hi
                  and e["name"] in ("spec_draft", "spec_verify")}
        if "spec_verify" not in inside:
            fail(f"no spec_verify span inside a verify step: {inside}")
        draft.append(inside.get("spec_draft", 0.0))
        verify.append(inside["spec_verify"])
    sums = {k: sum(e["args"][k] for e in ver)
            for k in ("drafted", "accepted")}
    tel = {"drafted": eng.telemetry.spec_drafted,
           "accepted": eng.telemetry.spec_accepted}
    rec = [e for e in eng.recorder.snapshot() if e["kind"] == "spec_verify"]
    rec_sums = ({k: sum(e[k] for e in rec) for k in tel}
                if eng.recorder.dropped == 0 else tel)
    if sums != tel or rec_sums != tel or n_verify != eng.verify_calls:
        fail(f"spec_verify spans {sums} ({n_verify} verify calls), "
             f"recorder {rec_sums}, telemetry {tel} "
             f"({eng.verify_calls} verify calls)")
    out = {"spec_draft_ms_median": float(np.median(draft)),
           "spec_verify_ms_median": float(np.median(verify)),
           "verify_step_ms_median": step_ms, "verify_steps": len(verify),
           "spans_drafted_accepted": sums}
    log(f"spec ngram k=4, {len(verify)} verify-only steps: spec_draft "
        "(drafting) median "
        f"{out['spec_draft_ms_median']:.3f} ms, spec_verify (the call, the "
        f"logits to the host, the acceptance walk) median "
        f"{out['spec_verify_ms_median']:.3f} ms, of a {step_ms:.3f} ms step "
        f"wall median; spans' drafted/accepted {sums} = telemetry's")
    return out


def phase_spec(model, params, device):
    """Speculative decoding at full width: n-gram drafter, k = 4, then a
    short run with the launcher's 1-layer draft model; each with the
    steps as CUDA graphs and once more eagerly, on the same prompts."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import build_draft
    from repro_torch.obs import get_tracer
    from repro_torch.serve import PagedServeEngine, ServeConfig, ServeRequest
    from repro_torch.spec import SpecConfig

    cfg = model.cfg
    L = cfg.n_layers
    rng = np.random.default_rng(1)
    motif = rng.integers(0, cfg.vocab, 8).astype(np.int32)
    prompts = [np.tile(motif, 8)[:int(n)]
               for n in rng.integers(32, 65, size=4)]
    serve_cfg = ServeConfig(precision="int4", kv_dtype="auto", max_batch=4,
                            max_seq=128, page_size=16, prefill_chunk=16)

    def serve(spec, n_new, eager=False, traced=False):
        eng = PagedServeEngine(model, params, serve_cfg, spec=spec,
                               device=device, eager=eager)
        reqs = [ServeRequest(prompt=p.copy(), max_new_tokens=n_new, rid=i)
                for i, p in enumerate(prompts)]
        tracer = get_tracer()
        tracer.clear()
        if traced:
            tracer.enable()
        for r in reqs:
            eng.submit(r)
        steps = []                    # (ms, tokens) of verify-only steps
        eng.verify_windows = []       # their spans on the tracer's clock
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t_run = time.perf_counter()
        while eng.busy:
            pre, ver = eng.prefill_calls, eng.verify_calls
            dec = eng.decode_calls
            made = sum(len(r.out_tokens) for r in reqs)
            t_mono = time.monotonic()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if eng.prefill_calls == pre and (eng.verify_calls > ver
                                             or eng.decode_calls > dec):
                steps.append(((time.perf_counter() - t0) * 1e3,
                              sum(len(r.out_tokens) for r in reqs) - made,
                              eng.verify_calls > ver))
                if eng.verify_calls > ver:
                    eng.verify_windows.append((t_mono, time.monotonic()))
        run_s = time.perf_counter() - t_run
        counts = launch_counts()
        tracer.disable()
        n = sum(len(r.out_tokens) for r in reqs)
        if n != 4 * n_new or not all(r.done for r in reqs):
            fail(f"spec={spec is not None}: generated {n} tokens, expected "
                 f"{4 * n_new}")
        if not all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens):
            fail("token out of range")
        eng.peak_gb = torch.cuda.max_memory_allocated() / 1e9
        return eng, reqs, counts, steps, run_s

    def report(label, eng, counts, steps, run_s, draft_decode_calls=0):
        calls = eng.prefill_calls + eng.decode_calls + eng.verify_calls
        expect = {"cim_gemv": (5 * L + 1) * calls,
                  "swiglu_qgemv": L * calls,
                  "paged_flash_decode": (L * eng.decode_calls
                                         + draft_decode_calls),
                  "paged_flash_verify": L * eng.verify_calls,
                  "flash_decode": 0}
        draft_txt = (f" + {draft_decode_calls} draft-layer decode"
                     if draft_decode_calls else "")
        log(f"{label}: model calls {eng.prefill_calls} prefill + "
            f"{eng.decode_calls} decode + {eng.verify_calls} verify"
            f"{draft_txt}; launches {counts}, expected {expect}")
        if counts != expect:
            fail(f"{label}: kernel launches {counts} != expected {expect}")
        m = eng.summary()
        ver = [(ms, n) for ms, n, v in steps if v]
        result = {
            "verify_calls": eng.verify_calls,
            "decode_calls": eng.decode_calls,
            "acceptance_rate": m.get("spec_acceptance_rate"),
            "spec_drafted": m.get("spec_drafted"),
            "spec_accepted": m.get("spec_accepted"),
            "tokens_per_verify_step": (sum(n for _, n in ver) / len(ver)
                                       if ver else None),
            "tokens_per_lane_per_decode_step":
                m["tokens_per_decode_step"],
            "verify_step_ms_median": (float(np.median([ms for ms, _ in ver]))
                                      if ver else None),
            "decode_step_ms_median": float(np.median(
                [ms for ms, _, _ in steps])),
            "decode_tok_s": eng.throughput(),
            "ttft_p50_ms": m["ttft_p50_s"] * 1e3,
            "max_memory_allocated_gb": eng.peak_gb,
            "run_s": run_s,
        }
        log(f"{label} result " + json.dumps(result))
        return result

    def graphs_vs_eager(label, graph, eager, replay_ms):
        """Graph and eager runs of one workload side by side: verify step
        wall medians, host ms (wall - the replay's device ms), device
        busy share, TTFT p50, peak memory."""
        out = {"verify_replay_device_ms": replay_ms}
        for mode, r in (("graph", graph), ("eager", eager)):
            out[mode] = {
                "verify_step_ms_median": r["verify_step_ms_median"],
                "host_ms_per_verify_step":
                    r["verify_step_ms_median"] - replay_ms,
                "device_busy_share": replay_ms / r["verify_step_ms_median"],
                "ttft_p50_ms": r["ttft_p50_ms"],
                "max_memory_allocated_gb": r["max_memory_allocated_gb"]}
        log(f"{label} graphs vs eager " + json.dumps(out))
        return out

    target = f"{cfg.name}.serve_step"
    verify = (f"{cfg.name}.paged_verify_step", (4, 5))
    allowed = {(target, (4, 16)): step_launches(cfg, 16),
               (target, (4, 1)): step_launches(cfg, 1),
               verify: step_launches(cfg, 5, verify=True)}

    base_eng, base, base_counts, base_steps, base_s = serve(None, 32)
    log("spec baseline (no speculation, same prompts) decode step median "
        f"{float(np.median([ms for ms, _, _ in base_steps])):.2f} ms, "
        f"{base_eng.throughput():.1f} decode tok/s")
    eng, reqs, counts, steps, run_s = serve(SpecConfig(k=4), 32)
    if eng.verify_calls <= 0:
        fail("speculative run made no verify call")
    ngram = report("spec ngram k=4", eng, counts, steps, run_s)
    ngram["graphs"] = check_graphs("spec ngram k=4", eng, allowed,
                                   [(target, (4, 16)), verify])
    ngram["near_ties"] = check_identity("spec ngram", base, reqs, model,
                                        params, device)
    ngram_counts = counts
    replay_ms = replay_check("spec ngram verify", eng,
                             model.paged_verify_step, (4, 5))
    e_eng, e_reqs, e_counts, e_steps, e_run_s = serve(SpecConfig(k=4), 32,
                                                      eager=True)
    ngram_eager = report("spec ngram k=4 (eager)", e_eng, e_counts, e_steps,
                         e_run_s)
    check_identity("graphs vs eager (spec ngram)", e_reqs, reqs, model,
                   params, device)
    ngram["graphs_vs_eager"] = graphs_vs_eager("spec ngram k=4", ngram,
                                               ngram_eager, replay_ms)
    # the host split from a run of its own, so the statistics above stay
    # untraced
    t_eng, t_reqs, t_counts, t_steps, t_run_s = serve(SpecConfig(k=4), 32,
                                                      traced=True)
    traced = report("spec ngram k=4 (traced)", t_eng, t_counts, t_steps,
                    t_run_s)
    ngram["host_split"] = spec_split(t_eng, get_tracer().events(),
                                     traced["verify_step_ms_median"])
    get_tracer().clear()
    check_identity("traced vs untraced (spec ngram)", reqs, t_reqs, model,
                   params, device)
    profile_step(model, params, eng, device, s=5)
    log("acceptance on random weights says nothing about a drafter; "
        "recorded, not claimed")
    del base_eng, eng, e_eng, t_eng

    draft, dparams = build_draft(cfg, device)
    dname = f"{draft.cfg.name}.serve_step"
    dl = draft.cfg.n_layers
    allowed.update({
        (dname, (4, 16)): step_launches(draft.cfg, 16, packed=False),
        (dname, (4, 1)): step_launches(draft.cfg, 1, packed=False)})
    spec = SpecConfig(k=4, drafter="model", draft_model=draft,
                      draft_params=dparams, draft_page_size=16)
    runs = {}
    for eager in (False, True):
        eng, reqs, counts, steps, run_s = serve(spec, 12, eager=eager)
        if eng.verify_calls <= 0:
            fail("draft-model run made no verify call")
        label = "spec model k=4" + (" (eager)" if eager else "")
        runs[eager] = (reqs, report(label, eng, counts, steps, run_s,
                                    dl * eng.spec.drafter.decode_calls))
        if not eager:
            check_graphs(label, eng, allowed,
                         [(target, (4, 16)), verify, (dname, (4, 1))])
        del eng
    check_identity("graphs vs eager (spec model)", runs[True][0],
                   runs[False][0], model, params, device)
    for r in base:
        r.out_tokens = r.out_tokens[:12]
    check_identity("spec model", base, runs[False][0], model, params,
                   device)
    del draft, dparams, runs
    torch.cuda.empty_cache()
    return ngram_counts, ngram


def phase_decode_attention(cfg, device, checks: Checks):
    """`ops.decode_attention` over a contiguous cache, 36 calls at
    qwen2.5-3b's attention shape (batch 4): every call goes through
    `flash_decode`."""
    import torch
    from repro_torch.kernels import (decode_attention, launch_counts,
                                     reset_launch_counts)
    b, g, qpk, hd, S, L = (4, cfg.n_kv_heads, cfg.q_per_kv(), cfg.hd(), 1024,
                           cfg.n_layers)
    gen = torch.Generator(device=device).manual_seed(5)
    q = torch.randn(b, g, qpk, hd, generator=gen, device=device)
    ks = [torch.randn(b, S, g, hd, generator=gen, device=device)
          for _ in range(L)]
    vs = [torch.randn(b, S, g, hd, generator=gen, device=device)
          for _ in range(L)]
    pos = torch.tensor(777, dtype=torch.int32, device=device)
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [decode_attention(q, ks[i], vs[i], pos) for i in range(L)]
    torch.cuda.synchronize()
    counts = launch_counts()
    expect = {k: (L if k == "flash_decode" else 0) for k in counts}
    log(f"decode_attention x{L}: launches {counts}, expected {expect}")
    if counts != expect:
        fail(f"decode_attention launches {counts} != expected {expect}")
    for i in (0, L - 1):
        checks.compare("flash_decode",
                       f"ops.decode_attention layer {i} pos=777 vs "
                       "use_kernel=False", outs[i],
                       decode_attention(q, ks[i], vs[i], pos,
                                        use_kernel=False))
    del ks, vs
    torch.cuda.empty_cache()
    return counts


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
    tol = LOGIT_TOL * max(1.0, float(ref.abs().max()))
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
    from repro_torch.kernels.ops import KERNELS
    t0 = time.perf_counter()
    ptxas = start_ptxas()
    built = _build.build_all()
    log(f"built {built or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    log_ptxas(ptxas)
    from repro_torch.kernels.split_decode import smem_bytes
    log("split-KV block shared memory: " + ", ".join(
        f"{n} hd 128 {smem_bytes(e, 128)} B" for n, e in
        (("int8", 1), ("bf16", 2), ("f32", 4))))

    t0 = time.perf_counter()
    model, params = build_full_model(device)
    torch.cuda.synchronize()
    log(f"qwen2.5-3b INT4 weights drawn and packed on the card in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    checks = Checks()
    timings = phase_kernels(model, params, device, checks)
    by_path = {}
    by_path["decode"], full_result = phase_full_model(model, params, device,
                                                      card)
    by_path["spec_ngram"], spec_result = phase_spec(model, params, device)
    by_path["decode_attention"] = phase_decode_attention(model.cfg, device,
                                                         checks)
    del params
    torch.cuda.empty_cache()
    phase_card_vs_cpu(device)

    # each kernel's launches come from the path it serves
    main_path = {"cim_gemv": "decode", "swiglu_qgemv": "decode",
                 "paged_flash_decode": "decode",
                 "paged_flash_verify": "spec_ngram",
                 "flash_decode": "decode_attention"}
    kernels = []
    for name, fn in KERNELS.items():
        err, tol, label = checks.worst[name]
        t = timings[name]
        launches = by_path[main_path[name]][name]
        if launches <= 0:
            fail(f"{name} was not launched on its path "
                 f"({main_path[name]})")
        kernels.append({
            "name": name, "route": "cuda", "source": fn.SOURCE,
            "replaces": fn.REPLACES, "launches": launches,
            "path": main_path[name],
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": err, "max_err": err, "tol": tol,
            "worst_case": label,
            "ms": t["ms"], "eager_ms": t["eager_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "bound_share": t["bound_share"],
            "library_ms": t["library_ms"],
            "timed": t["timed"] + "; ms is CUDA-graph replay, eager_ms "
                     "host-dispatched",
            "also_timed": [v for k, v in timings.items()
                           if k.startswith(name + " ")]})
    log("full model summary " + json.dumps(full_result))
    log("spec summary " + json.dumps(spec_result))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
