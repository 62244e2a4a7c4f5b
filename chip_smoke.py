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
     Phase 2 also holds the kernels at the shapes of gemma3-4b,
     gemma2-27b and phi3-medium-14b, every call twice (bitwise equal):
     cim_gemv on each projection and both tables / phi3's untied head
     (groups of 80, 96, 112, 128) at M = 1, 4, 20, swiglu_qgemv on
     phi3's gate/up; the split-KV kernels (INT8 pools, verify at s = 5)
     at hd 256 / qpk 2 with window 1024 and lanes shorter than, at, 1
     and 300 keys past it, at hd 128 with window 4096 and softcap 50,
     and at phi3's qpk 4; then 34 decode calls at gemma3's shape with
     every lane at 4096 keys, with and without the window (the plan is
     blind to it).
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
  6. card vs CPU: 2-layer full-width copies, stepped in lockstep through
     serve_step on the card (kernels) and on the CPU (plain versions)
     from the same weights: qwen2.5-3b, gemma2-27b and phi3-medium-14b
     one prefill chunk and one decode step of two lanes; gemma3-4b (its
     local_pattern cut to 2, so one layer is local and one global, and
     its window to 128 keys, so the CPU's plain 262144-row table
     contraction stays short) one lane prefilled past its window in
     chunks of 128, then two decode steps.
  7. gemma3-4b at full width and depth (34 layers, INT4 weights from seed
     0 on the card, INT8 paged KV) served by PagedServeEngine as CUDA
     graphs and eagerly: a wave of 4 requests of 16-64 prompt tokens and
     one request of 1100-1200 prompt tokens (past the 1024-key window of
     its local layers), 16 new tokens each, streams compared, launches
     equal to per-call counts x calls (a decode step: 34 x 7 + 1
     cim_gemv, 34 paged_flash_decode); decode step wall median, replay
     device ms, TTFT, peak memory; a profiled decode step's device ms by
     kernel beside each bound.  Then n-gram speculation (k = 4) on motif
     prompts against the same prompts without it, as graphs and
     eagerly, with a profiled verify step split the same way.
  8. gemma2-27b and phi3-medium-14b at full width and 4 layers: one wave
     of 4 requests as CUDA graphs, launches and graphs checked.
  9. qwen3-moe-235b-a22b at full width and 4 layers (128 experts, top 8,
     64 / 4 heads; INT4, groups of 96 on we_down; INT8 KV): a wave of 4
     requests as CUDA graphs and eagerly, streams compared, launches
     equal to per-call counts x calls (a decode step: 4 x (4 + 3 expert
     stacks) + 1 cim_gemv, 4 paged_flash_decode), the eager run's experts
     kept per layer and slots dropped at capacity; n-gram speculation
     (k = 4) against none, streams compared; a profiled decode and verify
     step by kernel beside its bound (the stacks' bytes those of the
     experts the step's router kept).  Phase 2 holds, before it, the
     stack layout (128 experts, capacity 8, counts 0 / 1 / 8 / all full,
     NaN rows past a count, both shapes, INT4 and INT8), the split-KV
     kernels at 16 query heads per kv head and gemma2-27b's INT8 table
     and w_down (M = 4, 20, 64), and times 4 layers of the stack calls
     (decode and a 64-token chunk) and of the qpk-16 attention; phase 6
     holds a 2-layer full-width copy against the CPU.
 10. deepseek-v2-lite-16b at full width and 8 layers (layer 0 dense,
     then 7 MoE layers of 64 experts, top 6, two shared; MLA, kv_lora
     512; INT4, groups of 114 on layer 0's w_down and 88 on the experts'
     down; kv_dtype "auto", pinned to bf16 latent pools): a wave of 4
     requests as CUDA graphs and eagerly, streams compared, launches
     equal to per-call counts x calls (a decode step: 68 cim_gemv and 1
     swiglu_qgemv; MLA's attention is plain PyTorch, its w_uk / w_uv
     dequantized in the step, as the JAX package does), the eager run's
     experts kept per layer and slots dropped; n-gram speculation (k =
     4) against none, streams compared; a profiled decode and verify
     step by kernel beside its bound, with the MLA attention of all 8
     layers timed on its own beside its bound; peak memory while drawing
     and resident.  Phase 2 holds, before it, cim_gemv at every
     deepseek projection (w_dkv's 576 columns, groups of 114 and 88, the
     102400-wide head) at M = 1, 4, 20, 64, the 64-expert stacks (counts
     0 / 1 / 8 / all full), swiglu_qgemv at 2048 -> 10944 (a half-full
     last column tile), and times layer 0's two calls, the MLA
     projections and the stacks of a decode step; phase 6 holds a
     2-layer full-width copy (1 dense + 1 MoE layer) against the CPU.
 11. xlstm-1.3b at full width and depth (48 layers: 42 mLSTM, 6 sLSTM;
     d 2048; INT4, groups of 64 on the mLSTM's head-wise q/k/v and 105
     on the sLSTM's ffn_down), seed 7: a wave of 4 requests as CUDA
     graphs and eagerly, streams compared, launches equal to per-call
     counts x calls (a decode step: 42 x 6 + 6 x 2 + 1 = 265 cim_gemv,
     no attention kernel; the q/k/v in cim_gemv's stack layout), the
     arena's tensors never moved, two replays from one arena state
     bitwise equal; the wave again in a pool two pages over its prompts,
     whose preempted lanes snapshot their arena slot to the host and
     resume from it (each copy timed), streams equal to the unpreempted
     run; the spec, prefix-cache and fork refusals with the JAX engine's
     wording; decode step wall median, replay device ms, busy share,
     `state_bytes`; a profiled decode step by kernel beside each bound
     and the whole step's bound (weights, float leaves, the arena read
     and written); peak memory while drawing and resident.
 12. zamba2-7b at full width and 27 layers (4 groups of 6 Mamba2 layers,
     each followed by the shared attention + MLP block with its site's
     LoRA, then 3 Mamba2 layers; hd 112, 32 / 32 heads; INT4, groups of
     112; INT8 KV), seed 8: as phase 11, with a decode step of 27 x 2 +
     4 x 6 + 1 = 79 cim_gemv, 4 swiglu_qgemv and 4 paged_flash_decode,
     and preempted lanes re-prefilled (no snapshot).
     Phase 2 holds, before them, cim_gemv at every new projection shape
     (M = 1, 4, 64: groups of 105, 112, 64 in the head-wise stack; N up
     to 50304), swiglu_qgemv at 3584 -> 14336 and paged_flash_decode at
     hd 112 / qpk 1 / 32 kv heads (INT8, bf16, f32 pools; split
     boundaries, lengths 1 and 0, batch 1 x 4096), and times a zamba
     decode step's 4 attention and 4 swiglu calls and an xlstm decode
     step's 126 head-wise stack calls; phase 6 holds a 2-layer xlstm
     copy (slstm_every 2: one mLSTM, one sLSTM) and a 3-layer zamba copy
     (shared_every 2: one group and a tail layer) against the CPU, one
     prefill chunk and two decode steps.
 13. gateway and fleet: qwen2.5-3b at full width and depth (phase 1's
     weights) behind the port's `Gateway` over a `FleetRouter` of two
     replicas sharing the card and one copy of the packed weights (each
     its own KV pool, CUDA graphs, stream and driver thread; policy
     "prefix"), over loopback HTTP/SSE.  Waves of 16 requests (16-64
     prompt tokens, 16 new, greedy): a warm-up wave, a timed wave, the
     main wave (four with n = 2 through KV forks, one client hanging up
     after 4 tokens, then two repeated prompts that must route by prefix
     affinity), a profiled wave (the device's busy share), then the timed
     wave's shape on one replica, and a deterministic 429 with
     Retry-After (both drivers parked, one sample admitted each).  The
     waves' clients run in a process of their own.  Every
     completed stream must equal one engine serving the same prompts
     offline on the card, each fork its primary; every KV page of both
     replicas free (or reclaimable in the prefix trie) at the end; each
     replica's launches (its driver thread's counts) equal its steps
     times the per-step counts; every step captured once; no dead
     replica; /metrics lists both replicas with decode tokens, /healthz
     200.  Printed, not gated: TTFT p50/p95 through the gateway against
     offline, tokens/s with 1 and 2 replicas, the busy share, the
     gateway thread's CPU ms per token, the drift audit's ratio.
     Phase 2 holds, before it, cim_gemv at N = 1, 3, 6, 170 and 171
     (rows off 4-byte boundaries: byte copies; odd N: scale rows too),
     INT4 and INT8, both layouts, M = 1, 4, 20 with K split over several
     blocks, and serves the xlstm smoke config (its ffn_up has 170
     columns) on the card against the CPU.
 14. summary: a `{"kernels": [...]}` line, the card line, and last
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


def time_calls(timings, name, what, step, kernel_fn, plain, nbytes, flops,
               library=None, key=None):
    """`step(fn)` runs one step's calls of `fn`; kernel time is a
    CUDA-graph replay, eager and plain are dispatched one by one.
    Stored in `timings` under `key` (default: the kernel's name)."""
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
        time_calls(timings, name, what, step, kernel_fn, plain, nbytes,
                   flops, library, key)

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
    holds the same): packed weights go to cim_gemv / swiglu_qgemv (GQA's
    q/k/v/o, MLA's wq/w_dkv/wo, not its absorbed w_uk/w_uv; a gated SiLU
    FFN is one swiglu_qgemv call and w_down; any other FFN one cim_gemv
    call per projection; a MoE layer's routed experts three calls in the
    stack layout, its shared experts three more), a GQA decode step's
    attention to paged_flash_decode, a verify window's to
    paged_flash_verify (MLA's attention is plain PyTorch); xlstm and zamba
    as `recurrent_step_launches`."""
    if cfg.family in ("xlstm", "zamba"):
        return recurrent_step_launches(cfg, s, packed)
    L = cfg.n_layers
    m = cfg.moe
    mla = cfg.attn_kind == "mla"
    n_dense = m.first_dense_layers if m is not None else L
    fused = cfg.ffn_gated and cfg.ffn_act == "silu"
    dense_cim = 1 if fused else 3 if cfg.ffn_gated else 2
    moe_cim = 3 + (3 if m is not None and m.n_shared_experts else 0)
    cim = ((3 if mla else 4) * L + n_dense * dense_cim
           + (L - n_dense) * moe_cim + 1)
    return {"cim_gemv": cim if packed else 0,
            "swiglu_qgemv": n_dense if packed and fused else 0,
            "paged_flash_decode": L if s == 1 and not mla else 0,
            "paged_flash_verify": L if verify and not mla else 0,
            "flash_decode": 0}


def expected_launches(cfg, prefill: int, decode: int, verify: int = 0,
                      draft_decode: int = 0):
    """Launches of `prefill` chunk, `decode` step and `verify` window
    calls of the packed model (graph replays count their capture's), and
    `draft_decode` layer calls of a float draft model."""
    out = {}
    for k in step_launches(cfg, 1):
        out[k] = (step_launches(cfg, 16)[k] * prefill
                  + step_launches(cfg, 1)[k] * decode
                  + step_launches(cfg, 5, verify=True)[k] * verify)
    out["paged_flash_decode"] += draft_decode
    return out


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
    in logits and in every pool page a table can name: the dump page
    (the last) takes the step's padding rows, several on one row in no
    fixed order, and is never read.  A recurrent model's step advances
    its arena, so both replays start from the same arena state and must
    leave the same one.  Direct replays: no launch is counted."""
    import torch
    graph, logits = eng.runner.graph_of(fn, shape)
    ms = cuda_time_ms(graph.replay, iters)
    arena = ([leaf for _, leaf, _ in eng.arena._leaves()]
             if eng.arena is not None else [])
    start = [leaf.clone() for leaf in arena]
    snaps = []
    for _ in range(2):
        for leaf, x in zip(arena, start):
            leaf.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        snaps.append((logits.clone(), [v[:, :-1].clone()
                                       for pools in eng.cache.pools.values()
                                       for v in pools.values()]
                      + [leaf.clone() for leaf in arena]))
    same_logits = torch.equal(snaps[0][0], snaps[1][0])
    same_pools = all(torch.equal(a, b) for a, b in zip(snaps[0][1],
                                                       snaps[1][1]))
    log(f"check {label} graph {list(shape)}: two replays on the same "
        f"inputs bitwise: logits {'equal' if same_logits else 'DIFFERENT'},"
        f" pools (but the dump page){' and arena' if arena else ''} "
        f"{'equal' if same_pools else 'DIFFERENT'}"
        f"; replay device {ms:.3f} ms")
    if not (same_logits and same_pools):
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
        expect = expected_launches(cfg, eng.prefill_calls, eng.decode_calls)
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
    names, _ = profile_step(model, params, eng, device)
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
    pools and arena (lanes at length 64): decode `serve_step` calls for s = 1,
    `paged_verify_step` windows of s tokens otherwise; first eagerly,
    then as replays of a CUDA graph (a `StepRunner` of its own, captured
    before the profile).  Host wall time per step against the device
    time of the kernels it ran.  Returns ({kernel name: device us} of
    both, {mode: ({kernel name: device us per step}, wall ms per
    step)})."""
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
        fn(params, eng.state, {"tokens": tok}, tables, lengths, n_new)

    def replay():
        runner(fn, params, eng.state, *host)
    names, per_mode = {}, {}
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
        per_mode[mode] = ({k: v / steps for k, v in by_name.items()},
                          wall_ms)
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
    return names, per_mode


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


def fresh_state(model, b: int, n_pages: int, ps: int, device):
    """A step's decode state on `device`, zeroed: the paged pools (INT8,
    or MLA's bf16 latent pools) and, for a recurrent family, the arena's
    leaves for b lanes, in one dict as the engine hands them over."""
    import torch
    from repro_torch.models.common import map_specs
    kv = torch.bfloat16 if model.cfg.attn_kind == "mla" else torch.int8
    specs = model.decode_state_specs(b, n_pages, ps, kv)
    state = {}
    for half in ("paged", "arena"):
        state.update(map_specs(lambda s: torch.zeros(
            s.shape, dtype=s.dtype, device=device), specs[half]))
    return state


def top2_gap(model, params, device, tokens):
    """(gap between the two largest logits after `tokens`, the logit
    tolerance): one prefill chunk through `serve_step` on a fresh pool
    (and arena)."""
    import torch
    n, ps = len(tokens), 16
    pages = -(-n // ps)
    cache = fresh_state(model, 1, pages, ps, device)
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
        expect = expected_launches(cfg, eng.prefill_calls, eng.decode_calls,
                                   eng.verify_calls, draft_decode_calls)
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


# ---------------------------------------------------------------------------
# the sliding-window / softcap families (gemma3-4b, gemma2-27b) and phi3
# ---------------------------------------------------------------------------
FAMILIES = ("gemma3-4b", "gemma2-27b", "phi3-medium-14b")


def int8_pools(gen, device, b, max_pages, g, hd, ps=16):
    """One layer's INT8 K/V pools with f16 scale pages, and shuffled
    (b, max_pages) tables."""
    import torch
    n_pages = b * max_pages
    out = []
    for _ in range(2):
        xf = torch.randn(n_pages, ps, g, hd, generator=gen, device=device)
        sc = (xf.abs().amax(-1).clamp_min(1e-8) / 127).half()
        out += [torch.round(xf / sc[..., None].float()).clamp(-127, 127)
                .to(torch.int8), sc]
    tables = torch.randperm(n_pages, generator=gen, device=device
                            ).reshape(b, max_pages).int()
    return out[0], out[2], out[1], out[3], tables


def phase_family_kernels(device, checks: Checks):
    """Each kernel against its plain version at the shapes the gemma3-4b,
    gemma2-27b and phi3-medium-14b paths give it (INT4 weights packed as
    the model packs them, INT8 pools), every call twice (bitwise equal);
    the split-KV kernels at hd 256 with a window shorter than the lanes,
    and their time with and without the window."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.cim_gemv import (cim_gemv, cim_gemv_plain,
                                              split_plan, vec_bytes)
    from repro_torch.kernels.paged_flash_decode import (decode_plan,
                                                        paged_decode_plain,
                                                        paged_flash_decode,
                                                        paged_flash_verify,
                                                        paged_verify_plain,
                                                        verify_plan)
    from repro_torch.kernels.split_decode import (smem_bytes, sm_count,
                                                  verify_geometry,
                                                  verify_smem_bytes)
    from repro_torch.kernels.swiglu_gemv import swiglu_plain, swiglu_qgemv
    from repro_torch.quant.ptq import quantize_leaf

    gen = torch.Generator(device=device).manual_seed(11)
    sms = sm_count(device)
    groups = {}
    for arch in FAMILIES:
        cfg = get_config(arch)
        d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab
        H, G = cfg.n_heads * cfg.hd(), cfg.n_kv_heads * cfg.hd()
        shapes = [("wq", (d, H)), ("wk", (d, G)), ("wo", (H, d)),
                  ("w_down", (f, d))]
        if cfg.ffn_act != "silu":
            shapes.append(("w_up", (d, f)))
        shapes.append(("embed", (V, d)) if cfg.tie_embeddings
                      else ("head", (d, V)))
        for name, shape in shapes:
            w = quantize_leaf(name, torch.randn(shape, generator=gen,
                                                device=device) * 0.02, 4, 128)
            k = shape[1] if name == "embed" else shape[0]
            n = w.data.shape[0] if w.axis == -1 else w.data.shape[1]
            row = w.data.shape[1] if w.axis == -1 else n
            groups[f"{arch} {name}"] = w.group
            for m in (1, 4, 20):
                x = torch.randn(m, k, generator=gen, device=device)
                label = (f"{arch} int4 {name} {k}->{n} g{w.group} M={m} "
                         f"{vec_bytes(w, row)}B")
                out = cim_gemv(x, w)
                checks.compare("cim_gemv", label, out, cim_gemv_plain(x, w))
                checks.repeat("cim_gemv", label, out, cim_gemv(x, w))
            lay = "table" if w.axis == -1 else "cols"
            pl = split_plan(lay, 4, w.data.shape[1] if w.axis == -1
                            else w.data.shape[0], n, 4, sms)
            log(f"plan cim_gemv {arch} {name} M=4: M tile {pl.mt}, "
                f"{pl.splits} splits of {pl.rows} rows, {pl.blocks} blocks")
            del w, x, out
        if cfg.ffn_gated and cfg.ffn_act == "silu":
            wg, wu = (quantize_leaf(nm, torch.randn(d, f, generator=gen,
                                                    device=device) * 0.02,
                                    4, 128) for nm in ("w_gate", "w_up"))
            groups[f"{arch} w_gate"] = wg.group
            for m in (1, 4, 20):
                x = torch.randn(m, d, generator=gen, device=device)
                label = (f"{arch} int4 gate/up {d}->{f} g{wg.group} M={m} "
                         f"{min(vec_bytes(wg, f), vec_bytes(wu, f))}B")
                out = swiglu_qgemv(x, wg, wu)
                checks.compare("swiglu_qgemv", label, out,
                               swiglu_plain(x, wg, wu))
                checks.repeat("swiglu_qgemv", label, out,
                              swiglu_qgemv(x, wg, wu))
            del wg, wu
        torch.cuda.empty_cache()
    log("packed groups at full width: " + json.dumps(groups))
    for key, want in (("gemma3-4b wq", 80), ("gemma2-27b wq", 96),
                      ("phi3-medium-14b wq", 80),
                      ("phi3-medium-14b w_down", 112),
                      ("gemma3-4b embed", 80), ("gemma2-27b embed", 96)):
        if groups[key] != want:
            fail(f"{key}: packed in groups of {groups[key]}, expected {want}")

    # split-KV: lanes shorter than, at, 1 and 300 keys past the window;
    # verify windows of s = 5 end at the same lengths
    b, sv = 4, 5
    for arch, g, qpk, hd, window, cap, lens in (
            ("gemma3-4b", 4, 2, 256, 1024, 0.0, [700, 1024, 1025, 1324]),
            ("gemma3-4b", 4, 2, 256, 0, 0.0, [700, 1024, 1025, 1324]),
            ("gemma2-27b", 16, 2, 128, 4096, 50.0, [3000, 4096, 4097, 4396]),
            ("gemma2-27b", 16, 2, 128, 0, 50.0, [3000, 4096, 4097, 4396]),
            ("phi3-medium-14b", 10, 4, 128, 0, 0.0, [1024, 777, 301, 45])):
        max_pages = -(-max(lens) // 16) + 2
        kp, vp, ks, vs, tables = int8_pools(gen, device, b, max_pages, g, hd)
        lv = torch.tensor(lens, dtype=torch.int32, device=device)
        q = torch.randn(b, g, qpk, hd, generator=gen, device=device)
        args = (q, kp, vp, tables, lv, window, cap, ks, vs)
        label = (f"{arch} int8 hd {hd} qpk {qpk} len {lens} window={window}"
                 f" cap={cap}")
        out = paged_flash_decode(*args)
        checks.compare("paged_flash_decode", label, out,
                       paged_decode_plain(*args))
        checks.repeat("paged_flash_decode", label, out,
                      paged_flash_decode(*args))
        qv = torch.randn(b, sv, g, qpk, hd, generator=gen, device=device)
        vargs = (qv, kp, vp, tables, lv - sv, window, cap, ks, vs)
        label = (f"{arch} int8 hd {hd} s={sv} len {(lv - sv).tolist()} "
                 f"window={window} cap={cap}")
        out = paged_flash_verify(*vargs)
        checks.compare("paged_flash_verify", label, out,
                       paged_verify_plain(*vargs))
        checks.repeat("paged_flash_verify", label, out,
                      paged_flash_verify(*vargs))
        n_split, chunk = decode_plan(b, g, max_pages, 16, sms)
        vn, vchunk = verify_plan(b, g, sv, qpk, max_pages, 16, sms)
        warps, z = verify_geometry(sv * qpk)
        log(f"plan {arch} hd {hd} max_pages {max_pages}: paged_flash_decode "
            f"n_split {n_split} x {chunk} keys, {smem_bytes(1, hd)} B shared "
            f"memory (int8); paged_flash_verify n_split {vn} x {vchunk} "
            f"keys, {b * g * vn * z} blocks of {warps} warps, "
            f"{verify_smem_bytes(1, hd, warps)} B")
    del kp, vp, ks, vs

    # the window-blind split plan: 34 decode calls at gemma3's shape
    # (each on its own pools, 0.6 GB in all, past the 50 MB L2), batch 4,
    # every lane at 4096 keys, all with the window of its local layers
    # and all without; a windowed call folds 1024 keys a lane, and the
    # splits before them return empty partials
    L, n_keys, g, qpk, hd = 34, 4096, 4, 2, 256
    mp = n_keys // 16 + 1
    pools = [int8_pools(gen, device, b, mp, g, hd) for _ in range(L)]
    q = torch.randn(b, g, qpk, hd, generator=gen, device=device)
    l4 = torch.full((b,), n_keys, dtype=torch.int32, device=device)
    n_split, chunk = decode_plan(b, g, mp, 16, sms)
    live = -(-1024 // chunk) + 1
    out = {}
    for window in (1024, 0):
        t = graph_time_ms(lambda: [paged_flash_decode(
            q, *pools[i][:2], pools[i][4], l4, window, 0.0, *pools[i][2:4])
            for i in range(L)])
        keys = min(window or n_keys, n_keys)
        b_ms, b_by = bound(L * (b * keys * g * (2 * hd + 4) + 2 * q.numel()
                                * 4), L * b * keys * g * qpk * hd * 4)
        out[window] = t
        log(f"time paged_flash_decode x{L}, gemma3 hd {hd}, batch {b}, "
            f"every lane at {n_keys} keys, window={window}: {t:.4f} ms "
            f"(graph replay), bound {b_ms:.4f} ms ({b_by}); plan n_split "
            f"{n_split} x {chunk} keys, of which at most {live} hold keys "
            f"of a window of 1024")
    del pools
    torch.cuda.empty_cache()
    return {"window_1024_ms": out[1024], "window_0_ms": out[0],
            "n_split": n_split, "chunk": chunk}


def kernel_of(name: str, verify: bool):
    """The port's kernel a profiled device kernel belongs to (None for
    PyTorch's glue): the split-KV merge goes with the step's attention
    kernel."""
    for key, k in (("flash_decode_kernel", "flash_decode"),
                   ("cols_kernel", "cim_gemv"), ("rows_kernel", "cim_gemv"),
                   ("swiglu_kernel", "swiglu_qgemv"),
                   ("decode_kernel", "paged_flash_decode"),
                   ("verify_kernel", "paged_flash_verify"),
                   ("merge_kernel", "paged_flash_verify" if verify
                    else "paged_flash_decode")):
        if key in name:
            return k
    return None


def step_bounds(model, params, b: int, s: int, lens, expert_counts=None):
    """{kernel: (bytes, flops)} of one batch-b model step of width s
    (s = 1 decode, else a verify window) with lanes at `lens` keys
    before it: each packed weight and scale read once, each call's
    activations in and out; the K/V rows (INT8 + f16 scales) a layer's
    window rows see, q in and out; 2 flops per weight and row, 4 per
    visible key, query head and head dim.  A MoE layer's stacks count
    the experts with rows in this step (`expert_counts`: per layer, the
    rows of each expert, from the router) and their counted rows, and
    its shared experts as three projections; leading dense layers
    (`first_blocks`) count as dense.  MLA's attention is not a kernel:
    `mla_attention_cost` counts it."""
    cfg = model.cfg
    L, g, qpk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.q_per_kv(), cfg.hd()
    M = b * s
    mla = cfg.attn_kind == "mla"
    cost = {"cim_gemv": [0, 0], "swiglu_qgemv": [0, 0]}

    def add(kernel, ws):
        """One call over the weights `ws` (gate and up for swiglu)."""
        k, n = ((ws[0].orig_shape[-1], ws[0].orig_shape[-2])
                if ws[0].axis == -1 else ws[0].orig_shape[-2:])
        cost[kernel][0] += (sum(w.nbytes_packed() for w in ws)
                            + 4 * M * (k + n))
        cost[kernel][1] += 2 * M * k * n * len(ws)
    fused = cfg.ffn_gated and cfg.ffn_act == "silu"
    projections = ("wq", "w_dkv", "wo") if mla else ("wq", "wk", "wv", "wo")
    for name, n, dense in (("first_blocks", model.n_first, True),
                           ("blocks", L - model.n_first, False)):
        for i in range(n):
            blocks = params[name]
            for k in projections:
                add("cim_gemv", [blocks["attn"][k][i]])
            if cfg.moe is not None and not dense:
                cb, cf = stack_cost([blocks["ffn"][k][i] for k in
                                     ("we_gate", "we_up", "we_down")],
                                    expert_counts[i])
                cost["cim_gemv"][0] += cb
                cost["cim_gemv"][1] += cf
                for k in ("ws_gate", "ws_up", "ws_down"):
                    if k in blocks["ffn"]:
                        add("cim_gemv", [blocks["ffn"][k][i]])
                continue
            for k in blocks["ffn"]:
                if not fused or k == "w_down":
                    add("cim_gemv", [blocks["ffn"][k][i]])
            if fused:
                add("swiglu_qgemv", [blocks["ffn"][k][i]
                                     for k in ("w_gate", "w_up")])
    add("cim_gemv", [params["embed"] if cfg.tie_embeddings
                     else params["head"]])
    if mla:
        return cost
    kv_rows = keys = 0
    for i in range(L):
        win = cfg.local_window if cfg.is_local_layer(i) else 0
        for n_len in lens:
            last = n_len + s                 # the lane's keys after the step
            kv_rows += min(last, win + s - 1) if win else last
            for j in range(s):               # row j sees keys <= n_len + j
                keys += min(n_len + j + 1, win) if win else n_len + j + 1
    attn = "paged_flash_decode" if s == 1 else "paged_flash_verify"
    cost[attn] = [kv_rows * g * (2 * hd + 4)
                  + L * 2 * M * g * qpk * hd * 4,
                  keys * g * qpk * hd * 4]
    return cost


def log_step_split(label, per_mode, bounds, verify: bool, launches):
    """A profiled step's device ms by kernel (graph replay), each beside
    its bound, and PyTorch's glue.  Returns the split."""
    by_name, wall_ms = per_mode["graph replay"]
    split = {}
    for nm, us in by_name.items():
        k = kernel_of(nm, verify) or "glue"
        split[k] = split.get(k, 0.0) + us / 1e3
    out = {}
    for k, ms in sorted(split.items(), key=lambda kv: -kv[1]):
        row = {"device_ms": ms, "launches": launches.get(k)}
        if k in bounds:
            b_ms, b_by = bound(*bounds[k])
            row.update(bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
                       bytes=bounds[k][0], flops=bounds[k][1])
        out[k] = row
    log(f"{label} (graph replay, wall {wall_ms:.3f} ms, device "
        f"{sum(split.values()):.3f} ms): " + "; ".join(
            f"{k} x{v['launches']} {v['device_ms']:.4f} ms"
            + (f" (bound {v['bound_ms']:.4f} ms, {v['bound_by']}, "
               f"{100 * v['bound_share']:.2f} %)" if "bound_ms" in v else "")
            if v["launches"] is not None else f"{k} {v['device_ms']:.4f} ms"
            for k, v in out.items()))
    return out


def serve_timed(eng, reqs):
    """Step `eng` until `reqs` are done; wall ms of each decode-only
    step (verify or plain decode, no prefill call) and whether it
    verified."""
    import torch
    for r in reqs:
        eng.submit(r)
    steps = []
    while eng.busy:
        pre, ver, dec = eng.prefill_calls, eng.verify_calls, eng.decode_calls
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if eng.prefill_calls == pre and (eng.verify_calls > ver
                                         or eng.decode_calls > dec):
            steps.append(((time.perf_counter() - t0) * 1e3,
                          eng.verify_calls > ver))
    return steps


def phase_gemma3(device, card):
    """gemma3-4b at full width and depth served by PagedServeEngine as
    CUDA graphs and eagerly: a wave of 4 requests, then one request
    whose prompt passes the 1024-key window, then n-gram speculation on
    motif prompts; launches, graphs, replays and streams checked; a
    profiled decode and verify step split by kernel beside its bound."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import build_model
    from repro_torch.serve import PagedServeEngine, ServeConfig, ServeRequest
    from repro_torch.spec import SpecConfig

    cfg = get_config("gemma3-4b").replace(dtype="float32", remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params = build_model(cfg, "int4", 128, device, seed=0)
    torch.cuda.synchronize()
    wq, table = params["blocks"]["attn"]["wq"], params["embed"]
    log(f"gemma3-4b INT4 weights drawn and packed on the card in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated (peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB while drawing); "
        f"wq groups of {wq.group}, w_down of "
        f"{params['blocks']['ffn']['w_down'].group}, table of {table.group};"
        f" local layers {sum(map(cfg.is_local_layer, range(cfg.n_layers)))}"
        f"/{cfg.n_layers}")
    if wq.group != 80 or table.group != 80:
        fail(f"gemma3-4b packed in groups of {wq.group} / {table.group}, "
             "expected 80")
    V, n_new = cfg.vocab, 16
    rng = np.random.default_rng(3)
    wave = [rng.integers(0, V, int(n)).astype(np.int32)
            for n in rng.integers(16, 65, size=4)]
    long_prompt = rng.integers(0, V, int(rng.integers(1100, 1201))
                               ).astype(np.int32)
    serve_cfg = ServeConfig(precision="int4", kv_dtype="auto", max_batch=4,
                            max_seq=1280, page_size=16, prefill_chunk=16)

    def serve(eager):
        eng = PagedServeEngine(model, params, serve_cfg, device=device,
                               eager=eager)
        if eng.config.resolved_kv_dtype() != torch.int8:
            fail("gemma3-4b: kv_dtype auto did not resolve to int8")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t_run = time.perf_counter()
        w1, ms1, m1 = run_wave(eng, wave, n_new, 0)
        w2, ms2, m2 = run_wave(eng, [long_prompt], n_new, 4)
        run_s = time.perf_counter() - t_run
        counts = launch_counts()
        reqs = w1 + w2
        mode = "eager" if eager else "graph"
        gen_tokens = sum(len(r.out_tokens) for r in reqs)
        if gen_tokens != 5 * n_new or not all(
                r.done and all(0 <= t < V for t in r.out_tokens)
                for r in reqs):
            fail(f"gemma3-4b ({mode}): {gen_tokens} tokens, expected "
                 f"{5 * n_new} in range")
        expect = expected_launches(cfg, eng.prefill_calls, eng.decode_calls)
        log(f"gemma3-4b ({mode}): prompts {[len(r.prompt) for r in reqs]}, "
            f"{gen_tokens} tokens in {run_s:.2f} s; {eng.prefill_calls} "
            f"prefill + {eng.decode_calls} decode calls; launches {counts}, "
            f"expected {expect}")
        if counts != expect or min(counts["cim_gemv"],
                                   counts["paged_flash_decode"]) <= 0:
            fail(f"gemma3-4b ({mode}): launches {counts} != {expect}")
        return dict(eng=eng, reqs=reqs, counts=counts, run_s=run_s,
                    decode_ms=[float(np.median(ms1)), float(np.median(ms2))],
                    ttft_ms=[m1["ttft_p50_s"] * 1e3, m2["ttft_p50_s"] * 1e3],
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    graph, eager = serve(False), serve(True)
    eng = graph["eng"]
    check_identity("graphs vs eager (gemma3-4b)", eager["reqs"],
                   graph["reqs"], model, params, device)
    name = f"{cfg.name}.serve_step"
    graphs = check_graphs("gemma3-4b", eng, {
        (name, (4, 16)): step_launches(cfg, 16),
        (name, (4, 1)): step_launches(cfg, 1)},
        [(name, (4, 16)), (name, (4, 1))])
    replay_ms = replay_check("gemma3-4b decode", eng, model.serve_step,
                             (4, 1))
    result = {"launches": graph["counts"], "graphs": graphs,
              "decode_replay_device_ms": replay_ms,
              "launches_per_decode_step": step_launches(cfg, 1),
              "long_prompt_tokens": len(long_prompt)}
    for mode, run in (("graph", graph), ("eager", eager)):
        result[mode] = {
            "decode_step_ms_median_wave": run["decode_ms"][0],
            "decode_step_ms_median_long_lane": run["decode_ms"][1],
            "ttft_p50_ms_wave": run["ttft_ms"][0],
            "ttft_ms_long_prompt": run["ttft_ms"][1],
            "max_memory_allocated_gb": run["peak_gb"], "run_s": run["run_s"]}
    log("gemma3-4b result " + json.dumps(result))
    _, modes = profile_step(model, params, eng, device)
    result["decode_step_split"] = log_step_split(
        "gemma3-4b decode step, batch 4, lanes at 64 keys, by kernel",
        modes, step_bounds(model, params, 4, 1, [64] * 4), False,
        step_launches(cfg, 1))
    del eager
    eng = None
    graph["eng"] = None

    # n-gram speculation on motif prompts, against the same prompts
    # without it; graphs and eager
    motif = rng.integers(0, V, 8).astype(np.int32)
    prompts = [np.tile(motif, 8)[:int(n)]
               for n in rng.integers(32, 65, size=4)]
    spec_cfg = ServeConfig(precision="int4", kv_dtype="auto", max_batch=4,
                           max_seq=128, page_size=16, prefill_chunk=16)

    def spec_serve(spec, eager=False):
        e = PagedServeEngine(model, params, spec_cfg, spec=spec,
                             device=device, eager=eager)
        reqs = [ServeRequest(prompt=p.copy(), max_new_tokens=24, rid=i)
                for i, p in enumerate(prompts)]
        reset_launch_counts()
        steps = serve_timed(e, reqs)
        counts = launch_counts()
        expect = expected_launches(cfg, e.prefill_calls, e.decode_calls,
                                   e.verify_calls)
        label = ("gemma3-4b spec ngram k=4" if spec else "gemma3-4b no spec"
                 ) + (" (eager)" if eager else "")
        ver = [ms for ms, v in steps if v]
        log(f"{label}: {e.prefill_calls} prefill + {e.decode_calls} decode "
            f"+ {e.verify_calls} verify calls; launches {counts}, expected "
            f"{expect}; verify step wall median "
            f"{float(np.median(ver)) if ver else float('nan'):.3f} ms over "
            f"{len(ver)} steps; acceptance "
            f"{e.summary().get('spec_acceptance_rate')}")
        if counts != expect or sum(len(r.out_tokens) for r in reqs) != 96:
            fail(f"{label}: launches {counts} != {expect}, or tokens short")
        if spec is not None and e.verify_calls <= 0:
            fail(f"{label}: no verify call")
        return e, reqs, counts, (float(np.median(ver)) if ver else None)

    _, base, _, _ = spec_serve(None)
    s_eng, s_reqs, s_counts, s_ms = spec_serve(SpecConfig(k=4))
    _, e_reqs, _, e_ms = spec_serve(SpecConfig(k=4), eager=True)
    check_identity("gemma3-4b spec ngram", base, s_reqs, model, params,
                   device)
    check_identity("graphs vs eager (gemma3-4b spec ngram)", e_reqs, s_reqs,
                   model, params, device)
    verify = (f"{cfg.name}.paged_verify_step", (4, 5))
    check_graphs("gemma3-4b spec ngram", s_eng, {
        (name, (4, 16)): step_launches(cfg, 16),
        (name, (4, 1)): step_launches(cfg, 1),
        verify: step_launches(cfg, 5, verify=True)}, [(name, (4, 16)),
                                                      verify])
    v_replay = replay_check("gemma3-4b spec verify", s_eng,
                            model.paged_verify_step, (4, 5))
    _, modes = profile_step(model, params, s_eng, device, s=5)
    result["spec_ngram"] = {
        "launches": s_counts, "verify_calls": s_eng.verify_calls,
        "verify_step_ms_median": s_ms, "verify_step_ms_median_eager": e_ms,
        "verify_replay_device_ms": v_replay,
        "acceptance_rate": s_eng.summary().get("spec_acceptance_rate"),
        "verify_step_split": log_step_split(
            "gemma3-4b verify step, batch 4, s=5, lanes at 64 keys, by "
            "kernel", modes, step_bounds(model, params, 4, 5, [64] * 4),
            True, step_launches(cfg, 5, verify=True))}
    del s_eng, model, params
    torch.cuda.empty_cache()
    log("gemma3-4b spec result " + json.dumps(result["spec_ngram"]))
    return graph["counts"], s_counts, result


def phase_short_wave(arch, device, n_layers: int = 4):
    """`arch` at full width and `n_layers` layers: one wave of 4
    requests served as CUDA graphs; launches and graphs checked."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import build_model
    from repro_torch.serve import PagedServeEngine, ServeConfig

    cfg = get_config(arch).replace(dtype="float32", remat=False,
                                   n_layers=n_layers)
    t0 = time.perf_counter()
    model, params = build_model(cfg, "int4", 128, device, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    wave = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
            for n in rng.integers(16, 65, size=4)]
    eng = PagedServeEngine(model, params, ServeConfig(
        precision="int4", kv_dtype="auto", max_batch=4, max_seq=128,
        page_size=16, prefill_chunk=16), device=device)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    reqs, ms, m = run_wave(eng, wave, 16, 0)
    counts = launch_counts()
    expect = expected_launches(cfg, eng.prefill_calls, eng.decode_calls)
    n_tok = sum(len(r.out_tokens) for r in reqs)
    log(f"{arch} x{n_layers} layers, full width (drawn and packed in "
        f"{setup_s:.1f} s): {n_tok} tokens, decode step wall median "
        f"{float(np.median(ms)):.3f} ms, TTFT p50 "
        f"{m['ttft_p50_s'] * 1e3:.1f} ms, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{counts}, expected {expect}")
    if counts != expect or n_tok != 64 or not all(
            0 <= t < cfg.vocab for r in reqs for t in r.out_tokens):
        fail(f"{arch}: launches {counts} != {expect}, or tokens wrong")
    name = f"{cfg.name}.serve_step"
    check_graphs(arch, eng, {(name, (4, 16)): step_launches(cfg, 16),
                             (name, (4, 1)): step_launches(cfg, 1)},
                 [(name, (4, 16)), (name, (4, 1))])
    replay_ms = replay_check(f"{arch} decode", eng, model.serve_step, (4, 1))
    del eng, model, params
    torch.cuda.empty_cache()
    return counts, {"decode_step_ms_median": float(np.median(ms)),
                    "decode_replay_device_ms": replay_ms,
                    "ttft_p50_ms": m["ttft_p50_s"] * 1e3}


def phase_card_vs_cpu(device, arch: str = "qwen2.5-3b", long_lane=False,
                      n_layers: int = 2, decode_steps: int = 1, **cut):
    """A 2-layer full-width copy of `arch` (weights drawn on the card
    from seed 2, copied to the CPU), stepped in lockstep through
    serve_step on the card (kernels) and on the CPU (plain versions):
    two lanes, one prefill chunk and one decode step; with `long_lane`
    one lane past its window instead (cut to 128 keys by the caller:
    past gemma3's 1024 the CPU's plain table contraction over 262144
    rows took 271 s of a chip run), prefilled in chunks of 128, then two
    decode steps.  Every real row's logits compared.  `decode_steps`
    decode steps follow the chunk; a recurrent family's arena steps with
    its pools (`n_layers`: 3 for zamba, one Mamba2 group and a tail
    layer)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_model
    from repro_torch.models.common import tree_to

    cfg = get_config(arch).replace(dtype="float32", remat=False,
                                   n_layers=n_layers, **cut)
    t0 = time.perf_counter()
    model, params = build_model(cfg, "int4", 128, device, seed=2)
    devs = {"cpu": tree_to(params, "cpu"), str(device): params}
    if long_lane:
        b, max_pages = 1, 16
        plan = [(128, [128]), (128, [66]), (1, [1]), (1, [1])]
    else:
        b, max_pages = 2, 8
        plan = [(16, [16, 11])] + [(1, [1, 1])] * decode_steps
    # INT8 pools, but MLA's latent pools, which stay float (bf16, as its
    # engine resolves kv_dtype "auto"); a recurrent family's arena too
    caches = {d: fresh_state(model, b, b * max_pages, 16, d) for d in devs}
    g = torch.Generator().manual_seed(3)
    lengths = torch.zeros(b, dtype=torch.int32)
    err = tol_min = 0.0
    n_rows = n_clear = n_agree = 0
    for s, n_new in plan:
        tok = torch.randint(0, cfg.vocab, (b, s), generator=g)
        nn = torch.tensor(n_new, dtype=torch.int32)
        out = {}
        for d, p in devs.items():
            tables = torch.arange(b * max_pages, dtype=torch.int32,
                                  device=d).reshape(b, max_pages)
            logits, _ = model.serve_step(p, caches[d], {"tokens": tok.to(d)},
                                         tables, lengths.to(d), nn.to(d))
            out[d] = torch.cat([logits[i, :n] for i, n in enumerate(n_new)]
                               ).cpu()
        ref, got = out["cpu"], out[str(device)]
        if got.shape != ref.shape or not torch.isfinite(got).all():
            fail(f"{arch}: card logits {tuple(got.shape)} not finite / "
                 "wrong shape")
        tol = LOGIT_TOL * max(1.0, float(ref.abs().max()))
        step_err = float((got - ref).abs().max())
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > tol
        if step_err > tol or not bool(
                (got.argmax(-1) == ref.argmax(-1))[clear].all()):
            fail(f"{arch}: card and CPU logits disagree at lengths "
                 f"{lengths.tolist()} + {n_new}: max diff {step_err:.3e}, "
                 f"tol {tol:.3e}")
        err = max(err, step_err)
        tol_min = tol if not n_rows else min(tol_min, tol)
        n_rows += ref.shape[0]
        n_clear += int(clear.sum())
        n_agree += int((got.argmax(-1) == ref.argmax(-1))[clear].sum())
        lengths = lengths + nn
    log(f"card vs CPU, {arch} {n_layers} layers at full width"
        + (f" ({', '.join(f'{k}={v}' for k, v in cut.items())})" if cut
           else "")
        + f", local layers "
        f"{[cfg.is_local_layer(i) for i in range(n_layers)]}: "
        f"{len(plan)} steps, lanes to {lengths.tolist()} keys, {n_rows} "
        f"rows; max logit diff {err:.3e} (smallest step tol "
        f"{tol_min:.3e}); argmax agrees on {n_agree}/{n_clear} rows with a "
        f"top-2 gap above tol; {time.perf_counter() - t0:.1f} s")
    del devs, params, caches
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Mixture-of-Experts: qwen3-moe-235b-a22b at full width, 4 layers
# ---------------------------------------------------------------------------
MOE_ARCH = "qwen3-moe-235b-a22b"


def random_stack(gen, device, bits, E, k, n, group):
    """A packed (E, k, n) expert stack of random INT4 nibbles / INT8
    bytes and f16 scales near 0.01 (drawn packed: no f32 stack)."""
    import torch
    from repro_torch.quant.qarray import QTensor
    if bits == 4:
        data = torch.randint(0, 256, (E, k // 2, n), generator=gen,
                             device=device, dtype=torch.uint8)
    else:
        data = torch.randint(-127, 128, (E, k, n), generator=gen,
                             device=device, dtype=torch.int8)
    scales = (torch.rand(E, k // group, n, generator=gen, device=device)
              * 0.01 + 0.005).half()
    return QTensor(data, scales, bits, group, -2, (E, k, n))


def route_counts(gen, device, E, C, tokens, top_k):
    """Rows per expert of `tokens` tokens each routed to top_k distinct
    experts at random, capped at C (int32 on the card)."""
    import torch
    ids = torch.stack([torch.randperm(E, generator=gen, device=device)
                       [:top_k] for _ in range(tokens)])
    counts = torch.zeros(E, dtype=torch.long, device=device)
    counts.scatter_add_(0, ids.reshape(-1), torch.ones_like(ids.reshape(-1)))
    return counts.clamp(max=C).int()


def stack_cost(ws, counts):
    """(bytes, flops) of stack calls over `ws` at per-expert `counts`
    (a list of ints): the packed weight and scales of the experts with
    a row, each read once, the counted rows of x in and out; 2 flops
    per weight and counted row."""
    act = [e for e, c in enumerate(counts) if c > 0]
    rows = sum(counts)
    nbytes = flops = 0
    for w in ws:
        k, n = w.orig_shape[-2:]
        nbytes += sum(w.data[e].numel() + 2 * w.scales[e].numel()
                      for e in act) + 4 * rows * (k + n)
        flops += 2 * rows * k * n
    return nbytes, flops


def check_stacks(checks, gen, device, bits, E, C, shapes, tag=""):
    """cim_gemv's expert-stack layout against its plain version on the
    counted rows, every call twice (bitwise equal): E experts of
    capacity C, counts 0, 1, C and others, then every expert full; x
    rows past a count hold NaN, which must not reach a counted row.
    `shapes`: (what, K, N, group) of each stack.  Logs each plan."""
    import torch
    from repro_torch.kernels.cim_gemv import (cim_gemv, cim_gemv_plain,
                                              smem_bytes, stack_plan)
    from repro_torch.kernels.split_decode import sm_count
    for what, k, n, group in shapes:
        w = random_stack(gen, device, bits, E, k, n, group)
        x = torch.randn(E, C, k, generator=gen, device=device)
        ref = cim_gemv_plain(x, w)
        mixed = torch.randint(0, C + 1, (E,), generator=gen,
                              device=device).int()
        mixed[:4] = torch.tensor([0, 1, C, 3], device=device)
        full = torch.full((E,), C, dtype=torch.int32, device=device)
        for cname, counts in ((f"counts 0/1/{C}/mixed", mixed),
                              (f"all {E} experts full", full)):
            rows = torch.arange(C, device=device)[None] < counts[:, None]
            xn = torch.where(rows[..., None], x, float("nan"))
            label = (f"{tag}stack int{bits} {what} {k}->{n} g{group} E={E} "
                     f"C={C} {cname}")
            out = cim_gemv(xn, w, counts)
            checks.compare("cim_gemv", label, out[rows], ref[rows])
            checks.repeat("cim_gemv", label, out[rows],
                          cim_gemv(xn, w, counts)[rows])
        pl = stack_plan(C, w.data.shape[1], n, bits, E, sm_count(device))
        log(f"plan cim_gemv {tag}stack int{bits} {what} C={C}: M tile "
            f"{pl.mt}, {pl.splits} splits of {pl.rows} rows, "
            f"{pl.blocks} blocks an expert x {E}, "
            f"{smem_bytes('cols', pl, C, k, bits, group)} B shared "
            "memory")
        del w, x, ref


def phase_moe_kernels(device, checks: Checks):
    """The kernels at qwen3-moe's new shapes and at gemma2-27b's INT8
    widths against their plain versions, every call twice (bitwise
    equal): cim_gemv's expert-stack layout (128 experts, capacity 8;
    counts 0, 1, 8 and others, then all 128 experts full; x rows past a
    count hold NaN, which must not reach a counted row), the split-KV
    kernels at 16 query heads per kv head (hd 128, INT8 pools; verify at
    s = 5: 80 rows), gemma2-27b's INT8 table and w_down at M = 4, 20,
    64.  Then 4 layers' worth of decode calls of each at qwen3-moe's
    shapes, beside their bounds.  Returns the timings."""
    import torch
    from repro_torch.kernels.cim_gemv import (cim_gemv, cim_gemv_plain,
                                              smem_bytes, split_plan,
                                              table_rows)
    from repro_torch.kernels.paged_flash_decode import (decode_plan,
                                                        paged_decode_plain,
                                                        paged_flash_decode,
                                                        paged_flash_verify,
                                                        paged_verify_plain,
                                                        verify_plan)
    from repro_torch.kernels.split_decode import sm_count
    from repro_torch.quant.qarray import quantize

    gen = torch.Generator(device=device).manual_seed(41)
    sms = sm_count(device)
    E, C, d, fe, top_k, L = 128, 8, 4096, 1536, 8, 4
    shapes = (("gate/up", d, fe, 128), ("down", fe, d, 96))
    timings = {}
    for bits in (4, 8):
        check_stacks(checks, gen, device, bits, E, C, shapes)
    torch.cuda.empty_cache()

    # gemma2-27b at INT8: its table (4608 B rows, 32 a tile) and w_down
    # (K = 36864: 32 splits past M = 4), the repair
    for name, shape, axis in (("table", (256000, 4608), 1),
                              ("w_down", (36864, 4608), 0)):
        w = quantize(torch.randn(shape, generator=gen, device=device)
                     * 0.02, 8, 96, axis=axis)
        k = shape[1] if axis == 1 else shape[0]
        n = shape[0] if axis == 1 else shape[1]
        lay = "table" if axis == 1 else "cols"
        for m in (4, 20, 64):
            x = torch.randn(m, k, generator=gen, device=device)
            label = f"gemma2-27b int8 {name} {k}->{n} g96 M={m}"
            out = cim_gemv(x, w)
            checks.compare("cim_gemv", label, out, cim_gemv_plain(x, w))
            checks.repeat("cim_gemv", label, out, cim_gemv(x, w))
            pl = split_plan(lay, m, w.data.shape[1 if axis == 1 else 0], n,
                            8, sms)
            if lay == "table":
                pl = table_rows(pl, k, n, 8, 96, sms)
            log(f"plan cim_gemv gemma2-27b int8 {name} M={m}: M tile "
                f"{pl.mt}, {pl.splits} splits of {pl.rows} rows, "
                f"{pl.blocks} blocks, "
                f"{smem_bytes(lay, pl, m, k, 8, 96)} B shared memory")
        del w
    torch.cuda.empty_cache()

    # split-KV at 16 query heads per kv head: 4 lanes x 4 kv heads, hd
    # 128, INT8 pools, lengths on a split boundary, past it, 1 and 0;
    # verify windows of s = 5 (80 rows, two blocks of rows)
    b, g, qpk, hd, ps, max_pages = 4, 4, 16, 128, 16, 72
    kp, vp, ks, vs, tables = int8_pools(gen, device, b, max_pages, g, hd)
    _, chunk = decode_plan(b, g, max_pages, ps, sms, qpk)
    q = torch.randn(b, g, qpk, hd, generator=gen, device=device)
    qv = torch.randn(b, 5, g, qpk, hd, generator=gen, device=device)
    for lens in ([1024, 777, 301, 45], [chunk, chunk + 1, 1, 0]):
        lengths = torch.tensor(lens, dtype=torch.int32, device=device)
        args = (q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
        label = f"qpk 16 hd 128 int8 lengths {lens}"
        out = paged_flash_decode(*args)
        checks.compare("paged_flash_decode", label, out,
                       paged_decode_plain(*args))
        checks.repeat("paged_flash_decode", label, out,
                      paged_flash_decode(*args))
        args = (qv, kp, vp, tables, (lengths - 5).clamp(min=0), 0, 0.0, ks,
                vs)
        label = f"qpk 16 s=5 hd 128 int8 lengths {lens}"
        out = paged_flash_verify(*args)
        checks.compare("paged_flash_verify", label, out,
                       paged_verify_plain(*args))
        checks.repeat("paged_flash_verify", label, out,
                      paged_flash_verify(*args))

    # ---- timings at qwen3-moe's shapes, 4 layers ----------------------
    # the stacks of a decode step: 4 tokens routed to 8 of 128 experts
    # each (at most 32 experts with a row), each layer its own weights
    layers = [{nm: random_stack(gen, device, 4, E, k, n, group)
               for nm, (_, k, n, group) in zip(("we_gate", "we_down"),
                                               shapes)} for _ in range(L)]
    for lw in layers:
        lw["we_up"] = random_stack(gen, device, 4, E, d, fe, 128)
    for label, tokens in (("decode step, 4 tokens", 4),
                          ("prefill chunk, 64 tokens", 64)):
        counts = [route_counts(gen, device, E, C, tokens, top_k)
                  for _ in range(L)]
        xs = torch.randn(E, C, d, generator=gen, device=device)
        hs = torch.randn(E, C, fe, generator=gen, device=device)

        def stack_step(fn, counts=counts, xs=xs, hs=hs):
            for lw, c in zip(layers, counts):
                fn(xs, lw["we_gate"], c)
                fn(xs, lw["we_up"], c)
                fn(hs, lw["we_down"], c)
        nbytes = flops = 0
        for lw, c in zip(layers, counts):
            cb, cf = stack_cost([lw["we_gate"], lw["we_up"], lw["we_down"]],
                                c.tolist())
            nbytes, flops = nbytes + cb, flops + cf
        active = [int((c > 0).sum()) for c in counts]
        time_calls(timings, "cim_gemv",
                   f"expert stacks of a qwen3-moe {label}, {L} layers x 3 "
                   f"calls, INT4, E={E} C={C}, experts with rows per layer "
                   f"{active}", stack_step,
                   lambda x, w, c: cim_gemv(x, w, c),
                   lambda x, w, c: cim_gemv_plain(x, w), nbytes, flops,
                   key=f"cim_gemv stack {tokens} tokens")
    del layers
    torch.cuda.empty_cache()

    pools = [int8_pools(gen, device, b, max_pages, g, hd) for _ in range(L)]
    lengths = torch.tensor([1024, 777, 301, 45], dtype=torch.int32,
                           device=device)

    def pd_step(fn):
        for kp, vp, ks, vs, tables in pools:
            fn(q, kp, vp, tables, lengths, 0, 0.0, ks, vs)

    def pv_step(fn):
        for kp, vp, ks, vs, tables in pools:
            fn(qv, kp, vp, tables, lengths - 5, 0, 0.0, ks, vs)
    tokens = int(lengths.sum())
    rows_v = tokens
    keys_v = sum(5 * (n - 5) + 15 for n in lengths.tolist())
    n_split, chunk = decode_plan(b, g, max_pages, ps, sms, qpk)
    log(f"plan paged_flash_decode qpk 16 b={b} g={g} max_pages={max_pages}"
        f": n_split {n_split}, chunk {chunk} keys, {b * g * n_split * 2} "
        "blocks (2 of 8 heads a row and split)")
    time_calls(timings, "paged_flash_decode",
               f"qwen3-moe decode attention, {L} calls, batch {b}, g={g} "
               f"qpk={qpk} hd={hd}, lengths 1024/777/301/45", pd_step,
               paged_flash_decode, paged_decode_plain,
               L * (tokens * g * (2 * hd + 4) + 2 * q.numel() * 4
                    + b * (max_pages + 1) * 4),
               L * tokens * g * qpk * hd * 4, key="paged_flash_decode qpk16")
    n_split, chunk = verify_plan(b, g, 5, qpk, max_pages, ps, sms)
    log(f"plan paged_flash_verify qpk 16 s=5: n_split {n_split}, chunk "
        f"{chunk} keys")
    time_calls(timings, "paged_flash_verify",
               f"qwen3-moe verify attention, {L} calls, batch {b}, s=5, "
               f"qpk={qpk} hd={hd}, lengths 1024/777/301/45 after the "
               "window", pv_step, paged_flash_verify, paged_verify_plain,
               L * (rows_v * g * (2 * hd + 4) + 2 * qv.numel() * 4
                    + b * (max_pages + 1) * 4),
               L * keys_v * g * qpk * hd * 4, key="paged_flash_verify qpk16")
    del pools, kp, vp, ks, vs
    torch.cuda.empty_cache()
    return timings


class RouteLog:
    """Spies on `repro_torch.models.ffn.dispatch_slots` while on: per
    call, the tokens routed, the experts that kept a row, the slots
    dropped at capacity (host reads: eager runs only)."""

    def __init__(self):
        from repro_torch.models import ffn
        self.ffn, self.orig, self.calls, self.counts = ffn, None, [], []

    def __enter__(self):
        self.orig = self.ffn.dispatch_slots
        orig = self.orig

        def spy(ids, n_experts, cap, groups=1):
            slot, counts = orig(ids, n_experts, cap, groups)
            self.calls.append((int(ids.shape[0]), int((counts > 0).sum()),
                               int((slot == n_experts * groups * cap)
                                   .sum())))
            self.counts.append(counts.tolist())
            return slot, counts
        self.ffn.dispatch_slots = spy
        return self

    def __exit__(self, *exc):
        self.ffn.dispatch_slots = self.orig

    def summary(self, decode_tokens: int):
        dec = [c for c in self.calls if c[0] == decode_tokens]
        pre = [c for c in self.calls if c[0] != decode_tokens]

        def mean(v):
            return sum(v) / len(v) if v else None
        return {"decode_calls": len(dec),
                "experts_kept_per_layer_decode_mean":
                    mean([c[1] for c in dec]),
                "experts_kept_per_layer_decode_max":
                    max([c[1] for c in dec], default=None),
                "slots_dropped_decode": sum(c[2] for c in dec),
                "other_calls": len(pre),
                "experts_kept_per_layer_other_mean":
                    mean([c[1] for c in pre]),
                "slots_dropped_other": sum(c[2] for c in pre),
                "tokens_other": sum(c[0] for c in pre)}


def step_route_counts(model, params, eng, s: int):
    """Per-layer expert counts of the batch-4 step `profile_step` runs
    (tokens 0, lanes at 64 keys): the same inputs, one eager call."""
    import numpy as np
    import torch
    b, mp = eng.max_batch, eng.cache.max_pages
    dev = eng.device
    fn = model.serve_step if s == 1 else model.paged_verify_step
    with RouteLog() as rl:
        fn(params, eng.cache.pools,
           {"tokens": torch.zeros(b, s, dtype=torch.int32, device=dev)},
           torch.from_numpy(np.arange(b * mp, dtype=np.int32)
                            .reshape(b, mp)).to(dev),
           torch.full((b,), 64, dtype=torch.int32, device=dev),
           torch.full((b,), s, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
    return rl.counts


# ---------------------------------------------------------------------------
# MLA: deepseek-v2-lite-16b at full width, 8 layers
# ---------------------------------------------------------------------------
DS_ARCH = "deepseek-v2-lite-16b"


def phase_deepseek_kernels(device, checks: Checks):
    """The GEMV kernels at deepseek-v2-lite-16b's shapes against their
    plain versions, every call twice (bitwise equal): cim_gemv on MLA's
    wq (2048 -> 3072), w_dkv (2048 -> 576, nine 64-column tiles) and wo,
    layer 0's w_down (10944 -> 2048, groups of 114), the shared experts
    (2048 -> 2816, 2816 -> 2048 in groups of 88) and the untied head
    (2048 -> 102400) at M = 1, 4, 20, 64; the 64-expert stacks (gate/up
    2048 -> 1408, down 1408 -> 2048 in groups of 88; capacity 8, counts
    0 / 1 / 8 / mixed, then all full; NaN rows past a count);
    swiglu_qgemv 2048 -> 10944 (85.5 column tiles) at M = 1, 4, 20, 64.
    Then layer 0's two calls, one decode step's MLA projections over 8
    layers, and 7 layers of stack calls at a decode routing, each
    beside its bound.  Returns the timings."""
    import torch
    from repro_torch.kernels.cim_gemv import (cim_gemv, cim_gemv_plain,
                                              smem_bytes, split_plan)
    from repro_torch.kernels import swiglu_gemv as sw
    from repro_torch.kernels.swiglu_gemv import swiglu_plain, swiglu_qgemv
    from repro_torch.kernels.split_decode import sm_count
    from repro_torch.quant.qarray import quantize

    gen = torch.Generator(device=device).manual_seed(43)
    sms = sm_count(device)
    d, E, C, fe, top_k, L = 2048, 64, 8, 1408, 6, 8

    def packed(k, n, group, bits=4):
        return quantize(torch.randn(k, n, generator=gen, device=device)
                        * 0.02, bits, group)
    ws = {"wq": (d, 3072, 128), "w_dkv": (d, 576, 128), "wo": (d, d, 128),
          "w_down": (10944, d, 114), "ws_gate": (d, 2816, 128),
          "ws_down": (2816, d, 88), "head": (d, 102400, 128)}
    timings = {}
    for bits in (4, 8):
        for name, (k, n, group) in ws.items():
            w = packed(k, n, group, bits)
            for m in (1, 4, 20, 64):
                x = torch.randn(m, k, generator=gen, device=device)
                label = f"deepseek int{bits} {name} {k}->{n} g{group} M={m}"
                out = cim_gemv(x, w)
                checks.compare("cim_gemv", label, out, cim_gemv_plain(x, w))
                checks.repeat("cim_gemv", label, out, cim_gemv(x, w))
                if bits == 4 and m in (4, 20) and name in ("w_down",
                                                           "w_dkv"):
                    pl = split_plan("cols", m, w.data.shape[0], n, bits, sms)
                    log(f"plan cim_gemv deepseek {name} g{group} M={m}: M "
                        f"tile {pl.mt}, {pl.splits} splits of {pl.rows} "
                        f"rows, {pl.blocks} blocks, "
                        f"{smem_bytes('cols', pl, m, k, bits, group)} B "
                        "shared memory")
            del w
        wg, wu = packed(d, 10944, 128, bits), packed(d, 10944, 128, bits)
        for m in (1, 4, 20, 64):
            x = torch.randn(m, d, generator=gen, device=device)
            label = f"deepseek int{bits} gate/up {d}->10944 g128 M={m}"
            out = swiglu_qgemv(x, wg, wu)
            checks.compare("swiglu_qgemv", label, out, swiglu_plain(x, wg, wu))
            checks.repeat("swiglu_qgemv", label, out, swiglu_qgemv(x, wg, wu))
        pl = sw.split_plan(4, wg.data.shape[0], 10944, bits, 128, sms)
        log(f"plan swiglu_qgemv deepseek int{bits} 2048->10944 M=4: M tile "
            f"{pl.mt}, {pl.splits} splits of {pl.rows} rows, {pl.blocks} "
            f"blocks, {sw.smem_bytes(pl, 4, bits, 128)} B shared memory")
        del wg, wu
        check_stacks(checks, gen, device, bits, E, C,
                     (("gate/up", d, fe, 128), ("down", fe, d, 88)),
                     tag="deepseek ")
    torch.cuda.empty_cache()

    # ---- timings, INT4, batch 4 (M = 4) ---------------------------------
    M = 4
    w_down = packed(10944, d, 114)
    wg, wu = packed(d, 10944, 128), packed(d, 10944, 128)
    xd = torch.randn(M, 10944, generator=gen, device=device)
    x = torch.randn(M, d, generator=gen, device=device)

    def cost(ws_, m, calls=1):
        k, n = ws_[0].orig_shape
        return (sum(w.nbytes_packed() for w in ws_) + 4 * m * (k + n)
                * calls, 2 * m * k * n * len(ws_))
    nb, fl = cost([w_down], M)
    time_calls(timings, "cim_gemv",
               "deepseek layer 0's w_down, 10944 -> 2048, groups of 114, "
               "M = 4", lambda fn: fn(xd, w_down), cim_gemv,
               cim_gemv_plain, nb, fl, key="cim_gemv deepseek w_down g114")
    nb, fl = cost([wg, wu], M)
    time_calls(timings, "swiglu_qgemv",
               "deepseek layer 0's gate/up, 2048 -> 10944 (85.5 column "
               "tiles), M = 4", lambda fn: fn(x, wg, wu), swiglu_qgemv,
               swiglu_plain, nb, fl, key="swiglu_qgemv deepseek 10944")
    del w_down, wg, wu, xd
    layers = [{nm: packed(k, n, 128) for nm, (k, n, _) in ws.items()
               if nm in ("wq", "w_dkv", "wo")} for _ in range(L)]
    nb = fl = 0
    for lw in layers:
        for w in lw.values():
            b_, f_ = cost([w], M)
            nb, fl = nb + b_, fl + f_

    def proj_step(fn):
        for lw in layers:
            fn(x, lw["wq"])
            fn(x, lw["w_dkv"])
            fn(x, lw["wo"])
    time_calls(timings, "cim_gemv",
               f"deepseek MLA projections of a decode step, {L} layers x "
               "(wq 2048->3072, w_dkv 2048->576, wo), M = 4", proj_step,
               cim_gemv, cim_gemv_plain, nb, fl,
               key="cim_gemv deepseek mla projections")
    del layers
    stacks = [{nm: random_stack(gen, device, 4, E, k, n, g)
               for nm, (k, n, g) in (("we_gate", (d, fe, 128)),
                                     ("we_up", (d, fe, 128)),
                                     ("we_down", (fe, d, 88)))}
              for _ in range(L - 1)]
    counts = [route_counts(gen, device, E, C, 4, top_k)
              for _ in range(L - 1)]
    xs = torch.randn(E, C, d, generator=gen, device=device)
    hs = torch.randn(E, C, fe, generator=gen, device=device)

    def stack_step(fn):
        for lw, c in zip(stacks, counts):
            fn(xs, lw["we_gate"], c)
            fn(xs, lw["we_up"], c)
            fn(hs, lw["we_down"], c)
    nb = fl = 0
    for lw, c in zip(stacks, counts):
        cb, cf = stack_cost([lw["we_gate"], lw["we_up"], lw["we_down"]],
                            c.tolist())
        nb, fl = nb + cb, fl + cf
    active = [int((c > 0).sum()) for c in counts]
    time_calls(timings, "cim_gemv",
               f"deepseek expert stacks of a decode step, {L - 1} layers x "
               f"3 calls, INT4, E={E} C={C}, experts with rows per layer "
               f"{active}", stack_step, lambda x_, w, c: cim_gemv(x_, w, c),
               lambda x_, w, c: cim_gemv_plain(x_, w), nb, fl,
               key="cim_gemv deepseek stack decode")
    del stacks, xs, hs
    torch.cuda.empty_cache()
    return timings


def mla_attention_cost(model, params, b: int, s: int, lens):
    """(bytes, flops) of the MLA attention of one batch-b step of width s
    over every layer, lanes at `lens` keys before it: the latent rows
    (bf16) each lane's queries see, the packed w_uk and w_uv, q in and
    the output out (f32); 2 flops per multiply-add of the four products
    (q_nope W_uk, the latent and RoPE scores, the latent sum, W_uv)."""
    cfg = model.cfg
    m, H = cfg.mla, cfg.n_heads
    r, rd, nope, vd = (m.kv_lora_rank, m.qk_rope_head_dim,
                       m.qk_nope_head_dim, m.v_head_dim)
    M = b * s
    rows = sum(n + s for n in lens)
    keys = sum(n + j + 1 for n in lens for j in range(s))
    weights = sum(params[name]["attn"][k][i].nbytes_packed()
                  for name, n in (("first_blocks", model.n_first),
                                  ("blocks", cfg.n_layers - model.n_first))
                  for i in range(n) for k in ("w_uk", "w_uv"))
    per_layer = (rows * (r + rd) * 2 + M * H * (nope + rd + vd) * 4,
                 2 * M * H * nope * r + 2 * keys * H * (r + rd)
                 + 2 * keys * H * r + 2 * M * H * r * vd)
    return (weights + cfg.n_layers * per_layer[0],
            cfg.n_layers * per_layer[1])


def time_mla_attention(model, params, eng, device, s: int, lens: int = 64):
    """Device ms of the MLA attention (`attention.mla_attend`: the latent
    gather, the dequantized w_uk / w_uv, the four products, softmax) of
    every layer for one batch-4 step of width s on the engine's pools,
    lanes at `lens` keys, as a CUDA-graph replay and eagerly, beside its
    bound, and of its dequantization of w_uk / w_uv alone (a graph of
    those calls).  The profiled step counts these kernels as glue."""
    import torch
    from repro_torch.models.attention import mla_attend
    from repro_torch.quant.qarray import maybe_dequantize
    cfg = model.cfg
    m, H = cfg.mla, cfg.n_heads
    b, mp = eng.max_batch, eng.cache.max_pages
    gen = torch.Generator(device=device).manual_seed(47)
    q_nope = torch.randn(b, s, H, m.qk_nope_head_dim, generator=gen,
                         device=device)
    q_rope = torch.randn(b, s, H, m.qk_rope_head_dim, generator=gen,
                         device=device)
    tables = torch.arange(b * mp, dtype=torch.int32,
                          device=device).reshape(b, mp)
    slots = lens + torch.arange(s, device=device)[None].expand(b, s)
    total = torch.full((b,), lens + s, dtype=torch.int32, device=device)
    layers = [(lp["attn"], {k: v[i] for k, v in
                            eng.cache.pools[pool].items()})
              for name, pool in (("first_blocks", "attn_first"),
                                 ("blocks", "attn"))
              for i, lp in enumerate(model._layer_params(params, name))]

    def step():
        for lp, cache in layers:
            mla_attend(lp, cfg, q_nope, q_rope, cache, tables, slots, total,
                       torch.float32)

    def dequantize():
        for lp, _ in layers:
            maybe_dequantize(lp["w_uk"])
            maybe_dequantize(lp["w_uv"])
    ms = graph_time_ms(step)
    eager_ms = cuda_time_ms(step, iters=5)
    deq_ms = graph_time_ms(dequantize)
    nb, fl = mla_attention_cost(model, params, b, s, [lens] * b)
    b_ms, b_by = bound(nb, fl)
    log(f"time mla attention {DS_ARCH} {len(layers)} layers, batch {b}, "
        f"s={s}, lanes at {lens} keys, {mp * eng.cache.page_size} keys "
        f"gathered a lane: {ms:.4f} ms (graph replay; eager {eager_ms:.4f} "
        f"ms), of which dequantizing w_uk / w_uv alone {deq_ms:.4f} ms; "
        f"bound {b_ms:.4f} ms ({b_by}: {nb / 1e6:.2f} MB, "
        f"{fl / 1e9:.3f} GFLOP), bound share {100 * b_ms / ms:.2f} %")
    return {"device_ms": ms, "eager_ms": eager_ms, "dequantize_ms": deq_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
            "bytes": nb, "flops": fl}


def phase_moe_serving(device, arch: str, n_layers: int, groups, seed: int,
                      decode_gemvs=None):
    """`arch`, a MoE model, at full width and `n_layers` layers (INT4
    weights drawn from seed 0 on the card, packed in the `groups` given:
    {name: (path in the parameter tree, group)}; kv_dtype "auto": INT8
    pools, or MLA's bf16 latent pools) served by PagedServeEngine as CUDA
    graphs and eagerly: a wave of 4 requests, streams compared, launches
    equal to per-call counts x calls (`decode_gemvs`: the cim_gemv and
    swiglu_qgemv calls a decode step must make), the experts kept and
    slots dropped of the eager run; n-gram speculation (k = 4) against
    no speculation; a profiled decode and verify step split by kernel
    beside its bound, the stacks' bytes those of the experts the step's
    router kept, and for MLA the attention of every layer timed on its
    own (plain PyTorch, counted as glue in the profile); peak memory
    while drawing and resident."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import build_model
    from repro_torch.serve import PagedServeEngine, ServeConfig, ServeRequest
    from repro_torch.spec import SpecConfig

    cfg = get_config(arch).replace(dtype="float32", remat=False,
                                   n_layers=n_layers)
    mla = cfg.attn_kind == "mla"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params = build_model(cfg, "int4", 128, device, seed=0)
    torch.cuda.synchronize()
    draw_peak = torch.cuda.max_memory_allocated() / 1e9
    resident = torch.cuda.memory_allocated() / 1e9
    got = {}
    for name, (path, _) in groups.items():
        leaf = params
        for key in path:
            leaf = leaf[key]
        got[name] = leaf.group
    ffn = params["blocks"]["ffn"]
    log(f"{arch} x{n_layers} layers, full width: INT4 weights drawn and "
        f"packed on the card in {time.perf_counter() - t0:.1f} s, "
        f"{resident:.2f} GB resident (peak {draw_peak:.2f} GB while "
        f"drawing); groups {got}; stacks {tuple(ffn['we_gate'].data.shape)}"
        f" / {tuple(ffn['we_down'].data.shape)}")
    if got != {name: g for name, (_, g) in groups.items()}:
        fail(f"{arch}: packed in groups {got}")
    V, n_new = cfg.vocab, 16
    rng = np.random.default_rng(seed)
    wave = [rng.integers(0, V, int(n)).astype(np.int32)
            for n in rng.integers(16, 65, size=4)]
    serve_cfg = ServeConfig(precision="int4", kv_dtype="auto", max_batch=4,
                            max_seq=128, page_size=16, prefill_chunk=16)
    kv = torch.bfloat16 if mla else torch.int8
    per_step = step_launches(cfg, 1)
    if decode_gemvs is not None and (per_step["cim_gemv"],
                                     per_step["swiglu_qgemv"]) \
            != decode_gemvs:
        fail(f"{arch}: {per_step} launches a decode step, expected "
             f"{decode_gemvs} cim_gemv / swiglu_qgemv calls")
    used = [k for k, v in per_step.items() if v]

    def serve(eager):
        eng = PagedServeEngine(model, params, serve_cfg, device=device,
                               eager=eager)
        if eng.config.resolved_kv_dtype() != kv:
            fail(f"{arch}: kv_dtype auto resolved to "
                 f"{eng.config.resolved_kv_dtype()}, expected {kv}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t_run = time.perf_counter()
        if eager:
            with RouteLog() as rl:
                reqs, ms, m = run_wave(eng, wave, n_new, 0)
            routes = rl.summary(serve_cfg.max_batch)
        else:
            reqs, ms, m = run_wave(eng, wave, n_new, 0)
            routes = None
        run_s = time.perf_counter() - t_run
        counts = launch_counts()
        mode = "eager" if eager else "graph"
        n_tok = sum(len(r.out_tokens) for r in reqs)
        if n_tok != 4 * n_new or not all(
                r.done and all(0 <= t < V for t in r.out_tokens)
                for r in reqs):
            fail(f"{arch} ({mode}): {n_tok} tokens, expected "
                 f"{4 * n_new} in range")
        expect = expected_launches(cfg, eng.prefill_calls, eng.decode_calls)
        log(f"{arch} ({mode}): prompts {[len(r.prompt) for r in reqs]},"
            f" {n_tok} tokens in {run_s:.2f} s; {eng.prefill_calls} "
            f"prefill + {eng.decode_calls} decode calls; decode step wall "
            f"median {float(np.median(ms)):.3f} ms; launches {counts}, "
            f"expected {expect}")
        if counts != expect or min(counts[k] for k in used) <= 0:
            fail(f"{arch} ({mode}): launches {counts} != {expect}")
        if routes is not None:
            log(f"{arch} routing (eager run, every MoE layer call): "
                + json.dumps(routes))
        return dict(eng=eng, reqs=reqs, counts=counts, run_s=run_s,
                    decode_ms=float(np.median(ms)),
                    ttft_ms=m["ttft_p50_s"] * 1e3, routes=routes,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    t_phase = time.perf_counter()
    graph, eager = serve(False), serve(True)
    eng = graph["eng"]
    check_identity(f"graphs vs eager ({arch})", eager["reqs"],
                   graph["reqs"], model, params, device)
    name = f"{cfg.name}.serve_step"
    graphs = check_graphs(arch, eng, {
        (name, (4, 16)): step_launches(cfg, 16),
        (name, (4, 1)): per_step}, [(name, (4, 16)), (name, (4, 1))])
    replay_ms = replay_check(f"{arch} decode", eng, model.serve_step,
                             (4, 1))
    result = {"n_layers": n_layers, "launches": graph["counts"],
              "graphs": graphs, "decode_replay_device_ms": replay_ms,
              "decode_busy_share": replay_ms / graph["decode_ms"],
              "launches_per_decode_step": per_step,
              "routing_eager_run": eager["routes"],
              "draw_peak_gb": draw_peak, "resident_gb": resident}
    for mode, run in (("graph", graph), ("eager", eager)):
        result[mode] = {"decode_step_ms_median": run["decode_ms"],
                        "ttft_p50_ms": run["ttft_ms"],
                        "max_memory_allocated_gb": run["peak_gb"],
                        "run_s": run["run_s"]}
    log(f"{arch} decode step: wall median {graph['decode_ms']:.3f} ms "
        f"as graphs (eager {eager['decode_ms']:.3f}), replay {replay_ms:.3f}"
        f" ms on the device, busy {100 * replay_ms / graph['decode_ms']:.1f}"
        f" %; peak {graph['peak_gb']:.2f} GB serving")
    glue = " (MLA attention in the glue)" if mla else ""
    counts = step_route_counts(model, params, eng, 1)
    _, modes = profile_step(model, params, eng, device)
    result["decode_step_experts_kept"] = [sum(c > 0 for c in cc)
                                          for cc in counts]
    result["decode_step_split"] = log_step_split(
        f"{arch} decode step, batch 4, lanes at 64 keys, experts with "
        f"rows per layer {result['decode_step_experts_kept']}, by kernel"
        + glue, modes, step_bounds(model, params, 4, 1, [64] * 4, counts),
        False, per_step)
    if mla:
        result["decode_step_mla_attention"] = time_mla_attention(
            model, params, eng, device, 1)
    del eager
    eng = None
    graph["eng"] = None

    # n-gram speculation on motif prompts against the same prompts
    # without it
    motif = rng.integers(0, V, 8).astype(np.int32)
    prompts = [np.tile(motif, 8)[:int(n)]
               for n in rng.integers(32, 65, size=4)]

    def spec_serve(spec):
        e = PagedServeEngine(model, params, serve_cfg, spec=spec,
                             device=device)
        reqs = [ServeRequest(prompt=p.copy(), max_new_tokens=24, rid=i)
                for i, p in enumerate(prompts)]
        reset_launch_counts()
        steps = serve_timed(e, reqs)
        counts = launch_counts()
        expect = expected_launches(cfg, e.prefill_calls, e.decode_calls,
                                   e.verify_calls)
        label = f"{arch} " + ("spec ngram k=4" if spec else "no spec")
        ver = [ms for ms, v in steps if v]
        log(f"{label}: {e.prefill_calls} prefill + {e.decode_calls} decode "
            f"+ {e.verify_calls} verify calls; launches {counts}, expected "
            f"{expect}; verify step wall median "
            f"{float(np.median(ver)) if ver else float('nan'):.3f} ms over "
            f"{len(ver)} steps; acceptance "
            f"{e.summary().get('spec_acceptance_rate')}")
        if counts != expect or sum(len(r.out_tokens) for r in reqs) != 96:
            fail(f"{label}: launches {counts} != {expect}, or tokens short")
        if spec is not None and e.verify_calls <= 0:
            fail(f"{label}: no verify call")
        return e, reqs, counts, (float(np.median(ver)) if ver else None)

    _, base, _, _ = spec_serve(None)
    s_eng, s_reqs, s_counts, s_ms = spec_serve(SpecConfig(k=4))
    check_identity(f"{arch} spec ngram", base, s_reqs, model, params,
                   device)
    verify = (f"{cfg.name}.paged_verify_step", (4, 5))
    check_graphs(f"{arch} spec ngram", s_eng, {
        (name, (4, 16)): step_launches(cfg, 16),
        (name, (4, 1)): per_step,
        verify: step_launches(cfg, 5, verify=True)}, [(name, (4, 16)),
                                                      verify])
    v_replay = replay_check(f"{arch} spec verify", s_eng,
                            model.paged_verify_step, (4, 5))
    v_counts = step_route_counts(model, params, s_eng, 5)
    _, modes = profile_step(model, params, s_eng, device, s=5)
    kept = [sum(c > 0 for c in cc) for cc in v_counts]
    result["spec_ngram"] = {
        "launches": s_counts, "verify_calls": s_eng.verify_calls,
        "verify_step_ms_median": s_ms, "verify_replay_device_ms": v_replay,
        "acceptance_rate": s_eng.summary().get("spec_acceptance_rate"),
        "verify_step_experts_kept": kept,
        "verify_step_split": log_step_split(
            f"{arch} verify step, batch 4, s=5, lanes at 64 keys, experts "
            f"with rows per layer {kept}, by kernel" + glue, modes,
            step_bounds(model, params, 4, 5, [64] * 4, v_counts), True,
            step_launches(cfg, 5, verify=True))}
    if mla:
        result["spec_ngram"]["verify_step_mla_attention"] = \
            time_mla_attention(model, params, s_eng, device, 5)
    result["phase_s"] = time.perf_counter() - t_phase
    del s_eng, model, params
    torch.cuda.empty_cache()
    log(f"{arch} result " + json.dumps(result))
    return graph["counts"], s_counts, result


# ---------------------------------------------------------------------------
# the recurrent and hybrid families: xlstm-1.3b and zamba2-7b
# ---------------------------------------------------------------------------
XLSTM_ARCH, ZAMBA_ARCH = "xlstm-1.3b", "zamba2-7b"


def recurrent_step_launches(cfg, s: int, packed: bool = True):
    """Kernel launches of one serve_step call of xlstm or zamba, at any
    width s (the cells run their projections over the whole chunk):
    xlstm's mLSTM layers up_proj, w_o, down_proj and three head-wise
    stack calls (q/k/v), its sLSTM layers ffn_up and ffn_down (w_gates
    and r_gates are float); zamba's Mamba2 layers in_proj and out_proj,
    each shared-block invocation q/k/v/o, the LoRA out_proj and w_down on
    cim_gemv, gate/up on swiglu_qgemv and, in a decode step, its
    attention on paged_flash_decode; the head."""
    L = cfg.n_layers
    if cfg.family == "xlstm":
        groups = L // cfg.ssm.slstm_every
        cim, sw, attn = 6 * (L - groups) + 2 * groups + 1, 0, 0
    else:
        groups = L // cfg.zamba.shared_every
        cim, sw, attn = 2 * L + 6 * groups + 1, groups, groups
    return {"cim_gemv": cim if packed else 0,
            "swiglu_qgemv": sw if packed else 0,
            "paged_flash_decode": attn if s == 1 else 0,
            "paged_flash_verify": 0, "flash_decode": 0}


def float_pools(gen, device, dtype, b, max_pages, g, hd, ps=16):
    """One layer's f32 or bf16 K/V pools and shuffled tables, as
    `int8_pools` returns them (no scales)."""
    import torch
    n_pages = b * max_pages
    k, v = (torch.randn(n_pages, ps, g, hd, generator=gen, device=device
                        ).to(dtype) for _ in range(2))
    tables = torch.randperm(n_pages, generator=gen, device=device
                            ).reshape(b, max_pages).int()
    return k, v, None, None, tables


def phase_recurrent_kernels(device, checks: Checks):
    """The kernels at xlstm-1.3b's and zamba2-7b's shapes against their
    plain versions, every call twice (bitwise equal): cim_gemv on xlstm's
    up_proj (2048 -> 8192), w_o (4096^2), down_proj, ffn_up (2048 ->
    5460), ffn_down (2730 -> 2048 in odd groups of 105) and head (2048
    -> 50304), the mLSTM's head-wise q/k/v as a 4-expert stack (1024 ->
    1024, groups of 64, every row counted), zamba's in_proj (3584 ->
    14576), out_proj (7168 -> 3584), q/k/v/o and the LoRA out_proj
    (3584^2, groups of 112), w_down and head (3584 -> 32000), at M = 1,
    4 and 64; swiglu_qgemv at 3584 -> 14336 in groups of 112;
    paged_flash_decode at hd 112, one query head per kv head, 32 kv
    heads, on INT8, bf16 and f32 pools, at its split boundaries, length
    1 and 0, and batch 1 over 4096 keys.  Then the 4 attention calls and
    the 4 swiglu_qgemv calls of a zamba decode step (batch 4), the 4
    attention calls at batch 1 over 4096 keys, and the 126 head-wise
    stack calls of an xlstm decode step, each beside its bound.
    Returns the timings."""
    import torch
    from repro_torch.kernels.cim_gemv import (cim_gemv, cim_gemv_plain,
                                              smem_bytes, split_plan,
                                              stack_plan)
    from repro_torch.kernels.paged_flash_decode import (decode_plan,
                                                        paged_decode_plain,
                                                        paged_flash_decode)
    from repro_torch.kernels.split_decode import sm_count
    from repro_torch.kernels.swiglu_gemv import swiglu_plain, swiglu_qgemv
    from repro_torch.quant.qarray import quantize

    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(53)
    sms = sm_count(device)

    def packed(k, n, group, bits=4):
        return quantize(torch.randn(k, n, generator=gen, device=device)
                        * 0.02, bits, group)
    shapes = {"xlstm up_proj": (2048, 8192, 128),
              "xlstm w_o": (4096, 4096, 128),
              "xlstm down_proj": (4096, 2048, 128),
              "xlstm ffn_up": (2048, 5460, 128),
              "xlstm ffn_down": (2730, 2048, 105),
              "xlstm head": (2048, 50304, 128),
              "zamba in_proj": (3584, 14576, 112),
              "zamba out_proj": (7168, 3584, 112),
              "zamba q/k/v/o lora_out": (3584, 3584, 112),
              "zamba w_down": (14336, 3584, 128),
              "zamba head": (3584, 32000, 112)}
    for name, (k, n, group) in shapes.items():
        w = packed(k, n, group)
        for m in (1, 4, 64):
            x = torch.randn(m, k, generator=gen, device=device)
            label = f"{name} {k}->{n} g{group} M={m}"
            out = cim_gemv(x, w)
            checks.compare("cim_gemv", label, out, cim_gemv_plain(x, w))
            checks.repeat("cim_gemv", label, out, cim_gemv(x, w))
        if name in ("xlstm ffn_down", "zamba in_proj", "zamba out_proj"):
            pl = split_plan("cols", 4, w.data.shape[0], n, 4, sms)
            log(f"plan cim_gemv {name} g{group} M=4: M tile {pl.mt}, "
                f"{pl.splits} splits of {pl.rows} rows, {pl.blocks} "
                f"blocks, {smem_bytes('cols', pl, 4, k, 4, group)} B "
                "shared memory")
        del w
    stack = quantize(torch.randn(4, 1024, 1024, generator=gen,
                                 device=device) * 0.02, 4, 64, axis=1)
    for m in (1, 4, 64):
        x = torch.randn(4, m, 1024, generator=gen, device=device)
        counts = torch.full((4,), m, dtype=torch.int32, device=device)
        label = f"xlstm mLSTM q/k/v stack 4 x 1024->1024 g64 rows={m}"
        out = cim_gemv(x, stack, counts)
        checks.compare("cim_gemv", label, out, cim_gemv_plain(x, stack))
        checks.repeat("cim_gemv", label, out, cim_gemv(x, stack, counts))
    pl = stack_plan(4, 512, 1024, 4, 4, sms)
    log(f"plan cim_gemv mLSTM q/k/v stack rows=4: M tile {pl.mt}, "
        f"{pl.splits} splits of {pl.rows} rows, {pl.blocks} blocks an "
        "expert")
    wg, wu = packed(3584, 14336, 112), packed(3584, 14336, 112)
    for m in (1, 4, 64):
        x = torch.randn(m, 3584, generator=gen, device=device)
        label = f"zamba shared gate/up 3584->14336 g112 M={m}"
        out = swiglu_qgemv(x, wg, wu)
        checks.compare("swiglu_qgemv", label, out, swiglu_plain(x, wg, wu))
        checks.repeat("swiglu_qgemv", label, out, swiglu_qgemv(x, wg, wu))

    g, hd, ps = 32, 112, 16
    for pool in ("int8", "bf16", "f32"):
        for b, max_pages in ((4, 64), (1, 256)):
            kp, vp, ks, vs, tables = (
                int8_pools(gen, device, b, max_pages, g, hd) if pool == "int8"
                else float_pools(gen, device, {"bf16": torch.bfloat16,
                                               "f32": torch.float32}[pool],
                                 b, max_pages, g, hd))
            q = torch.randn(b, g, 1, hd, generator=gen, device=device)
            if b == 4:
                _, chunk = decode_plan(b, g, max_pages, ps, sms, 1)
                lens = [chunk, chunk + 1, 1, 0]
            else:
                lens = [max_pages * ps]
            lengths = torch.tensor(lens, dtype=torch.int32, device=device)
            args = (q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
            label = f"hd 112 qpk 1 g 32 {pool} lengths {lens}"
            out = paged_flash_decode(*args)
            checks.compare("paged_flash_decode", label, out,
                           paged_decode_plain(*args))
            checks.repeat("paged_flash_decode", label, out,
                          paged_flash_decode(*args))
    del kp, vp, ks, vs

    # ---- timings: batch 4 ----------------------------------------------
    timings = {}
    L, b = 4, 4
    for b, max_pages, lens in ((4, 64, [1024, 777, 301, 45]),
                               (1, 256, [4096])):
        pools = [int8_pools(gen, device, b, max_pages, g, hd)
                 for _ in range(L)]
        q = torch.randn(b, g, 1, hd, generator=gen, device=device)
        lengths = torch.tensor(lens, dtype=torch.int32, device=device)

        def pd_step(fn, pools=pools, q=q, lengths=lengths):
            for kp, vp, ks, vs, tables in pools:
                fn(q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
        tokens = sum(lens)
        n_split, chunk = decode_plan(b, g, max_pages, ps, sms, 1)
        log(f"plan paged_flash_decode hd 112 qpk 1 b={b} g={g} max_pages="
            f"{max_pages}: n_split {n_split}, chunk {chunk} keys")
        time_calls(timings, "paged_flash_decode",
                   f"zamba2-7b decode attention, {L} calls, batch {b}, g=32 "
                   f"qpk=1 hd=112, INT8, lengths {lens}", pd_step,
                   paged_flash_decode, paged_decode_plain,
                   L * (tokens * g * (2 * hd + 4) + 2 * q.numel() * 4
                        + b * (max_pages + 1) * 4),
                   L * tokens * g * hd * 4,
                   key=f"paged_flash_decode hd112 batch {b}")
        del pools
    M = 4
    x = torch.randn(M, 3584, generator=gen, device=device)

    def sw_step(fn):
        for _ in range(4):       # the one shared MLP, invoked 4 times
            fn(x, wg, wu)
    time_calls(timings, "swiglu_qgemv",
               "zamba2-7b shared gate/up of a decode step, 4 calls of "
               "3584 -> 14336 (groups of 112), M = 4", sw_step,
               swiglu_qgemv, swiglu_plain,
               4 * (wg.nbytes_packed() + wu.nbytes_packed()
                    + 4 * M * (3584 + 14336)),
               4 * 2 * 2 * M * 3584 * 14336, key="swiglu_qgemv zamba")
    del wg, wu
    stacks = [quantize(torch.randn(4, 1024, 1024, generator=gen,
                                   device=device) * 0.02, 4, 64, axis=1)
              for _ in range(42 * 3)]
    xs = torch.randn(4, M, 1024, generator=gen, device=device)
    counts = torch.full((4,), M, dtype=torch.int32, device=device)

    def st_step(fn):
        for w in stacks:
            fn(xs, w, counts)
    time_calls(timings, "cim_gemv",
               "xlstm-1.3b head-wise q/k/v of a decode step, 42 layers x 3 "
               "stack calls of 4 heads x 1024 -> 1024 (groups of 64), 4 "
               "rows", st_step, lambda x_, w, c: cim_gemv(x_, w, c),
               lambda x_, w, c: cim_gemv_plain(x_, w),
               sum(w.nbytes_packed() for w in stacks)
               + len(stacks) * 4 * 4 * M * 2048,
               len(stacks) * 4 * 2 * M * 1024 * 1024,
               key="cim_gemv xlstm head-wise stacks")
    del stacks
    torch.cuda.empty_cache()
    log(f"xlstm / zamba kernel checks and timings in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return timings


def recurrent_step_bounds(model, params, b: int, lens):
    """{kernel: (bytes, flops)} of one batch-b decode step of xlstm or
    zamba, lanes at `lens` keys before it (zamba's attention), and the
    whole step's: each packed weight and scale read once a use (zamba's
    shared block is read again by each of its invocations), each call's
    activations in and out; the float leaves the step reads (the
    sLSTM's w_gates / r_gates, norms, convs, LoRA factors); the arena
    read and written once; the logits out."""
    from repro_torch.quant.qarray import QTensor
    cfg = model.cfg
    M = b
    cost = {"cim_gemv": [0, 0], "swiglu_qgemv": [0, 0],
            "paged_flash_decode": [0, 0]}
    floats = [0]

    def use(leaf, times=1):
        if not isinstance(leaf, QTensor):
            floats[0] += times * leaf.numel() * leaf.element_size()
            return
        e = leaf.data.shape[0] if leaf.data.ndim == 3 else 1
        k, n = leaf.orig_shape[-2:]
        cost["cim_gemv"][0] += times * (leaf.nbytes_packed()
                                        + 4 * e * M * (k + n))
        cost["cim_gemv"][1] += times * 2 * e * M * k * n

    def layers(tree, depth):
        views = [tree]
        for _ in range(depth):
            views = [_take_layer(v, i) for v in views
                     for i in range(_lead_dim(v))]
        return views

    def walk(tree, times=1):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v, times)
        else:
            use(tree, times)
    for name, depth in (("mlstm", 2), ("slstm", 1), ("mamba", 2),
                        ("mamba_tail", 1), ("lora", 1)):
        if name in params:
            for layer in layers(params[name], depth):
                walk(layer)
    walk({k: v for k, v in params.items()
          if k not in ("mlstm", "slstm", "mamba", "mamba_tail", "lora",
                       "embed", "shared")})
    n_groups = model.n_paged_layers()
    if n_groups:
        shared = params["shared"]
        walk({k: v for k, v in shared.items() if k != "ffn"}, n_groups)
        walk(shared["ffn"]["w_down"], n_groups)
        wg, wu = shared["ffn"]["w_gate"], shared["ffn"]["w_up"]
        k, n = wg.orig_shape
        cost["swiglu_qgemv"] = [
            n_groups * (wg.nbytes_packed() + wu.nbytes_packed()
                        + 4 * M * (k + n)), n_groups * 4 * M * k * n]
        scfg = model.cfg.replace(d_ff=cfg.zamba.shared_d_ff)
        g, hd = scfg.n_kv_heads, scfg.hd()
        rows = sum(n_len + 1 for n_len in lens)
        cost["paged_flash_decode"] = [
            n_groups * (rows * g * (2 * hd + 4) + 2 * M * g * hd * 4),
            n_groups * rows * g * hd * 4]
    arena = sum(leaf.numel() * leaf.element_size()
                for leaf in _tensors(model.arena_state_specs(b)))
    total = (sum(v[0] for v in cost.values()) + floats[0] + 2 * arena
             + 4 * M * cfg.vocab)
    return ({k: tuple(v) for k, v in cost.items() if v[0]},
            {"bytes": total, "packed_and_activations": sum(
                v[0] for v in cost.values()), "float_leaves": floats[0],
             "arena": arena, "flops": sum(v[1] for v in cost.values())})


def _lead_dim(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _take_layer(tree, i):
    if isinstance(tree, dict):
        return {k: _take_layer(v, i) for k, v in tree.items()}
    return tree[i]


def _tensors(specs):
    """Stand-ins with numel() / element_size() for a ParamSpec tree."""
    import math as _m

    import torch

    class _Leaf:
        def __init__(self, sp):
            self.n = _m.prod(sp.shape)
            self.e = torch.empty(0, dtype=sp.dtype).element_size()

        def numel(self):
            return self.n

        def element_size(self):
            return self.e
    out = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            out.append(_Leaf(t))
    walk(specs)
    return out


def phase_recurrent_serving(device, arch: str, n_layers: int, seed: int,
                            groups, decode_launches):
    """`arch` (xlstm-1.3b or zamba2-7b) at full width and `n_layers`
    layers (INT4 weights drawn from seed 0 on the card, packed in the
    `groups` given; INT8 pools for zamba's shared attention) served by
    PagedServeEngine: a wave of 4 requests as CUDA graphs and eagerly,
    streams compared, launches equal to per-call counts x calls
    (`decode_launches`: (cim_gemv, swiglu_qgemv, paged_flash_decode) of
    a decode step), graphs captured once, two replays from the same
    arena state bitwise equal; the same wave in a pool too small for it
    (pure recurrent: preempted lanes snapshot their arena slot to the
    host and resume from it, each copy timed; hybrid: they re-prefill),
    streams equal to the unpreempted run; the spec, prefix-cache and
    fork refusals with JAX's wording; a profiled decode step by kernel
    beside each bound and the whole step's bound (weights, the arena
    read and written); peak memory while drawing and resident."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import build_model
    from repro_torch.serve import PagedServeEngine, ServeConfig, ServeRequest
    from repro_torch.serve.engine import capability_error
    from repro_torch.spec import SpecConfig

    t_phase = time.perf_counter()
    cfg = get_config(arch).replace(dtype="float32", remat=False,
                                   n_layers=n_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params = build_model(cfg, "int4", 128, device, seed=0)
    torch.cuda.synchronize()
    draw_peak = torch.cuda.max_memory_allocated() / 1e9
    resident = torch.cuda.memory_allocated() / 1e9
    got = {}
    for name, (path, _) in groups.items():
        leaf = params
        for key in path:
            leaf = leaf[key]
        got[name] = leaf.group
    log(f"{arch} x{n_layers} layers, full width: INT4 weights drawn and "
        f"packed on the card in {time.perf_counter() - t0:.1f} s, "
        f"{resident:.2f} GB resident (peak {draw_peak:.2f} GB while "
        f"drawing); groups {got}; groups, layers a group, tail "
        f"{model._groups()}")
    if got != {name: g for name, (_, g) in groups.items()}:
        fail(f"{arch}: packed in groups {got}")
    per_step = step_launches(cfg, 1)
    if (per_step["cim_gemv"], per_step["swiglu_qgemv"],
            per_step["paged_flash_decode"]) != decode_launches:
        fail(f"{arch}: {per_step} launches a decode step, expected "
             f"{decode_launches}")
    used = [k for k, v in per_step.items() if v]
    V, n_new = cfg.vocab, 16
    rng = np.random.default_rng(seed)
    wave = [rng.integers(0, V, int(n)).astype(np.int32)
            for n in rng.integers(16, 65, size=4)]
    serve_cfg = ServeConfig(precision="int4", kv_dtype="auto", max_batch=4,
                            max_seq=128, page_size=16, prefill_chunk=16)

    def serve(eager, n_pages=None):
        eng = PagedServeEngine(model, params, dataclasses.replace(
            serve_cfg, n_pages=n_pages), device=device, eager=eager)
        if eng.prefix is not None or eng.arena is None:
            fail(f"{arch}: prefix cache {eng.prefix}, arena {eng.arena}")
        ptrs = [leaf.data_ptr() for _, leaf, _ in eng.arena._leaves()]
        copies = {"save": [], "restore": []}
        for op in copies:
            orig = getattr(eng.arena, f"{op}_lane")

            def timed(*a, orig=orig, op=op):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = orig(*a)
                torch.cuda.synchronize()
                copies[op].append((time.perf_counter() - t) * 1e3)
                return out
            setattr(eng.arena, f"{op}_lane", timed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t_run = time.perf_counter()
        reqs, ms, m = run_wave(eng, wave, n_new, 0)
        run_s = time.perf_counter() - t_run
        for op in copies:           # the timed wrappers out again: they
            delattr(eng.arena, f"{op}_lane")  # close a cycle over the arena
        counts = launch_counts()
        mode = ("eager" if eager else "graph") + (
            f", {n_pages} pages" if n_pages else "")
        n_tok = sum(len(r.out_tokens) for r in reqs)
        if n_tok != 4 * n_new or not all(
                r.done and all(0 <= t < V for t in r.out_tokens)
                for r in reqs):
            fail(f"{arch} ({mode}): {n_tok} tokens, expected "
                 f"{4 * n_new} in range")
        expect = expected_launches(cfg, eng.prefill_calls, eng.decode_calls)
        preempts = sum(e["kind"] == "preempt"
                       for e in eng.recorder.snapshot())
        log(f"{arch} ({mode}): prompts {[len(r.prompt) for r in reqs]}, "
            f"{n_tok} tokens in {run_s:.2f} s; {eng.prefill_calls} prefill "
            f"+ {eng.decode_calls} decode calls; {preempts} preemptions, "
            f"{len(copies['save'])} snapshots; decode step wall median "
            f"{float(np.median(ms)):.3f} ms; launches {counts}, expected "
            f"{expect}")
        if counts != expect or min(counts[k] for k in used) <= 0:
            fail(f"{arch} ({mode}): launches {counts} != {expect}")
        if [leaf.data_ptr() for _, leaf, _ in eng.arena._leaves()] != ptrs:
            fail(f"{arch} ({mode}): an arena leaf moved")
        return dict(eng=eng, reqs=reqs, counts=counts, run_s=run_s,
                    decode_ms=float(np.median(ms)), preempts=preempts,
                    ttft_ms=m["ttft_p50_s"] * 1e3, copies=copies,
                    state_bytes=m["state_bytes"],
                    occupancy_peak=m["state_slot_occupancy_peak"],
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    graph, eager = serve(False), serve(True)
    eng = graph["eng"]
    check_identity(f"graphs vs eager ({arch})", eager["reqs"],
                   graph["reqs"], model, params, device)
    eager["eng"] = None
    name = f"{cfg.name}.serve_step"
    graphs = check_graphs(arch, eng, {
        (name, (4, 16)): step_launches(cfg, 16),
        (name, (4, 1)): per_step}, [(name, (4, 16)), (name, (4, 1))])
    replay_ms = replay_check(f"{arch} decode", eng, model.serve_step,
                             (4, 1))
    state_bytes = eng.arena.state_bytes()
    if graph["state_bytes"] != state_bytes:
        fail(f"{arch}: summary state_bytes {graph['state_bytes']} != "
             f"{state_bytes}")
    result = {"n_layers": n_layers, "launches": graph["counts"],
              "graphs": graphs, "decode_replay_device_ms": replay_ms,
              "decode_busy_share": replay_ms / graph["decode_ms"],
              "launches_per_decode_step": per_step,
              "state_bytes": state_bytes,
              "state_slot_occupancy_peak": graph["occupancy_peak"],
              "draw_peak_gb": draw_peak, "resident_gb": resident}
    for mode, run in (("graph", graph), ("eager", eager)):
        result[mode] = {"decode_step_ms_median": run["decode_ms"],
                        "ttft_p50_ms": run["ttft_ms"],
                        "max_memory_allocated_gb": run["peak_gb"],
                        "run_s": run["run_s"]}
    log(f"{arch} decode step: wall median {graph['decode_ms']:.3f} ms as "
        f"graphs (eager {eager['decode_ms']:.3f}), replay {replay_ms:.3f} "
        f"ms on the device, busy {100 * replay_ms / graph['decode_ms']:.1f}"
        f" %; arena {state_bytes / 1e9:.4f} GB at 4 lanes; peak "
        f"{graph['peak_gb']:.2f} GB serving")

    _, modes = profile_step(model, params, eng, device)
    bounds, whole = recurrent_step_bounds(model, params, 4, [64] * 4)
    result["decode_step_split"] = log_step_split(
        f"{arch} decode step, batch 4, lanes at 64 keys, by kernel", modes,
        bounds, False, per_step)
    w_ms, w_by = bound(whole["bytes"], whole["flops"])
    replay_dev = sum(modes["graph replay"][0].values()) / 1e3
    result["decode_step_bound"] = dict(whole, bound_ms=w_ms, bound_by=w_by,
                                       profiled_replay_device_ms=replay_dev)
    log(f"{arch} decode step bound: {whole['bytes'] / 1e9:.3f} GB = packed "
        f"weights and activations {whole['packed_and_activations'] / 1e9:.3f}"
        f" + float leaves {whole['float_leaves'] / 1e9:.3f} + the arena "
        f"{whole['arena'] / 1e9:.3f} read and written; {w_ms:.4f} ms "
        f"({w_by}) against {replay_dev:.3f} ms of profiled replay "
        f"({100 * w_ms / replay_dev:.1f} %)")
    del graph["eng"], eng
    torch.cuda.empty_cache()

    # the same wave in a pool too small for it: every lane needs one page
    # more than its prompt, and two pages are spare
    pages = sum(-(-len(p) // 16) for p in wave) + 2
    tight = serve(False, n_pages=pages)
    if tight["preempts"] <= 0:
        fail(f"{arch}: no lane was preempted in {pages} pages")
    pure = model.n_paged_layers() == 0
    if pure != (len(tight["copies"]["save"]) > 0) or (
            not pure and not any(r.prompt_folded for r in tight["reqs"])):
        fail(f"{arch}: {len(tight['copies']['save'])} snapshots with "
             f"{model.n_paged_layers()} paged layers")
    check_identity(f"{arch} preempted ({pages} pages) vs not",
                   graph["reqs"], tight["reqs"], model, params, device)
    snap = tight["copies"]
    result["preemption"] = {
        "n_pages": pages, "preemptions": tight["preempts"],
        "snapshots": len(snap["save"]),
        "snapshot_ms": snap["save"], "restore_ms": snap["restore"],
        "lane_bytes": state_bytes // 4, "decode_step_ms_median":
            tight["decode_ms"], "run_s": tight["run_s"]}
    if snap["save"]:
        log(f"{arch} preemption: {len(snap['save'])} lane snapshots of "
            f"{state_bytes / 4e9:.4f} GB to the host, "
            f"{float(np.median(snap['save'])):.2f} ms median "
            f"({state_bytes / 4 / (np.median(snap['save']) * 1e-3) / 1e9:.2f}"
            f" GB/s); {len(snap['restore'])} restores "
            f"{float(np.median(snap['restore'])):.2f} ms median")
    tight["eng"] = None

    # the capabilities a recurrent model refuses, with JAX's wording
    small = dataclasses.replace(serve_cfg, max_batch=1, max_seq=32)
    refusals = {}
    for cap in ("speculative-decoding", "prefix-cache", "parallel-sampling"):
        try:
            if cap == "speculative-decoding":
                PagedServeEngine(model, params, small, spec=SpecConfig(k=4),
                                 device=device)
            elif cap == "prefix-cache":
                PagedServeEngine(model, params, dataclasses.replace(
                    small, prefix_cache=True), device=device)
            else:
                e = PagedServeEngine(model, params, small, device=device)
                parent = ServeRequest(prompt=wave[0][:8])
                e.submit(parent)
                e.submit(ServeRequest(prompt=wave[0][:8], fork_from=parent))
            fail(f"{arch}: {cap} was not refused")
        except ValueError as err:
            if str(err) != capability_error(model, cap):
                fail(f"{arch}: {cap} refused with {err!r}")
            refusals[cap] = str(err)
    log(f"{arch} refusals: " + "; ".join(refusals.values()))
    result["phase_s"] = time.perf_counter() - t_phase
    del model, params
    torch.cuda.empty_cache()
    log(f"{arch} result " + json.dumps(result))
    return graph["counts"], result


# ---------------------------------------------------------------------------
# cim_gemv at any N, and the xlstm smoke config on the card
# ---------------------------------------------------------------------------
RAGGED_N = (1, 3, 6, 170, 171)


def phase_ragged_kernels(device, checks: Checks) -> None:
    """cim_gemv on weights whose N is not a multiple of 4 (their rows do
    not start on 4-byte boundaries: the byte-copy instantiation; an odd
    N's scale rows not either), INT4 and INT8, the (K/2, N) layout and a
    3-expert stack, M = 1, 4, 20, at K = 2048 (a column tile split over
    several blocks), every call twice (bitwise equal); then the xlstm
    smoke config (its sLSTM ffn_up has 170 columns) served on the card as
    CUDA graphs, its greedy streams against the CPU's on the same
    weights."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.cim_gemv import (cim_gemv, cim_gemv_plain,
                                              split_plan, stack_plan,
                                              vec_bytes)
    from repro_torch.models import DecoderLM, init_params
    from repro_torch.models.common import tree_to
    from repro_torch.quant.ptq import quantize_params
    from repro_torch.quant.qarray import quantize
    from repro_torch.serve import PagedServeEngine, ServeConfig, ServeRequest

    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(61)
    k = 2048
    for bits in (4, 8):
        stored = k // (2 if bits == 4 else 1)
        for n in RAGGED_N:
            w = quantize(torch.randn(k, n, generator=gen, device=device)
                         * 0.02, bits, 128)
            ws = quantize(torch.randn(3, k, n, generator=gen, device=device)
                          * 0.02, bits, 128, axis=1)
            for m in (1, 4, 20):
                plan = split_plan("cols", m, stored, n, bits)
                if plan.splits < 2:
                    fail(f"cim_gemv N={n}: plan {plan} has one split")
                x = torch.randn(m, k, generator=gen, device=device)
                label = (f"N={n} int{bits} M={m} vec "
                         f"{vec_bytes(w, n)} splits {plan.splits}")
                out = cim_gemv(x, w)
                checks.compare("cim_gemv", label, out, cim_gemv_plain(x, w))
                checks.repeat("cim_gemv", label, out, cim_gemv(x, w))
                xs = torch.randn(3, m, k, generator=gen, device=device)
                counts = torch.tensor([m, 0, max(1, m // 2)],
                                      dtype=torch.int32, device=device)
                ref = cim_gemv_plain(xs, ws)
                out = cim_gemv(xs, ws, counts)
                splan = stack_plan(m, stored, n, bits, 3)
                slabel = (f"stack 3x N={n} int{bits} M={m} counts "
                          f"{counts.tolist()} splits {splan.splits}")
                rows = torch.arange(m, device=device)[None, :] \
                    < counts[:, None]
                checks.compare("cim_gemv", slabel, out[rows], ref[rows])
                checks.repeat("cim_gemv", slabel, out[rows],
                              cim_gemv(xs, ws, counts)[rows])
    log(f"cim_gemv at N in {list(RAGGED_N)}: {len(RAGGED_N) * 2 * 3 * 2} "
        f"checks in {time.perf_counter() - t_phase:.1f} s")

    # the xlstm smoke config, whose ffn_up is (K, 170), on the card
    cfg = get_smoke_config(XLSTM_ARCH).replace(dtype="float32", remat=False)
    model = DecoderLM(cfg)
    params = quantize_params(init_params(
        model.param_specs(), torch.Generator().manual_seed(0), "cpu",
        torch.float32), 4, 16)
    ffn_up = params["slstm"]["cell"]["ffn_up"]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in (5, 19, 33)]
    runs = {}
    for dev in ("cpu", device):
        eng = PagedServeEngine(model, tree_to(params, dev), ServeConfig(
            precision="int4", max_batch=4, max_seq=64, page_size=16),
            device=dev)
        reqs = [ServeRequest(prompt=p.copy(), max_new_tokens=8, rid=i)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        runs[str(dev)] = (eng, reqs)
    eng, reqs = runs[str(device)]
    if not eng.runner.graphs or not all(st["captured"]
                                        for st in eng.runner.steps()):
        fail(f"xlstm smoke on the card: steps not captured: "
             f"{eng.runner.steps()}")
    if any(len(r.out_tokens) != 8 for r in reqs):
        fail("xlstm smoke on the card: a request ended early")
    check_identity("xlstm smoke config, card vs CPU", runs["cpu"][1], reqs,
                   model, tree_to(params, device), device)
    log(f"xlstm smoke config ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"ffn_up {tuple(ffn_up.data.shape)} packed, vec "
        f"{vec_bytes(ffn_up[0], ffn_up.data.shape[-1])}) served on the "
        f"card as CUDA graphs: {sum(len(r.out_tokens) for r in reqs)} "
        "tokens")


# ---------------------------------------------------------------------------
# the streaming gateway and fleet router: 2 replicas sharing the card
# ---------------------------------------------------------------------------
class GatewayThread:
    """A `Gateway` serving on its own thread's event loop (the main
    thread's loop checks /metrics and drives the 429), its CPU time read
    per thread."""

    def __init__(self, router, **kw):
        import asyncio
        import threading

        from repro_torch.api import Gateway
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="gateway-loop", daemon=True)
        self.thread.start()
        self.gw = Gateway(router, **kw)
        self.router = router
        self.host, self.port = self.call(self.gw.start())

    def call(self, coro, timeout: float = 600.0):
        import asyncio
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def cpu_s(self) -> float:
        return time.clock_gettime(time.pthread_getcpuclockid(
            self.thread.ident))

    def stop(self) -> None:
        self.call(self.gw.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        self.loop.close()


async def http(host, port, method, path, body=None):
    """One HTTP/1.1 request to the gateway: (status, headers, body)."""
    import asyncio
    reader, writer = await asyncio.open_connection(host, port)
    payload = json.dumps(body).encode() if body is not None else b""
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(payload)}\r\n\r\n").encode()
                 + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), head.decode("latin-1").lower(), rest


async def sse_completion(host, port, body, disconnect_after=None):
    """POST /v1/completions and read its SSE stream as it arrives:
    {index: tokens}, finish reasons, seconds to the first token event,
    seconds to the end; with `disconnect_after`, hang up once that many
    tokens arrived."""
    import asyncio
    from repro_torch.api.protocol import iter_sse
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection(host, port)
    payload = json.dumps(body).encode()
    writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(payload)}\r\n\r\n").encode()
                 + payload)
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    status = int(head.split()[1])
    toks, fins, first, buf, raw = {}, {}, None, b"", b""
    while status == 200:
        chunk = await reader.read(65536)
        if not chunk:
            break
        raw += chunk
        buf += chunk
        while b"\n\n" in buf:
            block, buf = buf.split(b"\n\n", 1)
            for e in iter_sse(block + b"\n\n"):
                if "token" in e:
                    first = first or time.perf_counter() - t0
                    toks.setdefault(e["index"], []).append(e["token"])
                elif "finish_reason" in e:
                    fins[e["index"]] = e["finish_reason"]
        if disconnect_after and sum(map(len, toks.values())) \
                >= disconnect_after:
            writer.close()
            return dict(status=status, toks=toks, fins=fins, ttft_s=first,
                        dur_s=time.perf_counter() - t0, disconnected=True)
    writer.close()
    if status == 200 and b"data: [DONE]" not in raw:
        status = -1                         # a stream cut short
    return dict(status=status, toks=toks, fins=fins, ttft_s=first,
                dur_s=time.perf_counter() - t0, disconnected=False)


def client_main(host: str, port: int) -> None:
    """`chip_smoke.py --client HOST PORT`: the gateway waves' clients, in
    a process of their own (as real clients are), so they share no
    interpreter lock with the gateway and the engines.  Reads {"bodies",
    "disconnect"} as JSON on stdin, sends every body at once, prints
    {"results", "wall_s"} as JSON."""
    import asyncio
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    job = json.loads(sys.stdin.read())
    drop = set(job["disconnect"])

    async def run():
        return await asyncio.gather(*[
            sse_completion(host, port, b,
                           disconnect_after=4 if i in drop else None)
            for i, b in enumerate(job["bodies"])])
    t0 = time.perf_counter()
    results = asyncio.run(run())
    print(json.dumps({"results": results,
                      "wall_s": time.perf_counter() - t0}))


def gateway_wave(gwt, bodies, disconnect=()):
    """Send every body at once from a client process; returns (results,
    the wave's wall s as the clients saw it, the gateway thread's CPU s
    over the wave)."""
    cpu0 = gwt.cpu_s()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--client",
         gwt.host, str(gwt.port)],
        input=json.dumps({"bodies": bodies,
                          "disconnect": sorted(disconnect)}),
        capture_output=True, text=True, timeout=600)
    cpu = gwt.cpu_s() - cpu0
    if proc.returncode != 0:
        fail(f"gateway client process: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    results = out["results"]
    for r in results:
        r["toks"] = {int(k): v for k, v in r["toks"].items()}
        r["fins"] = {int(k): v for k, v in r["fins"].items()}
    for i, r in enumerate(results):
        if r["status"] != 200:
            fail(f"gateway request {i}: status {r['status']}")
    return results, out["wall_s"], cpu


def quantiles(xs, qs=(50, 95)):
    import numpy as np
    return [float(np.percentile(xs, q)) for q in qs]


def phase_gateway(model, params, device, card):
    """Phase 13: qwen2.5-3b at full width and depth behind the port's
    `Gateway` over a `FleetRouter` of two replicas sharing the card and
    one copy of phase 1's packed weights (each its own KV pool, CUDA
    graphs, stream and driver thread), over loopback HTTP/SSE.  Returns
    the path's launch counts and the result."""
    import asyncio
    import threading

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fleet import FleetRouter
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     thread_launch_counts)
    from repro_torch.serve import PagedServeEngine, ServeConfig, ServeRequest

    t_phase = time.perf_counter()
    cfg = model.cfg
    scfg = ServeConfig(precision="int4", kv_dtype="auto", max_batch=4,
                       max_seq=128, page_size=16, prefill_chunk=16,
                       replicas=2, policy="prefix")
    rng = np.random.default_rng(14)
    n_new = 16

    def prompts(n):
        return [rng.integers(0, cfg.vocab, int(k)).astype(np.int32)
                for k in rng.integers(16, 65, size=n)]
    waves = {w: prompts(n) for w, n in (("warm", 8), ("thr2", 16),
                                        ("main", 14), ("busy", 16),
                                        ("thr1", 16))}

    # the reference: one engine serving every wave offline on the card
    t0 = time.perf_counter()
    off = PagedServeEngine(model, params, scfg, device=device)
    ref, off_ttft, off_tps = {}, {}, {}
    for name, wave in waves.items():
        t_wave = time.perf_counter()
        batch, _, m = run_wave(off, wave, n_new, 0)
        off_tps[name] = (sum(len(r.out_tokens) for r in batch)
                         / (time.perf_counter() - t_wave))
        for r in batch:
            ref[r.prompt.tobytes()] = list(r.out_tokens)
        off_ttft[name] = (m["ttft_p50_s"] * 1e3, m["ttft_p95_s"] * 1e3)
    log(f"gateway reference: {len(ref)} prompts served offline on the "
        f"card in {time.perf_counter() - t0:.1f} s; the 16-request waves, "
        f"all submitted at once to one engine: TTFT p50/p95 "
        f"{off_ttft['thr2'][0]:.2f} / {off_ttft['thr2'][1]:.2f} ms, "
        f"{off_tps['thr2']:.1f} and {off_tps['thr1']:.1f} tokens/s")
    del off
    torch.cuda.empty_cache()

    engines = [PagedServeEngine(model, params, scfg, device=device)
               for _ in range(2)]
    leaf = params["blocks"]["attn"]["wq"].data
    if any(e.params["blocks"]["attn"]["wq"].data.data_ptr()
           != leaf.data_ptr() for e in engines):
        fail("gateway replicas do not share the packed weights")
    if engines[0].stream == engines[1].stream:
        fail("gateway replicas share a CUDA stream")
    calls0 = [(e.prefill_calls, e.decode_calls) for e in engines]

    def body(p, **kw):
        return {"prompt": [int(t) for t in p], "max_tokens": n_new, **kw}

    def check_streams(label, wave, results):
        for p, r in zip(wave, results):
            want = ref[p.tobytes()]
            for idx, got in r["toks"].items():
                if r["disconnected"]:
                    if got != want[:len(got)]:
                        fail(f"{label}: disconnected stream {got} is not a "
                             f"prefix of {want}")
                elif got != want:
                    fail(f"{label}: stream {idx} {got} != offline {want}")
            if not r["disconnected"] and (
                    set(r["fins"].values()) != {"length"}):
                fail(f"{label}: finish reasons {r['fins']}")

    # two replicas: reset the counts just before driving the path
    reset_launch_counts()
    router = FleetRouter(engines)
    gwt = GatewayThread(router)
    drivers = [rep.driver._thread for rep in router.replicas]
    res, _, _ = gateway_wave(gwt, [body(p) for p in waves["warm"]])
    check_streams("gateway warm-up wave", waves["warm"], res)
    thr2, wall2, cpu2 = gateway_wave(gwt, [body(p) for p in waves["thr2"]])
    check_streams("gateway 2-replica wave", waves["thr2"], thr2)
    # the main wave: n = 2 on requests 0-3 (forks), a disconnect at 4
    # tokens on request 13, then two repeats of earlier prompts (prefix
    # affinity)
    main = waves["main"]
    bodies = [body(p, n=2) if i < 4 else body(p) for i, p in
              enumerate(main)]
    hits0 = router.policy.hits
    res, _, _ = gateway_wave(gwt, bodies, disconnect={13})
    check_streams("gateway main wave", main, res)
    for i in range(4):
        if res[i]["toks"].get(1) != res[i]["toks"].get(0):
            fail(f"gateway: fork of request {i} {res[i]['toks'].get(1)} != "
                 f"its primary {res[i]['toks'].get(0)}")
    if not res[13]["disconnected"]:
        fail("gateway: the disconnecting client read its whole stream")
    again = [p for p in main[4:13] if len(p) > 16][:2]
    rep_res, _, _ = gateway_wave(gwt, [body(p) for p in again])
    check_streams("gateway repeated prompts", again, rep_res)
    hits = router.policy.hits - hits0
    if hits < 2:
        fail(f"gateway: {hits} prefix-affinity hits for 2 repeated prompts")

    # the busy share of two replicas on the card, a profiled wave
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        busy_res, wall_b, _ = gateway_wave(
            gwt, [body(p) for p in waves["busy"]])
        torch.cuda.synchronize()
    check_streams("gateway profiled wave", waves["busy"], busy_res)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    union, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    busy_share = union / (wall_b * 1e6) if spans else None

    # the end state of both replicas, then /metrics, /healthz, /debug/slo
    audit = [rep.driver.call(lambda e: (
        e.cache.n_free_or_cached(), e.cache.allocator.n_pages,
        e.cache.allocator.n_free, e.n_running, e.scheduler.n_queued,
        e.telemetry.cancelled)).result(60) for rep in router.replicas]
    st_m, _, raw_m = asyncio.run(http(gwt.host, gwt.port, "GET",
                                      "/metrics"))
    st_h, _, raw_h = asyncio.run(http(gwt.host, gwt.port, "GET",
                                      "/healthz"))
    st_s, _, raw_s = asyncio.run(http(gwt.host, gwt.port, "GET",
                                      "/debug/slo"))
    metrics, slo = json.loads(raw_m), json.loads(raw_s)
    dead = [rep.id for rep in router.replicas
            if not rep.alive or rep.error is not None]
    counts = launch_counts()
    per_rep = []
    for rep, t, (p0, d0) in zip(router.replicas, drivers, calls0):
        eng = rep.engine
        got = thread_launch_counts(t)
        want = expected_launches(cfg, eng.prefill_calls - p0,
                                 eng.decode_calls - d0)
        per_rep.append({"replica": rep.id,
                        "prefill_calls": eng.prefill_calls - p0,
                        "decode_calls": eng.decode_calls - d0,
                        "launches": got, "expected": want})
        if got != want:
            fail(f"gateway replica {rep.id}: launches {got} != expected "
                 f"{want}")
    gwt.stop()
    log(f"gateway launches per replica (driver threads): "
        + json.dumps(per_rep))
    if dead:
        fail(f"gateway: dead replicas {dead}")
    if counts != {k: sum(r["launches"][k] for r in per_rep)
                  for k in counts}:
        fail(f"gateway: process launches {counts} are not the replicas' "
             f"sum")
    name = f"{cfg.name}.serve_step"
    for i, eng in enumerate(engines):
        check_graphs(f"gateway replica {i}", eng, {
            (name, (4, 16)): step_launches(cfg, 16),
            (name, (4, 1)): step_launches(cfg, 1)},
            [(name, (4, 16)), (name, (4, 1))])
    for i, (fc, n_pages, n_free, running, queued, cancelled) in \
            enumerate(audit):
        if (fc, running, queued) != (n_pages, 0, 0):
            fail(f"gateway replica {i}: pages free or cached {fc} of "
                 f"{n_pages}, {running} running, {queued} queued")
    if sum(a[5] for a in audit) < 1:
        fail("gateway: the disconnect cancelled nothing")
    reps = metrics["fleet"]["replicas"]
    decoded = {k: r["snapshot"].get("decode_tokens", 0.0)
               for k, r in reps.items()}
    if st_m != 200 or sorted(reps) != ["0", "1"] or min(
            decoded.values()) <= 0 or any("engine" not in r
                                          for r in reps.values()):
        fail(f"gateway /metrics: status {st_m}, decode tokens per replica "
             f"{decoded}")
    if st_h != 200 or not json.loads(raw_h)["ok"]:
        fail(f"gateway /healthz: {st_h} {raw_h[:200]!r}")
    if st_s != 200:
        fail(f"gateway /debug/slo: {st_s}")

    # one replica: the same traffic shape on replica 0 alone
    gw1 = GatewayThread(FleetRouter(engines[:1]))
    thr1, wall1, cpu1 = gateway_wave(gw1, [body(p) for p in waves["thr1"]])
    check_streams("gateway 1-replica wave", waves["thr1"], thr1)
    gw1.stop()

    # load shedding: both drivers parked, one sample admitted each, the
    # third request 429s with Retry-After
    sat = FleetRouter(engines, max_pending=1)
    gws = GatewayThread(sat)
    gates = [threading.Event(), threading.Event()]
    accepted = threading.Event()
    orig = sat.dispatch

    def dispatch(rep, reqs, on_done):
        fut = orig(rep, reqs, on_done)
        if sat.counters["dispatched"] >= 2:
            accepted.set()
        return fut
    sat.dispatch = dispatch
    try:
        for rep, gate in zip(sat.replicas, gates):
            rep.driver.call(lambda e, g=gate: g.wait(120))

        async def shed():
            first = [asyncio.ensure_future(http(
                gws.host, gws.port, "POST", "/v1/completions",
                body(waves["warm"][i]))) for i in range(2)]
            loop = asyncio.get_running_loop()
            if not await loop.run_in_executor(None, accepted.wait, 120):
                fail("gateway saturation: the first two requests were "
                     "not admitted")
            third = await http(gws.host, gws.port, "POST",
                               "/v1/completions", body(waves["warm"][2]))
            for g in gates:
                g.set()
            return await asyncio.gather(*first), third
        firsts, third = asyncio.run(shed())
    finally:
        for g in gates:
            g.set()
    gws.stop()
    if [f[0] for f in firsts] != [200, 200] or third[0] != 429 \
            or "retry-after:" not in third[1]:
        fail(f"gateway saturation: statuses {[f[0] for f in firsts]}, "
             f"then {third[0]} ({third[1]!r})")
    retry = third[1].split("retry-after:")[1].split("\r\n")[0].strip()

    tok2 = sum(len(t) for r in thr2 for t in r["toks"].values())
    tok1 = sum(len(t) for r in thr1 for t in r["toks"].values())
    tokb = sum(len(t) for r in busy_res for t in r["toks"].values())
    ttft2 = quantiles([r["ttft_s"] * 1e3 for r in thr2])
    ttft1 = quantiles([r["ttft_s"] * 1e3 for r in thr1])
    drift = {rid: {k: d.get(k) for k in ("sim_measured_ratio",
                                         "sim_drift_ratio",
                                         "sim_drift_ticks")}
             for rid, d in slo["drift"].items()}
    agg = metrics["engine"]
    result = {
        "card": card, "replicas": 2, "policy": "prefix", "layers":
        cfg.n_layers, "requests_per_wave": 16, "new_tokens": n_new,
        "ttft_ms_p50_p95_gateway_2_replicas": ttft2,
        "ttft_ms_p50_p95_gateway_1_replica": ttft1,
        "ttft_ms_p50_p95_offline_same_prompts": list(off_ttft["thr2"]),
        "tokens_per_s_offline_one_engine": [off_tps["thr2"],
                                            off_tps["thr1"]],
        "ttft_ms_p50_p95_engine_side_fleet": [
            (agg.get("ttft_p50_s") or float("nan")) * 1e3,
            (agg.get("ttft_p95_s") or float("nan")) * 1e3],
        "tokens_per_s_2_replicas": tok2 / wall2,
        "tokens_per_s_1_replica": tok1 / wall1,
        "wall_s_2_replicas": wall2, "wall_s_1_replica": wall1,
        "device_busy_share_2_replicas": busy_share,
        "profiled_wave_wall_s": wall_b,
        "profiled_wave_tokens_per_s": tokb / wall_b,
        "gateway_host_ms_per_token_2_replicas": cpu2 * 1e3 / tok2,
        "gateway_host_ms_per_token_1_replica": cpu1 * 1e3 / tok1,
        "drift": drift, "prefix_hits_repeats": hits,
        "decode_tokens_per_replica": decoded,
        "retry_after_s": retry, "launches_per_replica": per_rep,
        "pages_end": [list(a[:3]) for a in audit],
        "phase_s": time.perf_counter() - t_phase}
    log(f"gateway ({card}): qwen2.5-3b x{cfg.n_layers}, 2 replicas on one "
        f"card: TTFT p50/p95 {ttft2[0]:.2f} / {ttft2[1]:.2f} ms through the "
        f"gateway (1 replica {ttft1[0]:.2f} / {ttft1[1]:.2f}; offline, all "
        f"submitted at once, {off_ttft['thr2'][0]:.2f} / "
        f"{off_ttft['thr2'][1]:.2f}); {tok2 / wall2:.1f} tokens/s with 2 "
        f"replicas, {tok1 / wall1:.1f} with 1 (one engine offline "
        f"{off_tps['thr2']:.1f} / {off_tps['thr1']:.1f}); device busy "
        + (f"{100 * busy_share:.1f} %" if busy_share is not None
           else "not measured (no CUDA events)")
        + f" with 2; gateway thread {cpu2 * 1e3 / tok2:.3f} ms CPU per "
        f"token; drift sim/measured {json.dumps(drift)}; 429 Retry-After "
        f"{retry} s")
    log("gateway result " + json.dumps(result))
    return counts, result


def main() -> None:
    import dataclasses

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"the port's package is not next to this script ({src})")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products (MLA's latent sum over bf16 pools) accumulate in f32,
    # as the CPU's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
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
        f"{n} hd {hd} {smem_bytes(e, hd)} B" for hd in (112, 128, 256)
        for n, e in (("int8", 1), ("bf16", 2), ("f32", 4))))

    t0 = time.perf_counter()
    model, params = build_full_model(device)
    torch.cuda.synchronize()
    log(f"qwen2.5-3b INT4 weights drawn and packed on the card in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    checks = Checks()
    timings = phase_kernels(model, params, device, checks)
    window_timing = phase_family_kernels(device, checks)
    timings.update(phase_moe_kernels(device, checks))
    timings.update(phase_deepseek_kernels(device, checks))
    timings.update(phase_recurrent_kernels(device, checks))
    phase_ragged_kernels(device, checks)
    by_path = {}
    by_path["decode"], full_result = phase_full_model(model, params, device,
                                                      card)
    by_path["spec_ngram"], spec_result = phase_spec(model, params, device)
    by_path["decode_attention"] = phase_decode_attention(model.cfg, device,
                                                         checks)
    by_path["gateway"], gateway_result = phase_gateway(model, params, device,
                                                       card)
    del model, params
    torch.cuda.empty_cache()
    phase_card_vs_cpu(device)
    phase_card_vs_cpu(device, "gemma3-4b", long_lane=True, local_pattern=2,
                      local_window=128)
    phase_card_vs_cpu(device, "gemma2-27b")
    phase_card_vs_cpu(device, "phi3-medium-14b")
    phase_card_vs_cpu(device, MOE_ARCH)
    phase_card_vs_cpu(device, DS_ARCH)
    from repro_torch.configs import get_config
    xcfg, zcfg = get_config(XLSTM_ARCH), get_config(ZAMBA_ARCH)
    phase_card_vs_cpu(device, XLSTM_ARCH, decode_steps=2,
                      ssm=dataclasses.replace(xcfg.ssm, slstm_every=2))
    phase_card_vs_cpu(device, ZAMBA_ARCH, n_layers=3, decode_steps=2,
                      zamba=dataclasses.replace(zcfg.zamba, shared_every=2))
    (by_path["gemma3_decode"], by_path["gemma3_spec_ngram"],
     gemma3_result) = phase_gemma3(device, card)
    short = {}
    for arch, key in (("gemma2-27b", "gemma2_decode"),
                      ("phi3-medium-14b", "phi3_decode")):
        by_path[key], short[arch] = phase_short_wave(arch, device)
    (by_path["qwen3moe_decode"], by_path["qwen3moe_spec_ngram"],
     moe_result) = phase_moe_serving(device, MOE_ARCH, 4, {
         "wq": (("blocks", "attn", "wq"), 128),
         "we_gate": (("blocks", "ffn", "we_gate"), 128),
         "we_down": (("blocks", "ffn", "we_down"), 96)}, seed=5)
    (by_path["deepseek_decode"], by_path["deepseek_spec_ngram"],
     ds_result) = phase_moe_serving(device, DS_ARCH, 8, {
         "w_down": (("first_blocks", "ffn", "w_down"), 114),
         "we_down": (("blocks", "ffn", "we_down"), 88),
         "ws_down": (("blocks", "ffn", "ws_down"), 88),
         "w_uk": (("blocks", "attn", "w_uk"), 32),
         "w_dkv": (("blocks", "attn", "w_dkv"), 128)}, seed=6,
         decode_gemvs=(68, 1))
    by_path["xlstm_decode"], xlstm_result = phase_recurrent_serving(
        device, XLSTM_ARCH, 48, seed=7, groups={
            "mlstm wq": (("mlstm", "cell", "wq"), 64),
            "mlstm up_proj": (("mlstm", "cell", "up_proj"), 128),
            "slstm ffn_down": (("slstm", "cell", "ffn_down"), 105),
            "head": (("head",), 128)}, decode_launches=(265, 0, 0))
    by_path["zamba_decode"], zamba_result = phase_recurrent_serving(
        device, ZAMBA_ARCH, 27, seed=8, groups={
            "in_proj": (("mamba", "cell", "in_proj"), 112),
            "out_proj": (("mamba", "cell", "out_proj"), 112),
            "shared wq": (("shared", "attn", "wq"), 112),
            "lora out_proj": (("lora", "out_proj"), 112),
            "shared w_down": (("shared", "ffn", "w_down"), 128),
            "head": (("head",), 112)}, decode_launches=(79, 4, 4))

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
    log("gemma3-4b summary " + json.dumps(gemma3_result))
    log("gemma2-27b / phi3-medium-14b x4 summary " + json.dumps(short))
    log(f"{MOE_ARCH} x4 summary " + json.dumps(moe_result))
    log(f"{DS_ARCH} x8 summary " + json.dumps(ds_result))
    log(f"{XLSTM_ARCH} x48 summary " + json.dumps(xlstm_result))
    log(f"{ZAMBA_ARCH} x27 summary " + json.dumps(zamba_result))
    log("gateway summary " + json.dumps(gateway_result))
    log("paged_flash_decode window timing " + json.dumps(window_timing))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--client"]:
        client_main(sys.argv[2], int(sys.argv[3]))
    else:
        main()
