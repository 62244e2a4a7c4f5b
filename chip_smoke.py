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
 14. training (no kernel of the port runs here: plain PyTorch products
     and autograd; the five kernels' launch counts must stay 0 over the
     phase): (a) 2-layer full-width f32 copies of qwen2.5-3b,
     musicgen-medium (embeddings through the frontend stub, LayerNorm,
     GELU FFN, untied head) and deepseek-v2-lite-16b (MLA, a dense first
     layer, 64 experts, top 6), batch 2 x 32, seed 0: the loss and every
     gradient leaf on the card against the CPU's, then one AdamW update
     from the same gradients on each, parameters compared; (b)
     qwen2.5-3b at full width and depth (3.086 B params, f32) through
     the port's Trainer, 4 steps at batch 8 x 64, remat off, and (c)
     musicgen-medium at full width and depth for 2 steps: losses and the
     next batch's gradient norm finite (gated); step ms, tokens/s, the
     share of the f32 bound (6 N tokens over 67 TFLOP/s), peak memory
     beside 16 B a param (printed); (d) the qwen2.5-3b smoke config
     through the Trainer with microbatches 2: 20 steps straight against
     10 steps stopped by the preemption flag and resumed from LATEST for
     10 more (bit-identical losses, gated), and 30 steps whose last 5
     losses average below their first 5 (gated).
 15. the model's other paths: (a) xlstm-1.3b at full width and depth
     (48 layers) and zamba2-7b at full width and 27 layers through the
     Trainer in f32, 4 steps each at batch 8 x 64 (step ms, tokens/s,
     share of the f32 bound, forward + backward and AdamW ms, peak
     memory beside 16 B a param, printed; losses finite, gated), after
     the loss and every gradient leaf on the card against the CPU's on
     the smallest full-width copies the families allow (xlstm: one group
     of 8 layers; zamba: one group of 6 and the tail layer) at batch 1 x
     16; no kernel launches; (b) qwen2.5-3b at full width and depth on
     INT4 weights (phase 3's seed), `prefill` of 4 prompts of 32 tokens
     into a bf16 `cache_specs` cache of 4 x 256, then 32 greedy
     `decode_step`s, eagerly: the tokens must equal the paged engine's
     greedy stream with bf16 KV (or diverge at a logged near-tie), a
     step must launch 181 cim_gemv, 36 swiglu_qgemv, 36 flash_decode and
     no paged kernel (counts zeroed before the 32 steps, read after);
     printed: the step's wall median beside its bytes bound, and the
     device time of `ops.decode_attention`'s cache transposes; then
     each layer's `decode_attention` over the live bf16 cache (b * g =
     8, S = 256, qpk 8) at pos 32, 48 and 63 against its plain version
     (phase 2's tolerance), and the step's 36 `flash_decode` calls at
     that shape (pos 48) timed as in phase 2 for the kernels line; (c)
     xlstm-1.3b at full width and depth on INT4: 16 `decode_step`s from
     the zero state (8 prompt tokens, then greedy), the tokens equal to
     the engine's `serve_step` stream, 265 cim_gemv a step.
 16. tensor-parallel serving: two ranks (processes spawned on a gloo
     group over loopback, both on the one card) each build qwen2.5-3b
     from phase 3's seed, INT4 (a sha256 of the unsharded packed weights
     must equal phase 3's), keep their half (`dist.shard`: 8 / 1 heads,
     d_ff 5504, 75968 vocab rows; INT8 pools of one kv head) and serve
     at tp = 2, eagerly: phase 3's first wave, whose greedy streams must
     equal phase 3's eager ones, and an n-gram run (k = 4) on phase 4's
     prompts, equal to phase 4's (a divergence only at a near-tie of the
     tp = 2 logits, logged); both ranks' streams equal.  Each rank's
     launches must be exactly 181 cim_gemv, 36 swiglu_qgemv and 36
     paged_flash_decode a decode step (36 paged_flash_verify a verify
     step), and its collectives 74 a step call (73 all-reduces, 1
     gather).  Each rank holds cim_gemv (wq / wk / wv / wo, w_down in
     groups of 86, the 75968-row table, M = 1, 4, 20), swiglu_qgemv
     (2048 -> 5504) and both paged kernels (g 1, qpk 8) at its shapes
     against their plain versions, every call twice (bitwise equal).
     Logged: one rank's decode step kernels as CUDA-graph replays
     beside their bytes bound, the decode step wall median at tp = 2
     beside phase 3's eager tp = 1, the collectives' share of a step,
     each rank's peak memory.
 17. expert-parallel MoE and tensor-parallel MLA: two ranks (spawned
     as in phase 16, both on the one card) build qwen3-moe-235b-a22b at
     4 layers and then deepseek-v2-lite-16b at 8, each from phase 9's /
     10's seed, INT4 (one rank draws at a time; the unsharded weights'
     sha256 must equal that phase's), keep their half (64 / 32 experts
     of every stack; qwen3-moe 32 / 2 heads, INT8 pools of 2 kv heads;
     deepseek 8 MLA heads over whole bf16 latent pools, layer 0's d_ff
     5472) and serve at tp = 2, eagerly: the phase's first wave, whose
     streams must equal its eager ones, and its n-gram prompts (k = 4),
     equal to its run without speculation (a divergence only at a
     near-tie, logged); both ranks' streams equal.  Launches exactly as
     tp = 1 a call (qwen3-moe 29 cim_gemv and 4 paged_flash_decode a
     decode step, deepseek 68 cim_gemv and 1 swiglu_qgemv), collectives
     2 L + 2 a call.  Each rank holds cim_gemv (projections, shared
     experts, head at M = 1, 4, 20; the first MoE layer's stacks at the
     decode capacity with a decode step's own routing counts over its
     experts), swiglu_qgemv and the paged kernels (g 2, qpk 16) at its
     shapes against their plain versions, every call twice.  Logged:
     one rank's decode step kernels as CUDA-graph replays beside the
     bytes bound of the experts it kept, the decode step wall median
     beside the phase's eager tp = 1, the collectives' share, each
     rank's peak memory drawing, resident and serving.
 18. tensor-parallel recurrent and hybrid serving: two ranks (spawned
     as in phase 16, both on the one card) build xlstm-1.3b at full
     width and depth and then zamba2-7b at 27 layers, each from phase
     11's / 12's seed, INT4 (one rank draws at a time; the unsharded
     weights' sha256 must equal that phase's), keep their half by the
     split table (`dist.shard.recurrent_splits`: xlstm 2 of 4 mLSTM
     heads, up_proj 2048 -> 4096, the sLSTM cell whole, ffn_up 2048 ->
     2730, ffn_down whole (a rank's 1365 rows would split a packed
     byte); zamba 56 of 112 Mamba2 heads, in_proj 3584 -> 7352, B and C
     whole, 16 / 16 attention heads, INT8 pools of 16 kv heads; each
     arena at the rank's heads) and serve at tp = 2, eagerly: the
     phase's first wave, whose streams must equal its eager ones, and
     the same wave in the pool of its forced preemption (xlstm's lanes
     resume from each rank's snapshot of its slice, zamba's re-prefill),
     equal to them too (a divergence only at a near-tie, logged); both
     ranks' streams equal.  Launches exactly as tp = 1 a call (xlstm 265
     cim_gemv a decode step, zamba 79 cim_gemv, 4 swiglu_qgemv, 4
     paged_flash_decode), collectives exactly as the rank's leaves give
     them (`rec_collectives`: xlstm 43 all-reduces + 91 gathers, zamba
     36 + 28 a call).  Each rank holds cim_gemv (every packed leaf of
     the first and last layer, the 2-expert head-wise stacks, the head;
     M = 1, 4, 20), swiglu_qgemv (3584 -> 7168) and paged_flash_decode
     (g 16, qpk 1, hd 112) at its shapes against their plain versions,
     every call twice.  Logged: one rank's decode step kernels as
     CUDA-graph replays beside the bytes bound of what it holds, the
     decode step wall median beside the phase's eager tp = 1, the
     collectives' share, the arena's bytes a rank, each rank's peak
     memory drawing, resident and serving.
 19. the gateway at tensor parallelism 2: two ranks (spawned as in
     phase 16, both on the one card) build qwen2.5-3b from phase 3's
     seed (the unsharded weights' sha256 must equal phase 3's) and two
     replicas' engines, each on its own pair of groups
     (`dist.shard.replica_groups`), INT4, INT8 KV, batch 4, pages and
     chunks of 16.  Rank 0 serves the port's `Gateway` over a
     `FleetRouter` of both and leads each engine's group
     (`dist.lockstep`: a tick a step call with its clock reading and
     its submits, cancels and drains); rank 1 follows each engine on a
     thread of its own.  Over HTTP/SSE (`--client` processes): a
     greedy wave of phase 3's 8 prompts, 16 new tokens each, whose
     streams must equal phase 3's eager ones (a divergence only at a
     near-tie, which both ranks check); a deadline wave of 14 requests
     (one client hangs up after 4 tokens), then, once every lane is
     taken, 2 of priority 1 with a deadline shorter than a step, which
     both ranks must reject as `expired`; one /metrics, one /healthz;
     the gateway's stop sends the STOP ticks and both ranks end.  Both
     ranks' engines must agree (eids, lanes, queue, steps, ticks,
     rejections, cancels), every page come back, the launches be
     exactly 181 / 36 / 36 a decode step on each rank (each replica's
     driver or follower thread), the collectives 2 L + 2 a call.
     Logged: ticks a step call and their host ms, the decode step wall
     median through the gateway beside phase 16's offline one, TTFT
     p50 / p95, peak memory a rank, the phase's seconds.
 20. the paper's design-space search and the dry-run / roofline tools:
     (a) `run_dse` on llama3.2-1b (alpha 1, INT4, seed 0, population 20
     x 50 generations) twice: identical, the best cost never rising;
     the best design, its latency and energy and the Pareto front's
     size logged as cost-model output; (b) `launch.dryrun` over every
     cell of `--all` on the meta device, every one ok, the roofline
     table and each cell's peak bytes a device against the card's
     memory logged; (c) qwen2.5-3b decode_32k (batch 128 over a bf16
     cache of 32768), INT4, at 1 and 2 layers built on the card: the
     bytes the arguments ask the allocator for equal the dry-run's
     within 512 B a tensor (the bytes it gives them logged beside),
     launches exact (5 L + 1 / L / L), logits finite; peak memory and
     the step's device time logged beside the dry-run's peak and the
     roofline's bound, extrapolated to 36 layers.
 21. summary: a `{"kernels": [...]}` line (flash_decode's launches from
     phase 15b's contiguous decode, and its ms, plain_ms, library_ms and
     bound_ms at that path's shape; the tensor-parallel paths' launches
     under `launches_by_path`), the card line, and last
     `{"ok": true, "device": {...}}`.

Imports nothing of the JAX package.  Needs the repository's src/ next to
this file; with no CUDA device it exits non-zero before printing any
result.
"""
import contextlib
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
                fd_bytes, fd_flops, library=sdpa, key="flash_decode S1024")
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
    TP_REF.update(wave=waves[0], eager_decode_ms=eager["decode_ms"],
                  wave_streams=[r.out_tokens for r in eager["reqs"][:4]],
                  wave8=waves[0] + waves[1],
                  wave8_streams=[r.out_tokens for r in eager["reqs"][:8]])

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


def fresh_state(model, b: int, n_pages: int, ps: int, device, tp: int = 1):
    """A step's decode state on `device`, zeroed: the paged pools (INT8,
    or MLA's bf16 latent pools) and, for a recurrent family, the arena's
    leaves for b lanes, in one dict as the engine hands them over; at
    one of `tp` ranks' shapes."""
    import torch
    from repro_torch.dist.shard import shard_state_specs
    from repro_torch.models.common import map_specs
    kv = torch.bfloat16 if model.cfg.attn_kind == "mla" else torch.int8
    specs = shard_state_specs(model.decode_state_specs(b, n_pages, ps, kv),
                              model.cfg, tp)
    state = {}
    for half in ("paged", "arena"):
        state.update(map_specs(lambda s: torch.zeros(
            s.shape, dtype=s.dtype, device=device), specs[half]))
    return state


def top2_gap(model, params, device, tokens, step=None, tp: int = 1):
    """(gap between the two largest logits after `tokens`, the logit
    tolerance): one prefill chunk through `serve_step` (or `step`: a
    tensor-parallel engine's, which every rank calls in lockstep) on a
    fresh pool (and arena) at one of `tp` ranks' shapes."""
    import torch
    n, ps = len(tokens), 16
    pages = -(-n // ps)
    cache = fresh_state(model, 1, pages, ps, device, tp)
    logits, _ = (step or model.serve_step)(
        params, cache, {"tokens": torch.tensor(tokens[None], device=device)},
        torch.arange(pages, dtype=torch.int32, device=device)[None],
        torch.zeros(1, dtype=torch.int32, device=device),
        torch.tensor([n], dtype=torch.int32, device=device))
    row = logits[0, n - 1].float()
    top = row.topk(2).values
    return (float(top[0] - top[1]),
            LOGIT_TOL * max(1.0, float(row.abs().max())))


def check_identity(label, base, spec, model, params, device, step=None,
                   tp: int = 1) -> int:
    """Greedy streams of two runs (with and without speculation, or
    eager and as CUDA graphs) must be equal.  The one exception: a first
    divergence at a step whose top-two target logits (`top2_gap`, with
    `step` and `tp`) lie within the logit tolerance (the two paths sum
    in another order), which is logged.  Returns the number of such
    requests."""
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
                [rb.prompt, np.asarray(a[:t], np.int32)]), step, tp)
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
    TP_REF.update(ngram_prompts=prompts,
                  ngram_streams=[r.out_tokens for r in e_reqs])
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
    ref = TP_MOE_REF[arch] = {"digest": weights_digest(params)}
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
    ref.update(wave=wave, wave_streams=[r.out_tokens for r in eager["reqs"]],
               eager_decode_ms=eager["decode_ms"])
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
    ref.update(ngram_prompts=prompts,
               ngram_streams=[r.out_tokens for r in base])
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
    ref = TP_REC_REF[arch] = {"digest": weights_digest(params)}
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
    ref.update(wave=wave, wave_streams=[r.out_tokens for r in eager["reqs"]],
               eager_decode_ms=eager["decode_ms"],
               state_bytes=eager["state_bytes"])
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
    ref["tight_pages"] = pages
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


def start_clients(gwt, bodies, disconnect=()):
    """Start a client process sending every body at once (`--client`),
    talked to from a thread; `client_results` waits for it."""
    import threading
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--client",
         gwt.host, str(gwt.port)], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    box = {}

    def talk():
        box["out"], box["err"] = proc.communicate(json.dumps(
            {"bodies": bodies, "disconnect": sorted(disconnect)}))
    thread = threading.Thread(target=talk, daemon=True)
    thread.start()
    return proc, thread, box


def client_results(handle):
    """(results, the wave's wall s as the clients saw it) of a client
    process; any status but 200 fails."""
    proc, thread, box = handle
    thread.join(600)
    if thread.is_alive():
        proc.kill()
        fail("gateway client process: no answer in 600 s")
    if proc.returncode != 0:
        fail(f"gateway client process: {box['err'][-2000:]}")
    out = json.loads(box["out"].strip().splitlines()[-1])
    results = out["results"]
    for r in results:
        r["toks"] = {int(k): v for k, v in r["toks"].items()}
        r["fins"] = {int(k): v for k, v in r["fins"].items()}
    for i, r in enumerate(results):
        if r["status"] != 200:
            fail(f"gateway request {i}: status {r['status']}")
    return results, out["wall_s"]


def gateway_wave(gwt, bodies, disconnect=()):
    """Send every body at once from a client process; returns (results,
    the wave's wall s as the clients saw it, the gateway thread's CPU s
    over the wave)."""
    cpu0 = gwt.cpu_s()
    results, wall_s = client_results(start_clients(gwt, bodies, disconnect))
    return results, wall_s, gwt.cpu_s() - cpu0


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


# ---------------------------------------------------------------------------
# Training: forward, loss, autograd, AdamW, checkpoints, the Trainer
# ---------------------------------------------------------------------------
TRAIN_LOSS_TOL = 1e-4       # card vs CPU loss, relative (f32 sum order)
TRAIN_GRAD_TOL = 1e-3       # each gradient leaf: 1e-3 * max|g_cpu| + 1e-7
TRAIN_PARAM_TOL = 1e-6      # after one AdamW update from the same
                            #   gradients: 1e-6 * max|p| + 1e-9
STATE_BYTES = 16            # f32 params, grads and two moments a param


def train_feed(cfg, seq_len: int, batch: int):
    """SyntheticLM batches at (batch, seq_len), through the frontend
    stub for an arch that takes embeddings."""
    from repro_torch.data import DataConfig, FrontendStub, SyntheticLM
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                  global_batch=batch))
    return data if cfg.embed_inputs else FrontendStub(data, cfg.d_model)


def f32_params(model, device, seed: int = 0):
    """Seeded f32 parameters drawn on `device`."""
    import torch
    from repro_torch.models import init_params
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_params(model.param_specs(), gen, device,
                       dtype_override=torch.float32)


def trainable(params):
    from repro_torch.train.adamw import tree_leaves
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def all_grads(loss, params):
    """Gradients of every leaf, zeros for one the loss does not read."""
    import torch
    from repro_torch.train.adamw import tree_leaves
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, grads)]


def train_card_vs_cpu(arch: str, device, n_layers: int = 2, seq: int = 32,
                      batch_size: int = 2) -> dict:
    """Phase 14a (and 15a): an `n_layers`-layer full-width copy of
    `arch`, f32, seed 0, one batch of `batch_size` x `seq` from
    SyntheticLM (the frontend stub's embeddings for musicgen): the loss
    and every gradient leaf on the card against the CPU's from the same
    weights; then one AdamW update on each from the CPU's gradients (so
    the optimizer's arithmetic is what is compared), parameters after it
    compared."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.models.common import tree_to
    from repro_torch.train import AdamW
    from repro_torch.train.adamw import tree_leaves, tree_unflatten

    t0 = time.perf_counter()
    cfg = get_config(arch).replace(dtype="float32", remat=False,
                                   n_layers=n_layers)
    model = DecoderLM(cfg)
    drawn = f32_params(model, device)
    params = {str(device): drawn, "cpu": tree_to(drawn, "cpu")}
    batch = {k: torch.from_numpy(v) for k, v in
             train_feed(cfg, seq, batch_size).batch(0).items()}
    out = {}
    for dev, p in params.items():
        loss = model.loss(trainable(p),
                          {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (float(loss.detach()), all_grads(loss, p))
    (lc, gc), (lg, gg) = out["cpu"], out[str(device)]
    if not (math.isfinite(lg) and abs(lg - lc) <= TRAIN_LOSS_TOL * abs(lc)):
        fail(f"training {arch} x2: card loss {lg} vs CPU {lc}")
    worst = (0.0, "")
    for name, a, b in zip(_leaf_names(params["cpu"]), gg, gc):
        err = float((a.cpu() - b).abs().max())
        tol = TRAIN_GRAD_TOL * float(b.abs().max()) + 1e-7
        if not err <= tol:
            fail(f"training {arch} x2: gradient {name} max diff {err:.3e} "
                 f"> tol {tol:.3e}")
        worst = max(worst, (err / tol, name))
    opt = AdamW(lr=1e-3)
    for dev, p in params.items():
        grads = [g.to(dev, copy=True) for g in gc]
        opt.update(tree_unflatten(p, grads), opt.init(p), p)
    perr = 0.0
    for a, b in zip(tree_leaves(params[str(device)]),
                    tree_leaves(params["cpu"])):
        err = float((a.detach().cpu() - b.detach()).abs().max())
        tol = TRAIN_PARAM_TOL * float(b.detach().abs().max()) + 1e-9
        if not err <= tol:
            fail(f"training {arch} x2: parameters after AdamW differ by "
                 f"{err:.3e} > {tol:.3e}")
        perr = max(perr, err / tol)
    res = {"arch": arch, "layers": n_layers, "params": model.n_params(),
           "batch": [batch_size, seq],
           "loss_card": lg, "loss_cpu": lc,
           "loss_rel_diff": abs(lg - lc) / abs(lc),
           "grad_worst_err_over_tol": worst[0], "grad_worst_leaf": worst[1],
           "adamw_worst_err_over_tol": perr,
           "s": time.perf_counter() - t0}
    log(f"training card vs CPU, {arch} {n_layers} layers at full width "
        f"({model.n_params() / 1e9:.3f} B params), batch {batch_size} x "
        f"{seq}, f32: loss "
        f"{lg:.6f} vs {lc:.6f} (rel diff {res['loss_rel_diff']:.2e}, tol "
        f"{TRAIN_LOSS_TOL:g}); gradients worst err/tol {worst[0]:.3f} "
        f"({worst[1]}; tol {TRAIN_GRAD_TOL:g} x max|g| + 1e-7); params "
        f"after one AdamW update worst err/tol {perr:.3f} (tol "
        f"{TRAIN_PARAM_TOL:g} x max|p| + 1e-9); {res['s']:.1f} s")
    del params, out, gg, gc
    torch.cuda.empty_cache()
    return res


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix.lstrip("/")]


def train_full(arch: str, device, card: str, steps: int,
               n_layers: int = 0) -> dict:
    """Phases 14b-c: `arch` at full width (and `n_layers`, 0 = full
    depth) through the port's Trainer: f32 params drawn on the card from
    seed 0, `steps` steps at the launcher's batch 8 x 64, remat off, the
    launcher's schedule.  Then one more step by hand, its forward +
    backward and AdamW update timed apart.  Gated: losses finite, and
    that step's gradient norm finite.  Printed: losses, step ms (median
    of the steps after the first), tokens/s, the share of the f32 bound
    (6 N tokens over 67 TFLOP/s), the two parts' ms, peak memory beside
    16 B a param."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.train import (AdamW, TrainConfig, Trainer,
                                   cosine_schedule, global_norm)
    from repro_torch.train.adamw import tree_unflatten

    t0 = time.perf_counter()
    cfg = get_config(arch).replace(dtype="float32", remat=False)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    model = DecoderLM(cfg)
    n = model.n_params()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = trainable(f32_params(model, device))
    feed = train_feed(cfg, 64, 8)
    dts = []
    tr = Trainer(model, AdamW(lr=cosine_schedule(1e-3, 10, steps)), feed,
                 TrainConfig(steps=steps, log_every=1),
                 event_hook=lambda e: dts.append(e.payload["dt"])
                 if e.kind == "STEP" else None, device=device)
    t_run = time.perf_counter()
    out = tr.run(params=params)
    run_s = time.perf_counter() - t_run
    losses = out["losses"]
    # one more step by hand, its parts timed with CUDA events: forward
    # + backward, then (after the gradient norm) the AdamW update
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    batch = tr._batch_at(steps)
    ev[0].record()
    grads = all_grads(model.loss(params, batch), params)
    ev[1].record()
    gnorm = float(global_norm(grads))
    ev[2].record()
    tr.opt.update(tree_unflatten(params, grads), out["opt_state"], params)
    ev[3].record()
    torch.cuda.synchronize()
    fwd_bwd_ms, adamw_ms = ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3])
    peak = torch.cuda.max_memory_allocated()
    if not (all(math.isfinite(x) for x in losses) and math.isfinite(gnorm)):
        fail(f"training {arch}: losses {losses}, gradient norm {gnorm}")
    tokens = 8 * 64
    step_s = float(sorted(dts[1:])[len(dts[1:]) // 2])
    flops = 6.0 * n * tokens
    bound_s = flops / F32_FLOPS
    res = {"arch": arch, "layers": cfg.n_layers, "params": n,
           "steps": steps, "batch": [8, 64], "losses": losses,
           "step_ms": [d * 1e3 for d in dts],
           "step_ms_median": step_s * 1e3,
           "tokens_per_s": tokens / step_s,
           "bound_ms": bound_s * 1e3, "bound_flop": flops,
           "bound_share": bound_s / step_s,
           "grad_norm_next_batch": gnorm, "fwd_bwd_ms": fwd_bwd_ms,
           "adamw_ms": adamw_ms,
           "peak_gb": peak / 1e9, "state_gb_computed": STATE_BYTES * n / 1e9,
           "run_s": run_s, "phase_s": time.perf_counter() - t0,
           "card": card}
    log(f"training {arch} x{cfg.n_layers} at full width "
        f"({n / 1e9:.3f} B params), f32, batch 8 x 64, {steps} steps "
        f"through Trainer: losses {[round(x, 6) for x in losses]}; step ms "
        f"{[round(d * 1e3, 2) for d in dts]}, median after the first "
        f"{step_s * 1e3:.2f} ms, {tokens / step_s:.1f} tokens/s; f32 bound "
        f"6 N tokens = {flops / 1e12:.3f} TFLOP over 67 TFLOP/s = "
        f"{bound_s * 1e3:.1f} ms, share {bound_s / step_s:.3f}; one more "
        f"step by hand: forward + backward {fwd_bwd_ms:.1f} ms, AdamW "
        f"{adamw_ms:.1f} ms (CUDA events), gradient norm {gnorm:.4f}; "
        f"peak memory {peak / 1e9:.2f} "
        f"GB (params + grads + moments {STATE_BYTES * n / 1e9:.2f} GB, "
        f"computed); {card}")
    del tr, out, params, grads, batch
    torch.cuda.empty_cache()
    return res


def train_resume(device) -> dict:
    """Phase 14d: the qwen2.5-3b smoke config on the card through the
    Trainer (seed params, bf16 as the specs), microbatches 2: 20 steps
    straight; 10 steps stopped by the preemption flag (raised while the
    10th STEP event is emitted), then a resume from LATEST for 10 more;
    and 30 steps.  Gated: the two 20-step trajectories bit-identical, and
    the 30-step run's mean of its last 5 losses below its first 5."""
    import shutil
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import DecoderLM
    from repro_torch.train import (AdamW, TrainConfig, Trainer,
                                   cosine_schedule)

    t0 = time.perf_counter()
    cfg = get_smoke_config("qwen2.5-3b").replace(dtype="float32",
                                                  remat=False)
    work = Path(__file__).resolve().parent / "build" / "chip_smoke" / "train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    flag = work / "PREEMPT"

    def trainer(steps, total, ckpt_dir=None, hook=None):
        tc = TrainConfig(steps=steps, microbatches=2, log_every=1,
                         ckpt_every=50, ckpt_dir=ckpt_dir,
                         preempt_flag=str(flag))
        return Trainer(DecoderLM(cfg),
                       AdamW(lr=cosine_schedule(1e-3, 10, total)),
                       train_feed(cfg, 64, 8), tc, event_hook=hook,
                       device=device)

    def raise_flag(ev):
        if ev.kind == "STEP" and ev.step == 10:
            flag.touch()
    full = trainer(20, 20).run()
    ck = str(work / "ck")
    first_tr = trainer(20, 20, ck, raise_flag)
    first = first_tr.run()
    kinds = [e.kind for e in first_tr.events]
    flag.unlink()
    second = trainer(20, 20, ck).run(resume=True)
    long_run = trainer(30, 30).run()
    resumed = first["losses"] + second["losses"]
    same = resumed == full["losses"]
    l30 = long_run["losses"]
    head, tail = sum(l30[:5]) / 5, sum(l30[-5:]) / 5
    log(f"training resume on the card, qwen2.5-3b smoke config, "
        f"microbatches 2, batch 8 x 64: preempted at step {first['step']} "
        f"(events {kinds[-3:]}), resumed to {second['step']}; 20-step "
        f"losses straight {[round(x, 6) for x in full['losses'][::5]]}... "
        f"and resumed bit-identical: {same}; 30 steps: mean of the first "
        f"5 {head:.6f}, of the last 5 {tail:.6f}; "
        f"{time.perf_counter() - t0:.1f} s")
    if first["step"] != 10 or kinds[-2:] != ["CKPT", "PREEMPT"]:
        fail(f"training resume: the preempted run stopped at "
             f"{first['step']} with events {kinds[-3:]}")
    if not same:
        fail("training resume: the resumed losses differ from the "
             "uninterrupted run's")
    if not tail < head:
        fail(f"training: the loss did not fall over 30 steps ({head} -> "
             f"{tail})")
    del full, first, second, long_run
    torch.cuda.empty_cache()
    return {"bit_identical": same, "preempted_at": 10,
            "loss_first5_mean": head, "loss_last5_mean": tail,
            "s": time.perf_counter() - t0}


def phase_training(device, card) -> dict:
    """Phase 14: training, on no kernel of the port (plain PyTorch
    products and autograd; the five kernels' launch counts must stay 0
    over the whole phase)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t_phase = time.perf_counter()
    log(f"training phase starts with {torch.cuda.memory_allocated() / 1e9:.2f}"
        f" GB allocated")
    reset_launch_counts()
    result = {"card_vs_cpu": [train_card_vs_cpu(a, device) for a in (
        "qwen2.5-3b", "musicgen-medium", "deepseek-v2-lite-16b")]}
    result["qwen2.5-3b"] = train_full("qwen2.5-3b", device, card, 4)
    result["musicgen-medium"] = train_full("musicgen-medium", device, card, 2)
    result["resume"] = train_resume(device)
    counts = launch_counts()
    log(f"training launches of the five kernels: {counts} (the training "
        f"path runs plain PyTorch products and autograd, no kernel of the "
        f"port)")
    if any(counts.values()):
        fail(f"training launched a serving kernel: {counts}")
    result["launches"] = counts
    result["phase_s"] = time.perf_counter() - t_phase
    return result


# ---------------------------------------------------------------------------
# The model's other paths: the recurrent families' training, and prefill /
# decode_step on a contiguous cache
# ---------------------------------------------------------------------------
def as_streams(prompts, outs):
    """Greedy streams in the shape `check_identity` reads."""
    from types import SimpleNamespace
    return [SimpleNamespace(rid=i, prompt=p, out_tokens=[int(t) for t in o])
            for i, (p, o) in enumerate(zip(prompts, outs))]


def zero_cache(model, b: int, max_seq: int, kv_dtype, device):
    """`decode_step`'s contiguous cache (`cache_specs`), zeros."""
    import torch
    from repro_torch.models.common import map_specs
    return map_specs(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                           device=device),
                     model.cache_specs(b, max_seq, kv_dtype))


def engine_streams(model, params, device, prompts, n_new, kv_dtype):
    """The paged engine's greedy streams of `prompts` (INT4, CUDA graphs,
    `kv_dtype` pools)."""
    from repro_torch.serve import PagedServeEngine, ServeConfig
    eng = PagedServeEngine(model, params, ServeConfig(
        precision="int4", kv_dtype=kv_dtype, max_batch=4, max_seq=256,
        page_size=16, prefill_chunk=16), device=device)
    reqs, _, _ = run_wave(eng, list(prompts), n_new, 0)
    del eng
    return reqs


def contiguous_qwen(device, card, checks: Checks, timings) -> tuple:
    """Phase 15b: qwen2.5-3b at full width and depth on phase 3's INT4
    weights, a bf16 `cache_specs` cache of batch 4 x 256: `prefill` of 4
    prompts of 32 tokens, their K/V rows copied into the cache, then 32
    greedy `decode_step`s (eager).  Gated: the tokens equal the paged
    engine's greedy stream on the same prompts with bf16 KV (or diverge
    at a near-tie, logged); the launches of each decode step are 181
    cim_gemv, 36 swiglu_qgemv, 36 flash_decode and no paged kernel.
    Printed: prefill ms, the decode step's wall median beside its bytes
    bound, and the device time of the `decode_attention` wrapper's
    (b, S, g, hd) -> (b * g, S, hd) copies of a step.  Then, on the live
    cache (b * g = 8, S = 256, qpk 8, bf16): each layer's
    `decode_attention` at pos 32, 48 and 63 against its plain version,
    and the step's 36 `flash_decode` calls at pos 48 timed into
    `timings["flash_decode"]` (graph replay, eager, plain and
    `scaled_dot_product_attention` with q in bf16, beside the bound of
    the K/V rows up to pos read once)."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.ops import decode_attention

    t0 = time.perf_counter()
    model, params = build_full_model(device)
    cfg = model.cfg
    L, g, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd()
    b, P, n_dec, S = 4, 32, 32, 256
    prompts = np.random.default_rng(15).integers(
        0, cfg.vocab, (b, P)).astype(np.int32)
    cache = zero_cache(model, b, S, torch.bfloat16, device)
    reset_launch_counts()
    torch.cuda.synchronize()
    t_pre = time.perf_counter()
    with torch.no_grad():
        logits, kv = model.prefill(
            params, {"tokens": torch.from_numpy(prompts).to(device)})
        for k in ("k", "v"):
            cache["attn"][k][:, :, :P].copy_(kv["attn"][k])
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t_pre) * 1e3
    prefill_counts = launch_counts()
    tok = logits[:, -1].argmax(-1)
    outs, step_ms = [tok], []
    reset_launch_counts()
    with torch.no_grad():
        for i in range(n_dec):
            t = time.perf_counter()
            logits, cache = model.decode_step(
                params, cache, {"tokens": tok[:, None]},
                torch.tensor(P + i, dtype=torch.int32, device=device))
            tok = logits[:, 0].argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            outs.append(tok)
    counts = launch_counts()
    per_step = {"cim_gemv": 181, "swiglu_qgemv": 36, "flash_decode": 36,
                "paged_flash_decode": 0, "paged_flash_verify": 0}
    if counts != {k: n * n_dec for k, n in per_step.items()}:
        fail(f"contiguous decode: launches {counts} over {n_dec} steps, "
             f"expected {per_step} a step")
    outs = torch.stack(outs, 1).cpu().numpy()
    ref = engine_streams(model, params, device, prompts, n_dec + 1, "bf16")
    near = check_identity("contiguous decode vs the paged engine (bf16 KV)",
                          ref, as_streams(prompts, outs), model, params,
                          device)
    # the step's bound: packed weights and activations, and the bf16 K/V
    # rows up to the mean position read once
    cost = step_bounds(model, params, b, 1, [P + n_dec // 2] * b)
    kv_bytes = L * b * (P + n_dec // 2 + 1) * g * hd * 2 * 2
    nbytes = cost["cim_gemv"][0] + cost["swiglu_qgemv"][0] + kv_bytes
    b_ms, b_by = bound(nbytes, cost["cim_gemv"][1] + cost["swiglu_qgemv"][1])
    med = float(np.median(step_ms[1:]))
    # the wrapper's transpose copies, on their own: a step's 36 layers
    ck, cv = cache["attn"]["k"], cache["attn"]["v"]
    copy_ms = graph_time_ms(lambda: [
        x[i].transpose(1, 2).reshape(b * g, S, hd)
        for i in range(L) for x in (ck, cv)])
    qpk = cfg.q_per_kv()
    gen = torch.Generator(device=device).manual_seed(15)
    q = torch.randn(b, g, qpk, hd, generator=gen, device=device)
    pos = torch.tensor(P + n_dec - 1, dtype=torch.int32, device=device)
    attn_ms = graph_time_ms(lambda: [decode_attention(q, ck[i], cv[i], pos)
                                     for i in range(L)])
    # flash_decode at the shape this path gives it, on the live cache
    for p_ in (P, P + n_dec // 2, P + n_dec - 1):
        pt = torch.tensor(p_, dtype=torch.int32, device=device)
        for i in range(L):
            checks.compare(
                "flash_decode", f"decode_step cache layer {i} bf16 "
                f"b*g={b * g} S={S} pos={p_}",
                decode_attention(q, ck[i], cv[i], pt),
                decode_attention(q, ck[i], cv[i], pt, use_kernel=False))
    bg, pos_t = b * g, P + n_dec // 2
    pt = torch.tensor(pos_t, dtype=torch.int32, device=device)
    qf = q.reshape(bg, qpk, hd)
    kfs = [ck[i].transpose(1, 2).reshape(bg, S, hd) for i in range(L)]
    vfs = [cv[i].transpose(1, 2).reshape(bg, S, hd) for i in range(L)]

    def fd_step(fn):
        for i in range(L):
            fn(qf, kfs[i], vfs[i], pt)

    def sdpa(qx, kx, vx, _):
        return torch.nn.functional.scaled_dot_product_attention(
            qx.to(kx.dtype), kx[:, :pos_t + 1], vx[:, :pos_t + 1])

    time_calls(timings, "flash_decode",
               f"{L} calls of a contiguous decode step, b*g={bg}, S={S}, "
               f"pos={pos_t}, qpk={qpk}, bf16 cache (the live one), the "
               "library with q in bf16",
               fd_step, flash_decode, flash_decode_plain,
               L * (2 * bg * (pos_t + 1) * hd * 2 + 2 * qf.numel() * 4),
               L * bg * qpk * (pos_t + 1) * hd * 4, library=sdpa)
    del kfs, vfs
    res = {"arch": "qwen2.5-3b", "layers": L, "batch": b, "prompt": P,
           "decode_steps": n_dec, "max_seq": S, "cache": "bf16",
           "prefill_ms": prefill_ms, "prefill_launches": prefill_counts,
           "decode_launches": counts, "decode_step_ms": step_ms,
           "decode_step_ms_median": med, "bound_ms": b_ms,
           "bound_by": b_by, "bound_bytes": nbytes,
           "bound_share": b_ms / med, "near_ties": near,
           "transpose_copies_ms": copy_ms,
           "decode_attention_36_calls_ms": attn_ms,
           "s": time.perf_counter() - t0, "card": card}
    log(f"contiguous decode, qwen2.5-3b x{L} at full width, INT4, bf16 "
        f"cache {b} x {S}: prefill of {b} x {P} tokens {prefill_ms:.1f} ms "
        f"(launches {prefill_counts}); {n_dec} greedy decode_steps (eager), "
        f"step wall median {med:.3f} ms (first steps "
        f"{[round(x, 3) for x in step_ms[:4]]}), bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e9:.4f} GB), share "
        f"{b_ms / med:.4f}; launches a step {per_step}; the wrapper's "
        f"(b, S, g, hd) -> (b*g, S, hd) copies of K and V, 36 layers: "
        f"{copy_ms:.4f} ms device time, of 36 decode_attention calls' "
        f"{attn_ms:.4f} ms; {card}")
    del model, params, cache, kv, logits
    torch.cuda.empty_cache()
    return counts, res


def contiguous_xlstm(device, card) -> tuple:
    """Phase 15c: xlstm-1.3b at full width and depth on INT4 (phase 11's
    weights: seed 0, groups of 128), 16 `decode_step`s from the zero
    state on 4 lanes: 8 prompt tokens fed one at a time, then 8 greedy
    steps (9 tokens a lane).  Gated: the tokens equal the paged
    engine's `serve_step` stream on the same prompts (or a logged
    near-tie); 265 cim_gemv launches a step.  Printed: step ms."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import build_model

    t0 = time.perf_counter()
    cfg = get_config(XLSTM_ARCH).replace(dtype="float32", remat=False)
    model, params = build_model(cfg, "int4", 128, device, seed=0)
    b, P, steps = 4, 8, 16
    prompts = np.random.default_rng(16).integers(
        0, cfg.vocab, (b, P)).astype(np.int32)
    cache = zero_cache(model, b, 256, torch.bfloat16, device)
    feed = torch.from_numpy(prompts).to(device)
    outs, step_ms = [], []
    reset_launch_counts()
    with torch.no_grad():
        for t in range(steps):
            tok = feed[:, t] if t < P else outs[-1]
            t1 = time.perf_counter()
            logits, cache = model.decode_step(params, cache,
                                              {"tokens": tok[:, None]}, t)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            if t >= P - 1:
                outs.append(logits[:, 0].argmax(-1))
    counts = launch_counts()
    per_step = step_launches(cfg, 1)
    if counts != {k: n * steps for k, n in per_step.items()}:
        fail(f"xlstm decode_step: launches {counts} over {steps} steps, "
             f"expected {per_step} a step")
    outs = torch.stack(outs, 1).cpu().numpy()
    ref = engine_streams(model, params, device, prompts, outs.shape[1],
                         "auto")
    near = check_identity("xlstm decode_step vs the engine's serve_step",
                          ref, as_streams(prompts, outs), model, params,
                          device)
    med = float(np.median(step_ms[1:]))
    res = {"arch": XLSTM_ARCH, "layers": cfg.n_layers, "batch": b,
           "steps": steps, "decode_launches": counts,
           "decode_step_ms": step_ms, "decode_step_ms_median": med,
           "near_ties": near, "s": time.perf_counter() - t0, "card": card}
    log(f"contiguous decode, {XLSTM_ARCH} x{cfg.n_layers} at full width, "
        f"INT4, {b} lanes from the zero state: {steps} decode_steps (eager), "
        f"step wall median {med:.3f} ms; launches a step {per_step}; "
        f"{card}")
    del model, params, cache
    torch.cuda.empty_cache()
    return counts, res


def phase_other_paths(device, card, checks: Checks, timings) -> tuple:
    """Phase 15: (a) xlstm-1.3b (full depth) and zamba2-7b (27 layers) at
    full width through the Trainer in f32, 4 steps at batch 8 x 64, and
    card-vs-CPU loss and gradients on the smallest full-width copies the
    families allow (xlstm: one group of 8 layers; zamba: one group and
    the tail, 7 layers) at batch 1 x 16; no kernel launches (float
    weights); (b) qwen2.5-3b's prefill and contiguous decode through
    `flash_decode`, each layer's call checked against its plain version
    and the step's calls timed at that shape into `timings`; (c)
    xlstm-1.3b's decode_step from the zero state."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t_phase = time.perf_counter()
    log(f"other paths phase starts with "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    reset_launch_counts()
    result = {"card_vs_cpu": [
        train_card_vs_cpu(XLSTM_ARCH, device, n_layers=8, seq=16,
                          batch_size=1),
        train_card_vs_cpu(ZAMBA_ARCH, device, n_layers=7, seq=16,
                          batch_size=1)]}
    result[XLSTM_ARCH] = train_full(XLSTM_ARCH, device, card, 4)
    result[ZAMBA_ARCH] = train_full(ZAMBA_ARCH, device, card, 4,
                                    n_layers=27)
    counts = launch_counts()
    if any(counts.values()):
        fail(f"recurrent training launched a serving kernel: {counts}")
    by_path = {}
    by_path["contiguous_decode"], result["qwen2.5-3b decode"] = \
        contiguous_qwen(device, card, checks, timings)
    by_path["xlstm_contiguous_decode"], result["xlstm decode"] = \
        contiguous_xlstm(device, card)
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"other paths phase {result['phase_s']:.1f} s")
    return by_path, result


# ---------------------------------------------------------------------------
# tensor-parallel serving: qwen2.5-3b at tp = 2, two ranks sharing the card
# ---------------------------------------------------------------------------
TP = 2
TP_REF = {}       # what phase 16 is held to: phase 3's and 4's streams,
                  # the weights' digest, phase 3's eager decode step median


def weights_digest(params) -> str:
    """sha256 over every leaf of a param tree in key order: its name, and
    its bytes (a QTensor's packed data, then its scales)."""
    import hashlib
    import torch
    from repro_torch.quant.qarray import QTensor
    h = hashlib.sha256()

    def walk(tree, name):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{name}/{k}")
            return
        h.update(name.encode())
        parts = [tree.data, tree.scales] if isinstance(tree, QTensor) \
            else [tree]
        for t in parts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
    walk(params, "")
    return h.hexdigest()


def tp_serve(eng, prompts, n_new):
    """Serve `prompts` to the end, eagerly, synchronizing every step:
    (requests, [(decode step wall ms, its collectives' host ms)])."""
    import torch
    from repro_torch.dist import collective_seconds
    from repro_torch.serve import ServeRequest
    reqs = [ServeRequest(prompt=p.copy(), max_new_tokens=n_new, rid=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    steps = []
    while eng.busy:
        pre = eng.prefill_calls
        c0 = sum(collective_seconds().values())
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if eng.prefill_calls == pre:
            steps.append(((time.perf_counter() - t0) * 1e3,
                          (sum(collective_seconds().values()) - c0) * 1e3))
    return reqs, steps


def tp_run(tag, label, e, model, prompts, n_new, want, what, device,
           per_call=None):
    """Serve `prompts` at tp = 2 on engine `e` (`tp_serve`) with the
    launches, launched kernels and collectives counted from 0: launches
    exactly the per-call counts x calls, collectives `per_call` a call
    (by default 2 L + 2: 2 L + 1 all-reduces, 1 gather), `n_new` tokens
    in range a request, streams `want` (`what` names them) but for
    logged near-ties; returns the run's record."""
    from types import SimpleNamespace

    import numpy as np
    import torch
    from repro_torch.dist import (collective_counts, collective_seconds,
                                  reset_collective_counts)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    cfg = model.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    reset_collective_counts()
    t_run = time.perf_counter()
    reqs, steps = tp_serve(e, prompts, n_new)
    run_s = time.perf_counter() - t_run
    counts, coll = launch_counts(), collective_counts()
    calls = e.prefill_calls + e.decode_calls + e.verify_calls
    expect = expected_launches(cfg, e.prefill_calls, e.decode_calls,
                               e.verify_calls)
    per_call = per_call or {"all_reduce": 2 * cfg.n_layers + 1,
                            "all_gather": 1}
    want_coll = {k: v * calls for k, v in per_call.items()}
    log(f"{tag} {label}: {e.prefill_calls} prefill + {e.decode_calls} "
        f"decode + {e.verify_calls} verify calls in {run_s:.2f} s; "
        f"launches {counts}, expected {expect}; collectives {coll}, "
        f"expected {want_coll}")
    if counts != expect:
        fail(f"{tag} {label}: launches {counts} != {expect}")
    if coll != want_coll:
        fail(f"{tag} {label}: collectives {coll} != {want_coll}")
    if label == "ngram" and e.verify_calls <= 0:
        fail(f"{tag}: the n-gram run made no verify call")
    got = [r.out_tokens for r in reqs]
    if any(len(t) != n_new or not all(0 <= x < cfg.vocab for x in t)
           for t in got):
        fail(f"{tag} {label}: generated {[len(t) for t in got]} tokens, "
             f"expected {n_new} each in range")
    ref_reqs = [SimpleNamespace(prompt=p, out_tokens=w, rid=i)
                for i, (p, w) in enumerate(zip(prompts, want))]
    near = check_identity(f"{tag} {label} vs {what}", ref_reqs, reqs, model,
                          e.params, device, e._serve_fn, TP)
    wall = [ms for ms, _ in steps]
    return {"streams": got, "near_ties": near, "launches": counts,
            "collectives": coll, "calls": calls,
            "collectives_per_call": {k: v // calls for k, v in coll.items()},
            "collective_s": collective_seconds(),
            "step_ms_median": float(np.median(wall)),
            "step_collective_ms_median": float(np.median(
                [c for _, c in steps])),
            "collective_share": sum(c for _, c in steps) / sum(wall),
            "steps": len(steps), "run_s": run_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "summary_tp": e.summary()["tp"],
            "step_graphs": e.summary()["step_graphs"]}


def tp_weights(eng):
    """This rank's packed leaves of a decode step's kernels, by layer:
    {name: QTensor} of the projections (GQA's q/k/v/o or MLA's wq / w_dkv
    / wo, not the w_uk / w_uv the step dequantizes; shared experts; a
    dense layer's gate / up / down) and the expert stacks; and the
    head."""
    p = eng.params
    layers = []
    for name in ("first_blocks", "blocks"):
        if name not in p:
            continue
        blocks = p[name]
        for i in range(_lead_dim(blocks)):
            layers.append({f"{part} {k}": v[i]
                           for part in ("attn", "ffn")
                           for k, v in blocks[part].items()
                           if hasattr(v, "nbytes_packed")
                           and k not in ("w_uk", "w_uv")})
    head = p["embed"] if eng.model.cfg.tie_embeddings else p["head"]
    return layers, head


def _kn(w):
    """(K, N) of a packed projection or table."""
    return ((w.orig_shape[-1], w.orig_shape[-2]) if w.axis == -1
            else tuple(w.orig_shape[-2:]))


def tp_kernel_checks(eng, device, rank, counts=None):
    """Each kernel at this rank's shapes against its plain version, every
    call twice (bitwise equal), phase 2's tolerances: cim_gemv on each
    2-D projection of the first and last layers by name (shared experts
    included; a name the two layers share, same shape on both, is
    checked on the last layer's leaf, so deepseek's dense w_down comes
    from layer 0 and its attention from the last layer) and the head at
    M = 1, 4, 20; swiglu_qgemv on layer 0's dense gate / up; with
    `counts` (a MoE model: per MoE layer, the router's global expert
    counts of a decode step) the first MoE layer's three stacks at the
    decode capacity, counts those of this rank's experts (rows past a
    count hold NaN, compared on the counted rows); GQA's paged kernels
    at the rank's kv heads, lanes at 1024 / 777 / 301 / 45 keys."""
    import torch
    from repro_torch.kernels.cim_gemv import cim_gemv, cim_gemv_plain
    from repro_torch.kernels.paged_flash_decode import (paged_decode_plain,
                                                        paged_flash_decode,
                                                        paged_flash_verify,
                                                        paged_verify_plain)
    from repro_torch.kernels.swiglu_gemv import swiglu_plain, swiglu_qgemv
    from repro_torch.models.ffn import capacity
    checks = Checks()
    cfg = eng.model.cfg
    gen = torch.Generator(device=device).manual_seed(170 + rank)
    layers, head = tp_weights(eng)
    ws = {"head": head}
    for lw in (layers[0], layers[-1]):
        ws.update({k: w for k, w in lw.items() if w.ndim == 2})
    shapes = {}
    for m in (1, 4, 20):
        for name, w in ws.items():
            if name in ("ffn w_gate", "ffn w_up"):
                continue
            k, n = _kn(w)
            shapes[name] = (k, n, w.group)
            x = torch.randn(m, k, generator=gen, device=device)
            label = f"rank {rank} {name} {k}->{n} g{w.group} M={m}"
            out = cim_gemv(x, w)
            checks.compare("cim_gemv", label, out, cim_gemv_plain(x, w))
            checks.repeat("cim_gemv", label, out, cim_gemv(x, w))
        if "ffn w_gate" in ws:
            wg, wu = ws["ffn w_gate"], ws["ffn w_up"]
            x = torch.randn(m, cfg.d_model, generator=gen, device=device)
            label = (f"rank {rank} gate/up {cfg.d_model}->"
                     f"{wg.data.shape[1]} M={m}")
            shapes["ffn gate/up"] = (cfg.d_model, wg.data.shape[1], wg.group)
            out = swiglu_qgemv(x, wg, wu)
            checks.compare("swiglu_qgemv", label, out,
                           swiglu_plain(x, wg, wu))
            checks.repeat("swiglu_qgemv", label, out,
                          swiglu_qgemv(x, wg, wu))
    groups, cap = capacity(cfg, eng.max_batch) if counts else (0, 0)
    C = groups * cap
    moe = next((lw for lw in layers if "ffn we_gate" in lw), {})
    El = moe["ffn we_gate"].orig_shape[0] if counts else 0
    local = torch.tensor(counts[0][rank * El:(rank + 1) * El] if counts
                         else [], dtype=torch.int32, device=device)
    rows = torch.arange(C, device=device)[None] < local[:, None]
    for name in ("ffn we_gate", "ffn we_up", "ffn we_down") if counts \
            else ():
        w = moe[name]
        k, n = w.orig_shape[-2:]
        shapes[name] = (El, k, n, w.group)
        x = torch.randn(El, C, k, generator=gen, device=device)
        xn = torch.where(rows[..., None], x, float("nan"))
        label = (f"rank {rank} stack {name[4:]} {k}->{n} g{w.group} E={El} "
                 f"C={C}, {int((local > 0).sum())} experts with rows")
        out = cim_gemv(xn, w, local)
        checks.compare("cim_gemv", label, out[rows],
                       cim_gemv_plain(x, w)[rows])
        checks.repeat("cim_gemv", label, out[rows],
                      cim_gemv(xn, w, local)[rows])
    if cfg.attn_kind != "mla":
        b, g, qpk, hd = 4, cfg.n_kv_heads // TP, cfg.q_per_kv(), cfg.hd()
        kp, vp, ks, vs, tables = int8_pools(gen, device, b, 64, g, hd)
        lengths = torch.tensor([1024, 777, 301, 45], dtype=torch.int32,
                               device=device)
        q = torch.randn(b, g, qpk, hd, generator=gen, device=device)
        args = (q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
        label = f"rank {rank} int8 g={g} qpk={qpk} hd={hd} len<=1024"
        out = paged_flash_decode(*args)
        checks.compare("paged_flash_decode", label, out,
                       paged_decode_plain(*args))
        checks.repeat("paged_flash_decode", label, out,
                      paged_flash_decode(*args))
        qv = torch.randn(b, 5, g, qpk, hd, generator=gen, device=device)
        args = (qv, kp, vp, tables, lengths - 5, 0, 0.0, ks, vs)
        label = f"rank {rank} int8 s=5 g={g} qpk={qpk} hd={hd}"
        out = paged_flash_verify(*args)
        checks.compare("paged_flash_verify", label, out,
                       paged_verify_plain(*args))
        checks.repeat("paged_flash_verify", label, out,
                      paged_flash_verify(*args))
    return {k: {"max_abs_err": e, "tol": t, "worst_case": lab}
            for k, (e, t, lab) in checks.worst.items()}, shapes


def tp_step_timing(eng, device, rank, counts=None,
                   lengths=(1024, 777, 301, 45)):
    """One rank's decode step kernel calls (batch 4, lanes at `lengths`
    keys after the step): every packed projection and the head through
    cim_gemv, with `counts` (as `tp_kernel_checks`) the stacks at the
    decode capacity over this rank's experts, a dense layer's
    swiglu_qgemv, GQA's paged_flash_decode at the rank's kv heads (INT8
    pools); timed as in phase 2 (CUDA-graph replays of the calls alone),
    beside their bytes bound: the weights and scales read once (of the
    stacks, the experts this rank kept), the activations in and out, the
    K/V rows and the tables.  qwen2.5-3b's is 181 cim_gemv, 36
    swiglu_qgemv and 36 paged_flash_decode calls."""
    import torch
    from repro_torch.kernels.cim_gemv import cim_gemv
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.kernels.swiglu_gemv import swiglu_qgemv
    from repro_torch.models.ffn import capacity
    cfg = eng.model.cfg
    M = eng.max_batch
    gen = torch.Generator(device=device).manual_seed(171)
    layers, head = tp_weights(eng)
    groups, cap = capacity(cfg, M) if counts else (0, 0)
    C = groups * cap
    xs = {}

    def x_of(*shape):
        if shape not in xs:
            xs[shape] = torch.randn(*shape, generator=gen, device=device)
        return xs[shape]
    calls = {"cim_gemv": [], "swiglu_qgemv": [], "paged_flash_decode": []}
    nbytes = dict.fromkeys(calls, 0)
    kept = []
    moe_i = 0
    for lw in layers:
        for name, w in lw.items():
            if name in ("ffn w_gate", "ffn w_up") or w.ndim != 2:
                continue
            k, n = _kn(w)
            calls["cim_gemv"].append((w, x_of(M, k), None))
            nbytes["cim_gemv"] += w.nbytes_packed() + 4 * M * (k + n)
        if "ffn w_gate" in lw:
            wg, wu = lw["ffn w_gate"], lw["ffn w_up"]
            k, n = _kn(wg)
            calls["swiglu_qgemv"].append((wg, wu, x_of(M, k)))
            nbytes["swiglu_qgemv"] += (wg.nbytes_packed() + wu.nbytes_packed()
                                       + 4 * M * (k + n))
        if "ffn we_gate" in lw:
            El = lw["ffn we_gate"].orig_shape[0]
            cc = counts[moe_i][rank * El:(rank + 1) * El]
            moe_i += 1
            kept.append(sum(c > 0 for c in cc))
            local = torch.tensor(cc, dtype=torch.int32, device=device)
            ws = [lw[f"ffn {k}"] for k in ("we_gate", "we_up", "we_down")]
            for w in ws:
                k = w.orig_shape[-2]
                calls["cim_gemv"].append((w, x_of(El, C, k), local))
            nbytes["cim_gemv"] += stack_cost(ws, cc)[0]
    k, n = _kn(head)
    calls["cim_gemv"].append((head, x_of(M, k), None))
    nbytes["cim_gemv"] += head.nbytes_packed() + 4 * M * (k + n)
    if cfg.attn_kind != "mla":
        g, qpk, hd = cfg.n_kv_heads // TP, cfg.q_per_kv(), cfg.hd()
        pages = -(-max(lengths) // 16)
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        q = x_of(M, g, qpk, hd)
        for _ in range(len(layers)):
            kp, vp, ks, vs, tables = int8_pools(gen, device, M, pages, g,
                                                hd)
            calls["paged_flash_decode"].append(
                (q, kp, vp, tables, lens, 0, 0.0, ks, vs))
            nbytes["paged_flash_decode"] += (
                sum(lengths) * g * (2 * hd + 2 * 2) + 2 * q.numel() * 4
                + M * (pages + 1) * 4)

    def run(kernel):
        def fn():
            for c in calls[kernel]:
                if kernel == "cim_gemv":
                    w, x, cnt = c
                    cim_gemv(x, w) if cnt is None else cim_gemv(x, w, cnt)
                elif kernel == "swiglu_qgemv":
                    swiglu_qgemv(c[2], c[0], c[1])
                else:
                    paged_flash_decode(*c)
        return fn
    out = {}
    for kernel in calls:
        if calls[kernel]:
            ms = graph_time_ms(run(kernel))
            out[kernel] = {"calls": len(calls[kernel]), "ms": ms,
                           "bound_ms": bound(nbytes[kernel], 0.0)[0],
                           "bytes": nbytes[kernel]}

    def all_calls():
        for kernel in calls:
            run(kernel)()
    total = sum(nbytes.values())
    out["step"] = {"ms": graph_time_ms(all_calls),
                   "bound_ms": bound(total, 0.0)[0], "bytes": total,
                   "experts_kept_per_layer": kept}
    return out


def join_rank_group(rank, init):
    """A spawned rank's set-up, as `main`'s: TF32 off, bf16 products
    accumulated in f32, cuda:0, and the gloo group of TP ranks at
    `init`.  Returns the device."""
    import datetime

    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=TP,
                            timeout=datetime.timedelta(seconds=300))
    return torch.device("cuda", 0)


def spawn_ranks(fn, refs, name):
    """Run `fn(rank, refs, init, out_dir)` in TP spawned processes (gloo
    over loopback, all on cuda:0), each writing out_dir/rank<r>.json;
    returns (those records in rank order, the seconds it took)."""
    import socket

    import torch
    import torch.multiprocessing as mp
    torch.cuda.empty_cache()
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.glob("rank*.json"):
        f.unlink()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    mp.start_processes(fn, args=(refs, f"tcp://127.0.0.1:{port}",
                                 str(out_dir)),
                       nprocs=TP, join=True, start_method="spawn")
    return ([json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(TP)], time.perf_counter() - t0)


def tp_rank(rank, ref, init, out_dir):
    """One rank of phase 16 (spawned): qwen2.5-3b from phase 3's seed,
    its shard served at tp = 2 on a gloo group over loopback."""
    import torch
    import torch.distributed as dist
    device = join_rank_group(rank, init)
    from repro_torch.serve import PagedServeEngine, ServeConfig
    from repro_torch.spec import SpecConfig

    tag = f"phase 16 rank {rank}"
    t0 = time.perf_counter()
    model, params = build_full_model(device)
    digest = weights_digest(params)
    same = digest == ref["digest"]
    log(f"{tag}: qwen2.5-3b INT4 drawn in {time.perf_counter() - t0:.1f} s; "
        f"unsharded weights sha256 {digest[:16]}..., phase 3's "
        f"{ref['digest'][:16]}... ({'equal' if same else 'DIFFERENT'})")
    if not same:
        fail(f"{tag}: the unsharded weights differ from phase 3's")
    cfg = model.cfg
    serve_cfg = ServeConfig(precision="int4", kv_dtype="auto", max_batch=4,
                            max_seq=128, page_size=16, prefill_chunk=16,
                            tp=TP)
    eng = PagedServeEngine(model, params, serve_cfg, device=device)
    spec_eng = PagedServeEngine(model, params, serve_cfg, device=device,
                                spec=SpecConfig(k=4))
    del params
    torch.cuda.empty_cache()
    if eng.runner.graphs or spec_eng.runner.graphs:
        fail(f"{tag}: steps captured as CUDA graphs at tp = {TP}")
    pools = eng.cache.pools["attn"]
    wq = eng.params["blocks"]["attn"]["wq"]
    log(f"{tag}: shard wq {tuple(wq.orig_shape)}, w_down "
        f"{tuple(eng.params['blocks']['ffn']['w_down'].orig_shape)} g"
        f"{eng.params['blocks']['ffn']['w_down'].group}, table "
        f"{tuple(eng.params['embed'].orig_shape)}, pools "
        f"{tuple(pools['k'].shape)} {pools['k'].dtype}; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    if pools["k"].shape[-2] != cfg.n_kv_heads // TP:
        fail(f"{tag}: pools hold {pools['k'].shape[-2]} kv heads")

    per_step = step_launches(cfg, 1)
    if (per_step["cim_gemv"], per_step["swiglu_qgemv"],
            per_step["paged_flash_decode"]) != (181, 36, 36):
        fail(f"{tag}: a decode step's launches {per_step}")
    res = {"rank": rank}
    for label, e, prompts, n_new, want, what in (
            ("wave", eng, ref["wave"], 16, ref["wave_streams"], "phase 3"),
            ("ngram", spec_eng, ref["ngram_prompts"], 32,
             ref["ngram_streams"], "phase 4")):
        res[label] = tp_run(tag, label, e, model, prompts, n_new, want,
                            what, device)
    res["kernel_checks"], res["shapes"] = tp_kernel_checks(eng, device, rank)
    dist.barrier()
    if rank == 0:                     # rank 1 waits: the card is rank 0's
        res["timing"] = tp_step_timing(eng, device, rank)
    dist.barrier()
    res["resident_gb"] = torch.cuda.memory_allocated() / 1e9
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def phase_tp(card):
    """Phase 16: spawn two ranks (gloo over loopback, both on cuda:0),
    each serving qwen2.5-3b's shard at tp = 2; hold them to phase 3 and
    4 and to each other."""
    ranks, phase_s = spawn_ranks(tp_rank, TP_REF, "tp")
    for label in ("wave", "ngram"):
        if ranks[0][label]["streams"] != ranks[1][label]["streams"]:
            fail(f"phase 16 {label}: the ranks' streams differ")
        if ranks[0][label]["launches"] != ranks[1][label]["launches"]:
            fail(f"phase 16 {label}: the ranks' launches differ")
    w, t = ranks[0]["wave"], ranks[0]["timing"]
    log(f"phase 16 (tp = {TP}, two ranks on one card, {card}): decode step "
        f"wall median {w['step_ms_median']:.2f} ms (rank 0; rank 1 "
        f"{ranks[1]['wave']['step_ms_median']:.2f} ms) against phase 3's "
        f"eager tp = 1 {TP_REF['eager_decode_ms']:.2f} ms; collectives "
        f"{w['collectives_per_call']} a step, "
        f"{w['step_collective_ms_median']:.2f} ms of a step (median), "
        f"{100 * w['collective_share']:.1f} % of decode step wall; peak "
        f"memory {[round(r['wave']['peak_gb'], 3) for r in ranks]} GB a "
        f"rank; one rank's decode step kernels (graph replay): "
        + ", ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f} ms)"
                    for k, v in t.items())
        + f"; phase {phase_s:.1f} s")
    result = {"phase_s": phase_s, "card": card,
              "eager_tp1_decode_step_ms_median": TP_REF["eager_decode_ms"],
              "ranks": [{k: v for k, v in r.items()
                         if k not in ("wave", "ngram")}
                        | {lab: {k: v for k, v in r[lab].items()
                                 if k != "streams"}
                           for lab in ("wave", "ngram")} for r in ranks]}
    return ranks[0]["wave"]["launches"], ranks[0]["ngram"]["launches"], \
        result


# ---------------------------------------------------------------------------
# expert-parallel MoE and tensor-parallel MLA: qwen3-moe-235b-a22b x4 and
# deepseek-v2-lite-16b x8 at tp = 2, two ranks sharing the card
# ---------------------------------------------------------------------------
TP_MOE_REF = {}   # what phase 17 is held to, by arch: phase 9's / 10's
                  # weights digest, first wave and its eager streams,
                  # n-gram prompts and their streams without speculation,
                  # eager decode step median
# (arch, layers, cim_gemv / swiglu_qgemv / paged_flash_decode a decode
# step on each rank)
TP_MOE_ARCHS = ((MOE_ARCH, 4, (29, 0, 4)), (DS_ARCH, 8, (68, 1, 0)))


def tp_route_counts(eng):
    """Per MoE layer, the router's global expert counts of one batch-4
    decode step (tokens 0, lanes at 64 keys) through the engine's own
    tensor-parallel step, which every rank calls in lockstep (it writes
    the lanes' pages of a drained engine's pools)."""
    import numpy as np
    import torch
    b, mp, dev = eng.max_batch, eng.cache.max_pages, eng.device
    with RouteLog() as rl:
        eng._serve_fn(eng.params, eng.state,
                      {"tokens": torch.zeros(b, 1, dtype=torch.int32,
                                             device=dev)},
                      torch.from_numpy(np.arange(b * mp, dtype=np.int32)
                                       .reshape(b, mp)).to(dev),
                      torch.full((b,), 64, dtype=torch.int32, device=dev),
                      torch.ones(b, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
    return rl.counts


def tp_moe_rank(rank, refs, init, out_dir):
    """One rank of phase 17 (spawned): qwen3-moe x4 and deepseek x8 from
    phase 9's and 10's seed, each its shard served at tp = 2 on a gloo
    group over loopback."""
    import torch
    import torch.distributed as dist
    device = join_rank_group(rank, init)
    res = {"rank": rank}
    for arch, n_layers, want_step in TP_MOE_ARCHS:
        res[arch] = tp_moe_arch(rank, arch, n_layers, want_step, refs[arch],
                                device)
        torch.cuda.empty_cache()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def tree_gb(tree) -> float:
    """GB of a param tree's tensors (a QTensor's packed data and scales)."""
    if isinstance(tree, dict):
        return sum(tree_gb(v) for v in tree.values())
    if hasattr(tree, "nbytes_packed"):
        return tree.nbytes_packed() / 1e9
    return tree.numel() * tree.element_size() / 1e9


def tp_moe_arch(rank, arch, n_layers, want_step, ref, device):
    """This rank's part of phase 17 for one arch: draw (one rank at a
    time), shard, serve the wave and the n-gram prompts, check the
    kernels at its shapes and (rank 0) time its decode step's kernels."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_model
    from repro_torch.serve import PagedServeEngine, ServeConfig
    from repro_torch.spec import SpecConfig

    tag = f"phase 17 rank {rank} {arch}"
    cfg = get_config(arch).replace(dtype="float32", remat=False,
                                   n_layers=n_layers)
    mla = cfg.attn_kind == "mla"
    serve_cfg = ServeConfig(precision="int4", kv_dtype="auto",
                            max_batch=4, max_seq=128, page_size=16,
                            prefill_chunk=16, tp=TP)
    # one rank draws at a time: a stack is drawn as f32 and packed
    # through f32 temporaries (qwen3-moe x4's we_gate alone is 12.9
    # GB of f32), which two ranks at once would crowd the card with
    for turn in range(TP):
        if turn == rank:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model, params = build_model(cfg, "int4", 128, device,
                                        seed=0)
            torch.cuda.synchronize()
            draw_s = time.perf_counter() - t0
            draw_peak = torch.cuda.max_memory_allocated() / 1e9
            whole_gb = torch.cuda.memory_allocated() / 1e9
            digest = weights_digest(params)
            eng = PagedServeEngine(model, params, serve_cfg,
                                   device=device)
            spec_eng = PagedServeEngine(model, params, serve_cfg,
                                        device=device,
                                        spec=SpecConfig(k=4))
            del params
            torch.cuda.empty_cache()
        dist.barrier()
    resident = torch.cuda.memory_allocated() / 1e9
    shard_gb = tree_gb(eng.params)
    same = digest == ref["digest"]
    log(f"{tag}: x{n_layers} INT4 drawn in {draw_s:.1f} s, "
        f"{whole_gb:.2f} GB whole (peak {draw_peak:.2f} GB while "
        f"drawing), {resident:.2f} GB resident after sharding (two "
        f"engines, each its {shard_gb:.2f} GB shard and pools); "
        f"unsharded weights sha256 {digest[:16]}..., phase "
        f"{9 if arch == MOE_ARCH else 10}'s {ref['digest'][:16]}... "
        f"({'equal' if same else 'DIFFERENT'})")
    if not same:
        fail(f"{tag}: the unsharded weights differ from phase "
             f"{9 if arch == MOE_ARCH else 10}'s")
    if eng.runner.graphs or spec_eng.runner.graphs:
        fail(f"{tag}: steps captured as CUDA graphs at tp = {TP}")
    blocks = eng.params["blocks"]
    attn, ffn = blocks["attn"], blocks["ffn"]
    pools = eng.cache.pools["attn"]
    El = ffn["we_gate"].orig_shape[1]
    log(f"{tag}: shard stacks {tuple(ffn['we_gate'].orig_shape)} / "
        f"{tuple(ffn['we_down'].orig_shape)}, wq "
        f"{tuple(attn['wq'].orig_shape)}, wo "
        f"{tuple(attn['wo'].orig_shape)}, pools "
        + ", ".join(f"{k} {tuple(v.shape)} {v.dtype}"
                    for k, v in pools.items()))
    if El != cfg.moe.n_experts // TP:
        fail(f"{tag}: a rank holds {El} experts a stack")
    if mla:
        m = cfg.mla
        heads = attn["wq"].orig_shape[-1] // (m.qk_nope_head_dim
                                              + m.qk_rope_head_dim)
        if heads != cfg.n_heads // TP or pools["c_kv"].shape[-1] \
                != m.kv_lora_rank or attn["w_dkv"].orig_shape[-1] \
                != m.kv_lora_rank + m.qk_rope_head_dim:
            fail(f"{tag}: {heads} heads, latent pools "
                 f"{tuple(pools['c_kv'].shape)}")
    elif pools["k"].shape[-2] != cfg.n_kv_heads // TP:
        fail(f"{tag}: pools hold {pools['k'].shape[-2]} kv heads")
    per_step = step_launches(cfg, 1)
    got_step = (per_step["cim_gemv"], per_step["swiglu_qgemv"],
                per_step["paged_flash_decode"])
    if got_step != want_step:
        fail(f"{tag}: a decode step's launches {per_step}, expected "
             f"{want_step}")
    phase = 9 if arch == MOE_ARCH else 10
    out = {"draw_s": draw_s, "draw_peak_gb": draw_peak,
           "whole_gb": whole_gb, "resident_gb": resident,
           "shard_gb": shard_gb, "experts_per_rank": El}
    for label, e, prompts, n_new, want, what in (
            ("wave", eng, ref["wave"], 16, ref["wave_streams"],
             f"phase {phase}'s eager wave"),
            ("ngram", spec_eng, ref["ngram_prompts"], 24,
             ref["ngram_streams"], f"phase {phase}'s run without spec")):
        out[label] = tp_run(tag, label, e, model, prompts, n_new, want,
                            what, device)
    route = tp_route_counts(eng)
    out["kernel_checks"], out["shapes"] = tp_kernel_checks(eng, device,
                                                           rank, route)
    dist.barrier()
    if rank == 0:                 # rank 1 waits: the card is rank 0's
        out["timing"] = tp_step_timing(eng, device, rank, route,
                                       lengths=(65,) * 4)
    dist.barrier()
    return out


def phase_tp_moe(card):
    """Phase 17: spawn two ranks (gloo over loopback, both on cuda:0),
    each serving qwen3-moe x4 and then deepseek x8 at tp = 2; hold them
    to phases 9 and 10 and to each other."""
    ranks, phase_s = spawn_ranks(tp_moe_rank, TP_MOE_REF, "tp_moe")
    by_path, result = {}, {"phase_s": phase_s, "card": card}
    for arch, n_layers, _ in TP_MOE_ARCHS:
        a, b = ranks[0][arch], ranks[1][arch]
        for label in ("wave", "ngram"):
            if a[label]["streams"] != b[label]["streams"]:
                fail(f"phase 17 {arch} {label}: the ranks' streams differ")
            if a[label]["launches"] != b[label]["launches"]:
                fail(f"phase 17 {arch} {label}: the ranks' launches differ")
        w, t = a["wave"], a["timing"]
        tp1 = TP_MOE_REF[arch]["eager_decode_ms"]

        def gb(key, label=None):
            return [round((r[arch][label] if label else r[arch])[key], 3)
                    for r in ranks]
        log(f"phase 17 {arch} x{n_layers} (tp = {TP}, two ranks on one "
            f"card, {card}): decode step wall median "
            f"{w['step_ms_median']:.2f} ms (rank 0; rank 1 "
            f"{b['wave']['step_ms_median']:.2f} ms) against phase "
            f"{9 if arch == MOE_ARCH else 10}'s eager tp = 1 {tp1:.2f} ms; "
            f"collectives {w['collectives_per_call']} a step, "
            f"{w['step_collective_ms_median']:.2f} ms of a step (median), "
            f"{100 * w['collective_share']:.1f} % of decode step wall; "
            f"n-gram run's step {a['ngram']['step_ms_median']:.2f} ms; "
            f"peak memory a rank drawing {gb('draw_peak_gb')} GB, resident "
            f"{gb('resident_gb')} GB (a shard {a['shard_gb']:.3f} GB an "
            f"engine), serving {gb('peak_gb', 'wave')} GB; one rank's "
            f"decode step kernels (graph replay, experts with rows per "
            f"layer {t['step']['experts_kept_per_layer']}): "
            + ", ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f} "
                        f"ms)" for k, v in t.items()))
        key = "qwen3moe" if arch == MOE_ARCH else "deepseek"
        by_path[f"{key}_tp2_decode"] = w["launches"]
        by_path[f"{key}_tp2_spec_ngram"] = a["ngram"]["launches"]
        result[arch] = {
            "eager_tp1_decode_step_ms_median": tp1,
            "ranks": [{k: v for k, v in r[arch].items()
                       if k not in ("wave", "ngram")}
                      | {lab: {k: v for k, v in r[arch][lab].items()
                               if k != "streams"}
                         for lab in ("wave", "ngram")} for r in ranks]}
    log(f"phase 17 {phase_s:.1f} s")
    return by_path, result


# ---------------------------------------------------------------------------
# tensor-parallel recurrent and hybrid serving: xlstm-1.3b x48 and
# zamba2-7b x27 at tp = 2, two ranks sharing the card
# ---------------------------------------------------------------------------
TP_REC_REF = {}   # what phase 18 is held to, by arch: phase 11's / 12's
                  # weights digest, first wave and its eager streams, the
                  # eager decode step median, the arena's bytes, the
                  # pages of its forced preemption
# (arch, layers, cim_gemv / swiglu_qgemv / paged_flash_decode a decode
# step on each rank, the phase it is held to)
TP_REC_ARCHS = ((XLSTM_ARCH, 48, (265, 0, 0), 11),
                (ZAMBA_ARCH, 27, (79, 4, 4), 12))


def rec_collectives(eng):
    """Collectives a step call of a recurrent engine at tp = 2, from the
    leaves the rank holds: the embedding's all-reduce and the logits'
    gather (where the vocab is split); a split Mamba2 layer's gather for
    its norm, a split mLSTM layer's two gathers (x_m, h); each
    row-parallel projection of a split cell (out_proj, down_proj,
    ffn_down; zamba's shared wo and w_down) an all-reduce, or a gather
    of its input where its rows stayed whole."""
    from repro_torch.models.ssm import mamba2_dims, mlstm_dims, slstm_dims
    cfg, p = eng.model.cfg, eng.params
    out = {"all_reduce": 0, "all_gather": 0}

    def add(n, rows_split):
        out["all_reduce" if rows_split else "all_gather"] += n

    def rows(w):
        return w.shape[-2]
    add(1, p["embed"].shape[0] != cfg.vocab)
    out["all_gather"] += p["head"].shape[-1] != cfg.vocab
    L = cfg.n_layers
    if cfg.family == "zamba":
        di, nh, _ = mamba2_dims(cfg)
        cell = p["mamba"]["cell"]
        if cell["a_log"].shape[-1] != nh:
            out["all_gather"] += L
            add(L, rows(cell["out_proj"]) != di)
        n_groups = eng.model.n_paged_layers()
        shared = p["shared"]
        hq = cfg.n_heads * cfg.hd()
        add(n_groups, rows(shared["attn"]["wo"]) != hq)
        add(n_groups, rows(shared["ffn"]["w_down"]) != cfg.zamba.shared_d_ff)
        return out
    di, nh, _ = mlstm_dims(cfg)
    n_s = L // cfg.ssm.slstm_every
    cell = p["mlstm"]["cell"]
    if cell["wq"].shape[-3] != nh:
        out["all_gather"] += 2 * (L - n_s)
        add(L - n_s, rows(cell["down_proj"]) != di)
    f_up = int(cfg.ssm.proj_factor_slstm * slstm_dims(cfg)[0])
    scell = p["slstm"]["cell"]
    if scell["ffn_up"].shape[-1] != 2 * f_up:
        add(n_s, rows(scell["ffn_down"]) != f_up)
    return out


def rec_packed_leaves(eng):
    """This rank's packed leaves of a decode step's kernels, one dict a
    use: each mLSTM / sLSTM / Mamba2 layer's (the head-wise stacks as 3-D
    leaves), each zamba group's LoRA out_proj and shared block (gate /
    up as a pair), then the head."""
    p = eng.params
    uses = []

    def layers(tree, depth):
        views = [tree]
        for _ in range(depth):
            views = [_take_layer(v, i) for v in views
                     for i in range(_lead_dim(v))]
        return views

    def packed(tree, prefix):
        return {f"{prefix} {k}": v for k, v in tree.items()
                if hasattr(v, "nbytes_packed")}
    for name, depth in (("mlstm", 2), ("slstm", 1)):
        if name in p:
            uses += [packed(c["cell"], name) for c in layers(p[name], depth)]
    n_groups = eng.model.n_paged_layers()
    for name, depth in (("mamba", 2), ("mamba_tail", 1)):
        if name not in p:
            continue
        cells = [packed(c["cell"], "mamba") for c in layers(p[name], depth)]
        if name == "mamba":          # each group's layers, then the site
            per = len(cells) // n_groups
            lora = layers(p["lora"], 1)
            shared = {**packed(p["shared"]["attn"], "shared"),
                      **packed(p["shared"]["ffn"], "shared")}
            for g in range(n_groups):
                uses += cells[g * per:(g + 1) * per]
                uses.append({**packed(lora[g], "lora"), **shared})
        else:
            uses += cells
    return uses, p["head"]


def tp_rec_kernel_checks(eng, device, rank):
    """Each kernel at this rank's shapes against its plain version, every
    call twice (bitwise equal), phase 2's tolerances: cim_gemv on every
    packed leaf of the first and the last use (2-D at M = 1, 4, 20; the
    mLSTM's head-wise stacks at the rank's heads, every row counted) and
    the head; zamba's swiglu_qgemv on the shared gate / up and its
    paged_flash_decode at the rank's kv heads (INT8 pools, lanes at 1024
    / 777 / 301 / 45 keys)."""
    import torch
    from repro_torch.kernels.cim_gemv import cim_gemv, cim_gemv_plain
    from repro_torch.kernels.paged_flash_decode import (paged_decode_plain,
                                                        paged_flash_decode)
    from repro_torch.kernels.swiglu_gemv import swiglu_plain, swiglu_qgemv
    checks = Checks()
    cfg = eng.model.cfg
    gen = torch.Generator(device=device).manual_seed(180 + rank)
    uses, head = rec_packed_leaves(eng)
    ws = {"head": head}
    for use in (uses[0], uses[-1]) + tuple(
            u for u in uses if "shared w_gate" in u)[:1]:
        ws.update(use)
    shapes = {}
    for m in (1, 4, 20):
        for name, w in ws.items():
            if name in ("shared w_gate", "shared w_up"):
                continue
            if w.ndim == 3:                 # the head-wise stack
                E, k, n = w.orig_shape
                x = torch.randn(E, m, k, generator=gen, device=device)
                cnt = torch.full((E,), m, dtype=torch.int32, device=device)
                shapes[name] = (E, k, n, w.group)
                label = f"rank {rank} {name} E={E} {k}->{n} g{w.group} M={m}"
                out = cim_gemv(x, w, cnt)
                checks.compare("cim_gemv", label, out, cim_gemv_plain(x, w))
                checks.repeat("cim_gemv", label, out, cim_gemv(x, w, cnt))
                continue
            k, n = _kn(w)
            shapes[name] = (k, n, w.group)
            x = torch.randn(m, k, generator=gen, device=device)
            label = f"rank {rank} {name} {k}->{n} g{w.group} M={m}"
            out = cim_gemv(x, w)
            checks.compare("cim_gemv", label, out, cim_gemv_plain(x, w))
            checks.repeat("cim_gemv", label, out, cim_gemv(x, w))
        if "shared w_gate" in ws:
            wg, wu = ws["shared w_gate"], ws["shared w_up"]
            k, n = _kn(wg)
            shapes["shared gate/up"] = (k, n, wg.group)
            x = torch.randn(m, k, generator=gen, device=device)
            label = f"rank {rank} shared gate/up {k}->{n} g{wg.group} M={m}"
            out = swiglu_qgemv(x, wg, wu)
            checks.compare("swiglu_qgemv", label, out,
                           swiglu_plain(x, wg, wu))
            checks.repeat("swiglu_qgemv", label, out,
                          swiglu_qgemv(x, wg, wu))
    if eng.model.n_paged_layers():
        pools = eng.cache.pools["attn"]["k"]
        b, g, hd = 4, pools.shape[-2], pools.shape[-1]
        qpk = cfg.n_heads // cfg.n_kv_heads
        shapes["paged_flash_decode"] = (g, qpk, hd)
        kp, vp, ks, vs, tables = int8_pools(gen, device, b, 64, g, hd)
        lengths = torch.tensor([1024, 777, 301, 45], dtype=torch.int32,
                               device=device)
        q = torch.randn(b, g, qpk, hd, generator=gen, device=device)
        args = (q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
        label = f"rank {rank} int8 g={g} qpk={qpk} hd={hd} len<=1024"
        out = paged_flash_decode(*args)
        checks.compare("paged_flash_decode", label, out,
                       paged_decode_plain(*args))
        checks.repeat("paged_flash_decode", label, out,
                      paged_flash_decode(*args))
    return {k: {"max_abs_err": e, "tol": t, "worst_case": lab}
            for k, (e, t, lab) in checks.worst.items()}, shapes


def tp_rec_step_timing(eng, device, lengths=(65,) * 4):
    """One rank's decode step kernel calls (batch 4; zamba's lanes at
    `lengths` keys after the step): every packed leaf of every use
    through cim_gemv (the head-wise stacks with every row counted),
    zamba's shared gate / up through swiglu_qgemv and its attention
    through paged_flash_decode at the rank's kv heads (INT8 pools) a
    site; timed as in phase 2 (CUDA-graph replays of the calls alone),
    beside their bytes bound: the rank's weights and scales read once a
    use, the activations in and out, the K/V rows and the tables."""
    import torch
    from repro_torch.kernels.cim_gemv import cim_gemv
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.kernels.swiglu_gemv import swiglu_qgemv
    M = eng.max_batch
    gen = torch.Generator(device=device).manual_seed(181)
    uses, head = rec_packed_leaves(eng)
    xs = {}

    def x_of(*shape):
        if shape not in xs:
            xs[shape] = torch.randn(*shape, generator=gen, device=device)
        return xs[shape]
    calls = {"cim_gemv": [], "swiglu_qgemv": [], "paged_flash_decode": []}
    nbytes = dict.fromkeys(calls, 0)
    full = torch.full((8,), M, dtype=torch.int32, device=device)
    for use in uses + [{"head": head}]:
        for name, w in use.items():
            if name in ("shared w_gate", "shared w_up"):
                continue
            if w.ndim == 3:
                E, k, n = w.orig_shape
                calls["cim_gemv"].append((w, x_of(E, M, k), full[:E]))
                nbytes["cim_gemv"] += w.nbytes_packed() + 4 * E * M * (k + n)
                continue
            k, n = _kn(w)
            calls["cim_gemv"].append((w, x_of(M, k), None))
            nbytes["cim_gemv"] += w.nbytes_packed() + 4 * M * (k + n)
        if "shared w_gate" in use:
            wg, wu = use["shared w_gate"], use["shared w_up"]
            k, n = _kn(wg)
            calls["swiglu_qgemv"].append((wg, wu, x_of(M, k)))
            nbytes["swiglu_qgemv"] += (wg.nbytes_packed() + wu.nbytes_packed()
                                       + 4 * M * (k + n))
    n_sites = eng.model.n_paged_layers()
    if n_sites:
        cfg = eng.model.cfg
        pools = eng.cache.pools["attn"]["k"]
        g, hd, qpk = pools.shape[-2], pools.shape[-1], \
            cfg.n_heads // cfg.n_kv_heads
        pages = -(-max(lengths) // 16)
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        q = x_of(M, g, qpk, hd)
        for _ in range(n_sites):
            kp, vp, ks, vs, tables = int8_pools(gen, device, M, pages, g,
                                                hd)
            calls["paged_flash_decode"].append(
                (q, kp, vp, tables, lens, 0, 0.0, ks, vs))
            nbytes["paged_flash_decode"] += (
                sum(lengths) * g * (2 * hd + 2 * 2) + 2 * q.numel() * 4
                + M * (pages + 1) * 4)

    def run(kernel):
        def fn():
            for c in calls[kernel]:
                if kernel == "cim_gemv":
                    w, x, cnt = c
                    cim_gemv(x, w) if cnt is None else cim_gemv(x, w, cnt)
                elif kernel == "swiglu_qgemv":
                    swiglu_qgemv(c[2], c[0], c[1])
                else:
                    paged_flash_decode(*c)
        return fn
    out = {}
    for kernel in calls:
        if calls[kernel]:
            ms = graph_time_ms(run(kernel))
            out[kernel] = {"calls": len(calls[kernel]), "ms": ms,
                           "bound_ms": bound(nbytes[kernel], 0.0)[0],
                           "bytes": nbytes[kernel]}

    def all_calls():
        for kernel in calls:
            if calls[kernel]:
                run(kernel)()
    total = sum(nbytes.values())
    out["step"] = {"ms": graph_time_ms(all_calls),
                   "bound_ms": bound(total, 0.0)[0], "bytes": total}
    return out


def tp_rec_rank(rank, refs, init, out_dir):
    """One rank of phase 18 (spawned): xlstm-1.3b x48 and zamba2-7b x27
    from phase 11's and 12's seed, each its shard served at tp = 2 on a
    gloo group over loopback."""
    import torch
    import torch.distributed as dist
    device = join_rank_group(rank, init)
    res = {"rank": rank}
    for arch, n_layers, want_step, phase in TP_REC_ARCHS:
        res[arch] = tp_rec_arch(rank, arch, n_layers, want_step, phase,
                                refs[arch], device)
        torch.cuda.empty_cache()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def tp_rec_arch(rank, arch, n_layers, want_step, phase, ref, device):
    """This rank's part of phase 18 for one arch: draw (one rank at a
    time), shard, serve the wave and the same wave in the pool of its
    forced preemption, check the kernels at its shapes and (rank 0) time
    its decode step's kernels."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_model
    from repro_torch.serve import PagedServeEngine, ServeConfig

    tag = f"phase 18 rank {rank} {arch}"
    cfg = get_config(arch).replace(dtype="float32", remat=False,
                                   n_layers=n_layers)
    serve_cfg = ServeConfig(precision="int4", kv_dtype="auto",
                            max_batch=4, max_seq=128, page_size=16,
                            prefill_chunk=16, tp=TP)
    for turn in range(TP):              # one rank draws at a time
        if turn == rank:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model, params = build_model(cfg, "int4", 128, device, seed=0)
            torch.cuda.synchronize()
            draw_s = time.perf_counter() - t0
            draw_peak = torch.cuda.max_memory_allocated() / 1e9
            whole_gb = torch.cuda.memory_allocated() / 1e9
            digest = weights_digest(params)
            eng = PagedServeEngine(model, params, serve_cfg, device=device)
            tight = PagedServeEngine(model, params, dataclasses.replace(
                serve_cfg, n_pages=ref["tight_pages"]), device=device)
            del params
            torch.cuda.empty_cache()
        dist.barrier()
    resident = torch.cuda.memory_allocated() / 1e9
    shard_gb = tree_gb(eng.params)
    same = digest == ref["digest"]
    log(f"{tag}: x{n_layers} INT4 drawn in {draw_s:.1f} s, "
        f"{whole_gb:.2f} GB whole (peak {draw_peak:.2f} GB while "
        f"drawing), {resident:.2f} GB resident after sharding (two "
        f"engines, each its {shard_gb:.3f} GB shard); unsharded weights "
        f"sha256 {digest[:16]}..., phase {phase}'s {ref['digest'][:16]}... "
        f"({'equal' if same else 'DIFFERENT'})")
    if not same:
        fail(f"{tag}: the unsharded weights differ from phase {phase}'s")
    if eng.runner.graphs or tight.runner.graphs:
        fail(f"{tag}: steps captured as CUDA graphs at tp = {TP}")
    p = eng.params
    cell = p["mlstm" if cfg.family == "xlstm" else "mamba"]["cell"]
    leaves = {k: (tuple(v.orig_shape) if hasattr(v, "orig_shape")
                  else tuple(v.shape)) + ((f"g{v.group}",)
                                          if hasattr(v, "group") else ())
              for k, v in cell.items()}
    if cfg.family == "xlstm":
        leaves.update({f"slstm {k}": tuple(v.orig_shape) + (f"g{v.group}",)
                       for k, v in p["slstm"]["cell"].items()
                       if hasattr(v, "orig_shape")})
    arena = {"/".join(path): tuple(leaf.shape)
             for path, leaf, _ in eng.arena._leaves()}
    state_bytes = eng.arena.state_bytes()
    log(f"{tag}: shard {leaves}; arena {arena}, {state_bytes / 1e6:.3f} MB "
        f"a rank against {ref['state_bytes'] / 1e6:.3f} MB at tp = 1"
        + (f"; pools k {tuple(eng.cache.pools['attn']['k'].shape)} "
           f"{eng.cache.pools['attn']['k'].dtype}" if eng.cache.pools
           else ""))
    if cfg.family == "xlstm":
        heads = cell["wq"].orig_shape[-3]
        ok = heads == cfg.ssm.mlstm_heads // TP and \
            arena["mlstm/C"][-3] == heads and \
            arena["slstm/c"][-1] == cfg.d_model
    else:
        heads = cell["a_log"].shape[-1]
        ok = heads * cfg.ssm.head_dim * TP == int(cfg.ssm.expand
                                                  * cfg.d_model) and \
            arena["mamba/state"][-3] == heads and \
            eng.cache.pools["attn"]["k"].shape[-2] == cfg.n_kv_heads // TP
    if not ok:
        fail(f"{tag}: the rank holds {heads} heads, arena {arena}")
    per_step = step_launches(cfg, 1)
    got_step = (per_step["cim_gemv"], per_step["swiglu_qgemv"],
                per_step["paged_flash_decode"])
    if got_step != want_step:
        fail(f"{tag}: a decode step's launches {per_step}, expected "
             f"{want_step}")
    per_call = rec_collectives(eng)
    out = {"draw_s": draw_s, "draw_peak_gb": draw_peak,
           "whole_gb": whole_gb, "resident_gb": resident,
           "shard_gb": shard_gb, "shard_leaves": leaves, "arena": arena,
           "state_bytes": state_bytes,
           "tp1_state_bytes": ref["state_bytes"],
           "collectives_expected_per_call": per_call}
    out["wave"] = tp_run(tag, "wave", eng, model, ref["wave"], 16,
                         ref["wave_streams"], f"phase {phase}'s eager wave",
                         device, per_call)
    snaps = []
    save = tight.arena.save_lane

    def counted(lane):
        snaps.append(lane)
        return save(lane)
    tight.arena.save_lane = counted
    out["preempted"] = tp_run(
        tag, f"wave in {ref['tight_pages']} pages", tight, model,
        ref["wave"], 16, ref["wave_streams"], f"phase {phase}'s eager wave",
        device, per_call)
    del tight.arena.save_lane
    preempts = sum(e["kind"] == "preempt" for e in tight.recorder.snapshot())
    pure = model.n_paged_layers() == 0
    log(f"{tag}: {preempts} preemptions in {ref['tight_pages']} pages, "
        f"{len(snaps)} lane snapshots of the rank's arena slice")
    if preempts <= 0 or pure != (len(snaps) > 0):
        fail(f"{tag}: {preempts} preemptions, {len(snaps)} snapshots")
    out["preempted"].update(preemptions=preempts, snapshots=len(snaps))
    free = tight.cache.n_free_or_cached() == tight.cache.allocator.n_pages
    if not free:
        fail(f"{tag}: pages held after the preempted wave")
    del tight
    torch.cuda.empty_cache()
    out["kernel_checks"], out["shapes"] = tp_rec_kernel_checks(eng, device,
                                                               rank)
    dist.barrier()
    if rank == 0:                 # rank 1 waits: the card is rank 0's
        out["timing"] = tp_rec_step_timing(eng, device)
    dist.barrier()
    return out


def phase_tp_rec(card):
    """Phase 18: spawn two ranks (gloo over loopback, both on cuda:0),
    each serving xlstm-1.3b x48 and then zamba2-7b x27 at tp = 2; hold
    them to phases 11 and 12 and to each other."""
    ranks, phase_s = spawn_ranks(tp_rec_rank, TP_REC_REF, "tp_rec")
    by_path, result = {}, {"phase_s": phase_s, "card": card}
    for arch, n_layers, _, phase in TP_REC_ARCHS:
        a, b = ranks[0][arch], ranks[1][arch]
        for label in ("wave", "preempted"):
            if a[label]["streams"] != b[label]["streams"]:
                fail(f"phase 18 {arch} {label}: the ranks' streams differ")
            if a[label]["launches"] != b[label]["launches"]:
                fail(f"phase 18 {arch} {label}: the ranks' launches differ")
        w, t = a["wave"], a["timing"]
        tp1 = TP_REC_REF[arch]["eager_decode_ms"]

        def gb(key, label=None):
            return [round((r[arch][label] if label else r[arch])[key], 3)
                    for r in ranks]
        log(f"phase 18 {arch} x{n_layers} (tp = {TP}, two ranks on one "
            f"card, {card}): decode step wall median "
            f"{w['step_ms_median']:.2f} ms (rank 0; rank 1 "
            f"{b['wave']['step_ms_median']:.2f} ms) against phase {phase}'s"
            f" eager tp = 1 {tp1:.2f} ms; collectives "
            f"{w['collectives_per_call']} a step, "
            f"{w['step_collective_ms_median']:.2f} ms of a step (median), "
            f"{100 * w['collective_share']:.1f} % of decode step wall; "
            f"arena {a['state_bytes'] / 1e6:.3f} MB a rank (tp = 1: "
            f"{a['tp1_state_bytes'] / 1e6:.3f} MB); peak memory a rank "
            f"drawing {gb('draw_peak_gb')} GB, resident {gb('resident_gb')}"
            f" GB (a shard {a['shard_gb']:.3f} GB), serving "
            f"{gb('peak_gb', 'wave')} GB; one rank's decode step kernels "
            f"(graph replay): "
            + ", ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f} "
                        f"ms)" for k, v in t.items()))
        key = "xlstm" if arch == XLSTM_ARCH else "zamba"
        by_path[f"{key}_tp2_decode"] = w["launches"]
        result[arch] = {
            "eager_tp1_decode_step_ms_median": tp1,
            "ranks": [{k: v for k, v in r[arch].items()
                       if k not in ("wave", "preempted")}
                      | {lab: {k: v for k, v in r[arch][lab].items()
                               if k != "streams"}
                         for lab in ("wave", "preempted")} for r in ranks]}
    log(f"phase 18 {phase_s:.1f} s")
    return by_path, result


# ---------------------------------------------------------------------------
# the gateway at tp = 2: rank 0 leads two replicas' groups (dist.lockstep)
# ---------------------------------------------------------------------------
TPGW_DEADLINE_S = 0.05      # shorter than one tp = 2 step (phase 16)


def tpgw_engines(model, params, device, n: int = 2):
    """`n` replicas' engines of qwen2.5-3b at tp = 2 (INT4, INT8 KV,
    batch 4, pages and chunks of 16), each on its own pair of groups,
    built in the same order on both ranks."""
    from repro_torch.dist import replica_groups
    from repro_torch.serve import PagedServeEngine, ServeConfig
    scfg = ServeConfig(precision="int4", kv_dtype="auto", max_batch=4,
                       max_seq=128, page_size=16, prefill_chunk=16, tp=TP,
                       replicas=n)
    out = []
    for _ in range(n):
        group, tick_group = replica_groups(TP)
        out.append(PagedServeEngine(model, params, scfg, device=device,
                                    group=group, tick_group=tick_group))
    return out


def tpgw_state(eng) -> dict:
    """What both ranks' engines must agree on after the waves."""
    events = eng.recorder.snapshot()
    return {"next_eid": eng._next_eid,
            "lanes": [r.eid if r is not None else None for r in eng.lanes],
            "queue": [item[3].eid for item in eng.scheduler._heap],
            "free_or_cached": eng.cache.n_free_or_cached(),
            "n_pages": eng.cache.allocator.n_pages,
            "steps": eng.telemetry.steps, "ticks": eng.lockstep.seq,
            "prefill_calls": eng.prefill_calls,
            "decode_calls": eng.decode_calls,
            "rejects": [[e["eid"], e["reason"]] for e in events
                        if e["kind"] == "reject"],
            "cancels": [e["eid"] for e in events if e["kind"] == "cancel"]}


def tpgw_lead(engines, ref, cfg):
    """Rank 0 of phase 19: the gateway over both replicas; the greedy
    wave, the deadline wave (14 requests, one client hanging up after 4
    tokens, then 2 of priority 1 with a deadline shorter than a step
    while every lane is taken), /metrics and /healthz.  Returns the
    record and the replicas' driver threads."""
    import asyncio

    import numpy as np
    import torch

    from repro_torch.fleet import FleetRouter
    n_new = 16
    walls = []                  # (ms, decode only) of each step call
    for eng in engines:
        orig = eng.step

        def step(eng=eng, orig=orig):
            pre = eng.prefill_calls
            t0 = time.perf_counter()
            orig()
            torch.cuda.current_stream().synchronize()
            walls.append(((time.perf_counter() - t0) * 1e3,
                          eng.prefill_calls == pre))
        eng.step = step

    def body(p, **kw):
        return {"prompt": [int(t) for t in p], "max_tokens": n_new, **kw}
    router = FleetRouter(engines, policy="rr")
    gwt = GatewayThread(router)
    threads = [rep.driver._thread for rep in router.replicas]
    greedy, wall_g, _ = gateway_wave(gwt, [body(p) for p in ref["wave8"]])
    greedy_walls = [ms for ms, dec in walls if dec]
    prefill_walls = [ms for ms, dec in walls if not dec]
    for i, r in enumerate(greedy):
        if set(r["fins"].values()) != {"length"} or \
                len(r["toks"].get(0, [])) != n_new:
            fail(f"phase 19 greedy request {i}: {r['fins']}, "
                 f"{len(r['toks'].get(0, []))} tokens")

    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, cfg.vocab, int(k)).astype(np.int32)
               for k in rng.integers(16, 65, size=16)]
    bg = start_clients(gwt, [body(p) for p in prompts[:14]],
                       disconnect={13})
    t0 = time.perf_counter()
    while sum(rep.snapshot.get("n_running", 0.0)
              for rep in router.replicas) < 2 * engines[0].max_batch:
        if time.perf_counter() - t0 > 120:
            fail("phase 19: the deadline wave never filled every lane")
        time.sleep(0.01)
    # behind every priority-0 request: examined only once a lane is
    # free and those are admitted, long after their deadline
    late, _, _ = gateway_wave(gwt, [body(p, deadline_s=TPGW_DEADLINE_S,
                                         priority=1)
                                    for p in prompts[14:]])
    early, wall_d = client_results(bg)
    if [set(r["fins"].values()) for r in late] != [{"rejected"}] * 2:
        fail(f"phase 19: the deadline requests finished "
             f"{[r['fins'] for r in late]}")
    if not early[13]["disconnected"]:
        fail("phase 19: the disconnecting client read its whole stream")
    for i, r in enumerate(early[:13]):
        if set(r["fins"].values()) != {"length"}:
            fail(f"phase 19 deadline wave request {i}: {r['fins']}")
    st_m, _, raw_m = asyncio.run(http(gwt.host, gwt.port, "GET",
                                      "/metrics"))
    st_h, _, _ = asyncio.run(http(gwt.host, gwt.port, "GET", "/healthz"))
    metrics = json.loads(raw_m)
    if st_m != 200 or metrics["fleet"]["n_replicas"] != 2 or \
            metrics["config"]["tp"] != TP or st_h != 200:
        fail(f"phase 19 /metrics {st_m} (replicas "
             f"{metrics['fleet']['n_replicas']}), /healthz {st_h}")
    gwt.stop()                  # every engine's STOP tick
    dead = [rep.id for rep in router.replicas if rep.error is not None]
    if dead:
        fail(f"phase 19: replicas {dead} failed: "
             f"{[repr(router.replicas[i].error) for i in dead]}")
    ttft = quantiles([r["ttft_s"] * 1e3 for r in greedy])
    return {"greedy_streams": [r["toks"][0] for r in greedy],
            "greedy_wall_s": wall_g, "deadline_wall_s": wall_d,
            "ttft_ms_p50_p95": ttft,
            "step_ms_median": float(np.median(greedy_walls)),
            "decode_steps_greedy": len(greedy_walls),
            "prefill_step_ms_median": float(np.median(prefill_walls)),
            "prefill_steps_greedy": len(prefill_walls),
            "metrics_requests": metrics["engine"]["requests"]}, threads


def tpgw_follow(engines):
    """Rank 1 of phase 19: follow each engine on a thread of its own
    until rank 0's STOP ticks.  Returns the threads."""
    from repro_torch.dist import follow_all
    threads, outcomes = follow_all(engines)
    for t in threads:
        t.join(900)
    if outcomes != ["stop"] * len(engines):
        fail(f"phase 19 rank 1 followers: {outcomes!r}")
    return threads


def tp_gateway_rank(rank, ref, init, out_dir):
    """One rank of phase 19 (spawned): qwen2.5-3b from phase 3's seed, two
    replicas at tp = 2 on groups of their own; rank 0 serves the gateway
    and leads, rank 1 follows."""
    from types import SimpleNamespace

    import torch
    import torch.distributed as dist
    from repro_torch.dist import (collective_counts, reset_collective_counts,
                                  reset_tick_counts, tick_counts,
                                  tick_seconds)
    from repro_torch.kernels import reset_launch_counts, thread_launch_counts
    device = join_rank_group(rank, init)
    tag = f"phase 19 rank {rank}"
    t0 = time.perf_counter()
    model, params = build_full_model(device)
    if weights_digest(params) != ref["digest"]:
        fail(f"{tag}: the unsharded weights differ from phase 3's")
    engines = tpgw_engines(model, params, device)
    del params
    torch.cuda.empty_cache()
    cfg = model.cfg
    log(f"{tag}: 2 replicas built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the counts start at 0 just before the path is driven
    reset_launch_counts()
    reset_collective_counts()
    reset_tick_counts()
    res = {"rank": rank}
    if rank == 0:
        lead, threads = tpgw_lead(engines, ref, cfg)
        res.update(lead)
    else:
        threads = tpgw_follow(engines)
    res["launches"] = [thread_launch_counts(t) for t in threads]
    res["expected"] = [expected_launches(cfg, e.prefill_calls,
                                         e.decode_calls) for e in engines]
    res["collectives"] = collective_counts()
    res["ticks"] = tick_counts()
    res["tick_s"] = tick_seconds()
    res["states"] = [tpgw_state(e) for e in engines]
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    calls = sum(e.prefill_calls + e.decode_calls for e in engines)
    want = {"all_reduce": (2 * cfg.n_layers + 1) * calls,
            "all_gather": calls}
    if res["collectives"] != want:
        fail(f"{tag}: collectives {res['collectives']} != {want}")
    for i, (got, exp) in enumerate(zip(res["launches"], res["expected"])):
        if got != exp:
            fail(f"{tag} replica {i}: launches {got} != expected {exp}")
    # rank 0's streams to both ranks: a divergence from phase 3's is
    # checked for a near-tie by both, in lockstep on replica 0's group
    box = [res.get("greedy_streams")]
    dist.broadcast_object_list(box, src=0)
    want_streams = ref["wave8_streams"]
    base = [SimpleNamespace(prompt=p, out_tokens=w, rid=i)
            for i, (p, w) in enumerate(zip(ref["wave8"], want_streams))]
    got = [SimpleNamespace(prompt=p, out_tokens=s, rid=i)
           for i, (p, s) in enumerate(zip(ref["wave8"], box[0]))]
    res["near_ties"] = check_identity(
        f"{tag} greedy wave vs phase 3", base, got, model,
        engines[0].params, device, engines[0]._serve_fn, TP)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def phase_tp_gateway(card, tp16_step_ms):
    """Phase 19: spawn two ranks (gloo over loopback, both on cuda:0);
    rank 0 serves the gateway over two replicas of qwen2.5-3b at tp = 2
    and leads their groups, rank 1 follows.  Holds the streams to phase
    3's, the ranks' engines to each other, the deadlines, the pages and
    the launches."""
    ranks, phase_s = spawn_ranks(tp_gateway_rank, TP_REF, "tp_gateway")
    a, b = ranks
    if a["states"] != b["states"]:
        fail(f"phase 19: the ranks' engines differ: {a['states']} vs "
             f"{b['states']}")
    if a["ticks"] != b["ticks"]:
        fail(f"phase 19: rank 0 sent {a['ticks']}, rank 1 received "
             f"{b['ticks']}")
    steps = sum(s["steps"] for s in a["states"])
    ticks = a["ticks"]["ticks"]
    if not steps + 2 <= ticks or a["ticks"]["broadcasts"] > 2 * ticks:
        fail(f"phase 19: {ticks} ticks ({a['ticks']['broadcasts']} "
             f"broadcasts) for {steps} step calls and 2 STOPs")
    expired = {i: [eid for eid, why in s["rejects"] if why == "expired"]
               for i, s in enumerate(a["states"])}
    if sum(map(len, expired.values())) != 2 or \
            sum(len(s["rejects"]) for s in a["states"]) != 2:
        fail(f"phase 19: rejected {[s['rejects'] for s in a['states']]}, "
             f"expected 2 expired")
    for s in a["states"] + b["states"]:
        if (s["free_or_cached"], s["lanes"], s["queue"]) != (
                s["n_pages"], [None] * 4, []):
            fail(f"phase 19: pages free or cached {s['free_or_cached']} "
                 f"of {s['n_pages']}, lanes {s['lanes']}, queue "
                 f"{s['queue']}")
    if sum(len(s["cancels"]) for s in a["states"]) < 1:
        fail("phase 19: the disconnect cancelled nothing")
    launches = {}
    for per in a["launches"]:
        for k, v in per.items():
            launches[k] = launches.get(k, 0) + v
    decode_calls = sum(s["decode_calls"] for s in a["states"])
    log(f"phase 19 (gateway at tp = {TP}, 2 replicas, two ranks on one "
        f"card, {card}): {ticks} ticks for {steps} engine step calls and 2 "
        f"STOPs ({(ticks - 2) / steps:.3f} a step call, "
        f"{a['ticks']['broadcasts']} broadcasts), "
        f"{1e3 * a['tick_s'] / ticks:.3f} ms host a tick on "
        f"rank 0 ({1e3 * b['tick_s'] / ticks:.3f} on rank 1); decode step "
        f"wall median through the gateway {a['step_ms_median']:.2f} ms "
        f"(both replicas stepping on the card) against phase 16's offline "
        f"tp = 2 {tp16_step_ms:.2f} ms, a step with a prefill chunk "
        f"{a['prefill_step_ms_median']:.2f} ms; TTFT p50 / p95 "
        f"{a['ttft_ms_p50_p95'][0]:.1f} / {a['ttft_ms_p50_p95'][1]:.1f} ms"
        f" through the gateway; launches a rank {launches} over "
        f"{decode_calls} decode calls (a decode step 181 / 36 / 36); "
        f"expired eids by replica {expired} on both ranks; near-ties "
        f"{a['near_ties']}; peak memory "
        f"{[round(r['peak_gb'], 3) for r in ranks]} GB a rank; phase "
        f"{phase_s:.1f} s")
    result = {"phase_s": phase_s, "card": card,
              "offline_tp2_step_ms_median": tp16_step_ms,
              "ticks_per_step_call": (ticks - 2) / steps,
              "tick_host_ms": [1e3 * r["tick_s"] / ticks for r in ranks],
              "ranks": [{k: v for k, v in r.items()
                         if k != "greedy_streams"} for r in ranks]}
    return {"tp2_gateway_decode": launches}, result


# ----------------------------------------------------------------------------
# phase 20: the design-space search and the dry-run / roofline tooling
# ----------------------------------------------------------------------------
DSE_SLM = "llama3.2-1b"
DRY_ARCH = "qwen2.5-3b"
ALLOC_ROUND = 512           # the caching allocator's block rounding


def phase_dse() -> dict:
    """Phase 20a: the paper's GA (population 20, 50 generations) on
    llama3.2-1b at alpha 1, INT4, seed 0, twice; both runs must be
    identical and the best cost never rise.  Logged: the best design,
    its latency and energy and the Pareto front's size (cost model, not
    measured)."""
    import dataclasses

    from repro_torch.configs import PAPER_SLMS
    from repro_torch.core import pareto_front, run_dse
    t0 = time.perf_counter()
    runs = [run_dse(PAPER_SLMS[DSE_SLM], alpha=1.0, w_bits=4, seed=0)
            for _ in range(2)]
    a, b = runs
    if (a.best, a.best_cost, a.history, a.evaluated) != \
            (b.best, b.best_cost, b.history, b.evaluated):
        fail("phase 20a: two DSE runs under seed 0 differ")
    if any(y > x for x, y in zip(a.history, a.history[1:])):
        fail(f"phase 20a: the best cost rose: {a.history}")
    front = pareto_front([(lat, en) for _, lat, en, _ in a.evaluated])
    res = {"slm": DSE_SLM, "generations": len(a.history),
           "best": dataclasses.asdict(a.best), "best_cost": a.best_cost,
           "latency_s": a.best_report.latency_s,
           "energy_j": a.best_report.energy_j,
           "evaluated": len(a.evaluated), "pareto_front": len(front),
           "s": time.perf_counter() - t0}
    log(f"DSE (cost model, not measured) {DSE_SLM} alpha 1 INT4 seed 0, "
        f"population 20 x {len(a.history)} generations, twice, identical: "
        f"best {a.best}, latency {res['latency_s']:.6g} s, energy "
        f"{res['energy_j']:.6g} J (cost-model output), Pareto front "
        f"{len(front)} of {len(a.evaluated)} evaluated; {res['s']:.1f} s")
    return res


def phase_dryrun_all(total_memory: int) -> dict:
    """Phase 20b: `launch.dryrun` over every cell (`--all`: every arch x
    its shapes x both production meshes x bf16, and int4 for decode) on
    the meta device; every cell must be ok.  Logged: the roofline table
    (`roofline.report.render_markdown`), each cell's peak bytes a device
    against this card's memory, the part's seconds."""
    import tempfile
    from repro_torch.launch.dryrun import all_cells, run_cell
    from repro_torch.roofline.report import load_results, render_markdown
    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    out = tempfile.mkdtemp(prefix="dryrun_torch_", dir=root)
    t0 = time.perf_counter()
    fits, cells = [], 0
    for arch, shape, multi, q in all_cells():
        try:
            rec = run_cell(arch, shape, multi, q, out_dir=out, verbose=False)
        except Exception as e:  # noqa: BLE001 - the gate
            fail(f"phase 20b: dry-run {arch} {shape} "
                 f"{'multi' if multi else 'single'} {q}: "
                 f"{type(e).__name__}: {e}")
        if rec["status"] != "ok":
            fail(f"phase 20b: {arch} {shape} {q}: {rec['status']}")
        cells += 1
        peak = rec["memory_per_device"]["peak_bytes"]
        fits.append(f"{arch} {shape} {rec['mesh']} {q} "
                    f"{peak / 1e9:.3f} GB {'fits' if peak <= total_memory else 'DOES NOT FIT'}")
    seconds = time.perf_counter() - t0
    table = render_markdown(load_results(out, out + "_probe"))
    log(f"dry-run --all on meta: {cells} cells ok in {seconds:.1f} s; "
        f"records in {out}")
    for line in table.splitlines():
        log("roofline " + line)
    log(f"peak bytes a device against this card's {total_memory / 1e9:.2f}"
        " GB: " + "; ".join(fits))
    return {"cells": cells, "s": seconds, "out": out,
            "fit": sum("fits" in f for f in fits)}


def decode_cell_on_card(cfg, device):
    """The decode_32k cell's arguments on the card for `cfg`: INT4
    weights drawn from phase 3's seed (0) and packed leaf by leaf (the
    other leaves at their specs' dtypes, as the dry-run holds them), a
    bf16 cache of 128 x 32768 drawn from the same generator (standard
    normal, so every split of a row's keys counts in the attention),
    tokens and pos = 32767; with the
    bytes they asked the allocator for, the bytes it gave them (a warm
    cache may hand out a free block up to 1 MiB larger than asked,
    unsplit) and the tensors they are."""
    import functools

    import torch
    from repro_torch.configs.registry import SHAPES
    from repro_torch.launch.metarun import tensors_of
    from repro_torch.models import DecoderLM, init_params
    from repro_torch.models.common import map_specs
    from repro_torch.quant.ptq import quantize_leaf
    seq, batch, _ = SHAPES["decode_32k"]
    model = DecoderLM(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    asked = torch.cuda.memory_stats()["requested_bytes.all.current"]
    before = torch.cuda.memory_allocated()
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(model.param_specs(), gen, device,
                         leaf_fn=functools.partial(quantize_leaf, bits=4,
                                                   group=128))
    cache = map_specs(lambda s: torch.empty(
        s.shape, dtype=s.dtype, device=device).normal_(generator=gen),
        model.cache_specs(batch, seq, torch.bfloat16))
    tokens = torch.randint(0, cfg.vocab, (batch, 1), generator=gen,
                           device=device, dtype=torch.int32)
    pos = torch.tensor(seq - 1, dtype=torch.int32, device=device)
    torch.cuda.synchronize()
    asked = torch.cuda.memory_stats()["requested_bytes.all.current"] - asked
    held = torch.cuda.memory_allocated() - before
    n = len(list(tensors_of((params, cache, tokens, pos))))
    return model, (params, cache, {"tokens": tokens}, pos), asked, held, n


@contextlib.contextmanager
def plain_kernels(seen: list):
    """The model's kernel calls (`kernels.ops`) routed to their plain
    versions on the card; each flash_decode call's inputs appended to
    `seen`."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cim_gemv import cim_gemv_plain
    from repro_torch.kernels.flash_decode import flash_decode_plain
    from repro_torch.kernels.swiglu_gemv import swiglu_plain

    def fd(q, k, v, pos, window=0, attn_cap=0.0):
        seen.append((q, k, v, pos, window, attn_cap))
        return flash_decode_plain(q, k, v, pos, window, attn_cap)
    saved = ops.cim_gemv, ops.swiglu_qgemv, ops.flash_decode
    ops.cim_gemv = lambda x, w, counts=None: cim_gemv_plain(x, w)
    ops.swiglu_qgemv, ops.flash_decode = swiglu_plain, fd
    try:
        yield
    finally:
        ops.cim_gemv, ops.swiglu_qgemv, ops.flash_decode = saved


def check_step_against_plain(model, args, logits, L: int) -> dict:
    """The counted step's logits against the same step with every
    kernel's plain version on the same inputs, and flash_decode against
    flash_decode_plain on the (b g, S, hd) inputs that step gave it.
    The plain attention over the first half of the keys must miss by
    more than 10 tolerances, or the cache could not tell a merge that
    drops splits from a right one."""
    import torch
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain, plan)
    from repro_torch.kernels.split_decode import sm_count
    checks, seen = Checks(), []
    with torch.no_grad(), plain_kernels(seen):
        ref, _ = model.decode_step(*args)
    checks.compare("decode_step", f"x{L} logits vs plain kernels", logits,
                   ref)
    q, k, v, pos, window, cap = seen[0]
    out = flash_decode(q, k, v, pos, window, cap)
    want = flash_decode_plain(q, k, v, pos, window, cap)
    checks.compare("flash_decode", f"{tuple(k.shape)} pos {int(pos)} bf16",
                   out, want)
    half = flash_decode_plain(q, k, v, k.shape[1] // 2 - 1, window, cap)
    miss = float((half - want).abs().max())
    err, tol, _ = checks.worst["flash_decode"]
    n_split, chunk = plan(q.shape[0], k.shape[1], sm_count(q.device),
                          q.shape[1])
    log(f"flash_decode at {tuple(k.shape)}: the plan's {n_split} "
        f"split(s) of {chunk} keys a row; err {err:.3e}, tol {tol:.3e}; "
        f"the first half's keys alone miss by {miss:.3e}")
    if not miss > 10 * tol:
        fail(f"phase 20c x{L}: half the keys miss by {miss}, not more than "
             f"10 x tol {tol}: the cache cannot tell a wrong merge")
    return {name: {"max_abs_err": e, "tol": t}
            for name, (e, t, _) in checks.worst.items()} | {
        "half_keys_miss": miss, "n_split": n_split, "chunk": chunk}


def phase_dryrun_on_card(device, card) -> tuple:
    """Phase 20c: qwen2.5-3b decode_32k, INT4, on the host mesh (one
    device), at the probe's 1 and 2 layers (`probe_variants`) with f32
    activations (the kernels' input), built on the card and stepped
    once eagerly at pos 32767, then 5 more times timed by CUDA events.
    Gated: the bytes the arguments ask the card's allocator for equal
    the dry-run's argument_bytes within 512 B a tensor; the launches
    of one step are exactly 5 L + 1 cim_gemv, L swiglu_qgemv and L
    flash_decode; the logits are finite; at 1 layer, the logits and
    flash_decode at (256, 32768, 128) agree with their plain versions
    (`check_step_against_plain`).  Logged beside the dry-run:
    the step's peak memory against peak_bytes, its device time against
    the roofline's bound_time, both extrapolated to 36 layers
    (`probe.extrapolate`), and the full cell's predicted bytes."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.probe import extrapolate, probe_variants
    t0 = time.perf_counter()
    full = get_config(DRY_ARCH).replace(dtype="float32")
    (cfg1, u1), (cfg2, u2), u_full = probe_variants(full)
    host = make_host_mesh()
    total = {}
    points = []
    for cfg, units in ((cfg1, u1), (cfg2, u2)):
        L = cfg.n_layers
        dry = run_cell(DRY_ARCH, "decode_32k", False, "int4", out_dir=None,
                       verbose=False, cfg=cfg, mesh_shape=host)
        mem = dry["memory_per_device"]
        model, args, asked, held, n_t = decode_cell_on_card(cfg, device)
        slack = asked - mem["argument_bytes"]
        log(f"dry-run vs card, {DRY_ARCH} x{L} decode_32k INT4: arguments "
            f"asked the allocator for {asked} B and hold {held} B on the "
            f"card, {mem['argument_bytes']} B dry-run ({n_t} tensors, "
            f"asked - dry-run {slack} B, at most {ALLOC_ROUND * n_t} B)")
        if not 0 <= slack <= ALLOC_ROUND * n_t:
            fail(f"phase 20c x{L}: the arguments asked for {asked} B on the "
                 f"card, the dry-run says {mem['argument_bytes']} B")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() - held
        reset_launch_counts()
        with torch.no_grad():
            logits, _ = model.decode_step(*args)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        want = {"cim_gemv": 5 * L + 1, "swiglu_qgemv": L,
                "paged_flash_decode": 0, "paged_flash_verify": 0,
                "flash_decode": L}
        if counts != want:
            fail(f"phase 20c x{L}: launches {counts}, expected {want}")
        if not bool(torch.isfinite(logits).all()):
            fail(f"phase 20c x{L}: non-finite logits")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        plain = check_step_against_plain(model, args, logits, L) \
            if L == 1 else None
        times = []
        with torch.no_grad():
            for _ in range(5):
                times.append(cuda_time_ms(lambda: model.decode_step(*args),
                                          1, warmup=0))
        ms = float(np.median(times))
        bound_ms = dry["bound_time"] * 1e3
        point = {"layers": L, "units": units, "ms": ms, "ms_all": times,
                 "bound_ms": bound_ms, "dominant": dry["dominant"],
                 "bound_share": bound_ms / ms, "peak_bytes": peak,
                 "dry_peak_bytes": mem["peak_bytes"],
                 "argument_bytes": asked, "argument_bytes_held": held,
                 "dry_argument_bytes":
                 mem["argument_bytes"], "dry_temp_bytes": mem["temp_bytes"],
                 "flops": dry["flops"], "hlo_bytes": dry["hlo_bytes"],
                 "min_bytes": dry["min_bytes"], "launches": counts,
                 "vs_plain": plain}
        points.append(point)
        log(f"dry-run vs card, {DRY_ARCH} x{L} decode_32k INT4 b 128 x "
            f"32768: step {ms:.3f} ms (median of 5, CUDA events; "
            f"{[round(t, 3) for t in times]}) against the roofline's "
            f"bound {bound_ms:.3f} ms ({dry['dominant']}: "
            f"{dry['min_bytes'] / 1e9:.3f} GB the step must move, "
            f"{dry['flops'] / 1e9:.1f} GFLOP; the plain route moves "
            f"{dry['hlo_bytes'] / 1e9:.3f} GB by op), share "
            f"{bound_ms / ms:.3f}; "
            f"peak {peak / 1e9:.3f} GB on the card, {mem['peak_bytes'] / 1e9:.3f}"
            f" GB dry-run (temp {mem['temp_bytes'] / 1e9:.3f} GB); launches "
            f"{counts}; {card}")
        del model, args, logits
        torch.cuda.empty_cache()
    keys = ("ms", "bound_ms", "peak_bytes", "dry_peak_bytes")
    ext = extrapolate({k: points[0][k] for k in keys},
                      {k: points[1][k] for k in keys}, u1, u2, u_full)
    full_dry = run_cell(DRY_ARCH, "decode_32k", False, "int4", out_dir=None,
                        verbose=False, cfg=full, mesh_shape=host)
    fmem = full_dry["memory_per_device"]
    log(f"dry-run vs card, extrapolated to {u_full} layers: step "
        f"{ext['ms']:.3f} ms against a bound of {ext['bound_ms']:.3f} ms; "
        f"peak {ext['peak_bytes'] / 1e9:.3f} GB (card points), "
        f"{ext['dry_peak_bytes'] / 1e9:.3f} GB (dry-run points); the full "
        f"cell's dry-run: arguments {fmem['argument_bytes'] / 1e9:.3f} GB, "
        f"peak {fmem['peak_bytes'] / 1e9:.3f} GB a device (this card holds "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB)")
    res = {"arch": DRY_ARCH, "shape": "decode_32k", "quant": "int4",
           "points": points, "extrapolated": ext, "units_full": u_full,
           "full_argument_bytes": fmem["argument_bytes"],
           "full_peak_bytes": fmem["peak_bytes"],
           "s": time.perf_counter() - t0, "card": card}
    return total, res


def phase_dryrun(device, card) -> tuple:
    """Phase 20: the DSE (a), the dry-run of every cell (b) and the
    qwen2.5-3b decode_32k cell on the card (c)."""
    import torch
    t0 = time.perf_counter()
    dse = phase_dse()
    dry = phase_dryrun_all(torch.cuda.get_device_properties(0).total_memory)
    counts, card_res = phase_dryrun_on_card(device, card)
    res = {"dse": dse, "dryrun_all": dry, "on_card": card_res,
           "s": time.perf_counter() - t0}
    log(f"phase 20 in {res['s']:.1f} s (DSE {dse['s']:.1f}, dry-run "
        f"{dry['s']:.1f}, on the card {card_res['s']:.1f})")
    return counts, res


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
    TP_REF["digest"] = weights_digest(params)

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
    train_result = phase_training(device, card)
    paths, other_result = phase_other_paths(device, card, checks, timings)
    by_path.update(paths)
    by_path["tp2_decode"], by_path["tp2_spec_ngram"], tp_result = \
        phase_tp(card)
    tp_moe_paths, tp_moe_result = phase_tp_moe(card)
    by_path.update(tp_moe_paths)
    tp_rec_paths, tp_rec_result = phase_tp_rec(card)
    by_path.update(tp_rec_paths)
    tp_gw_paths, tp_gw_result = phase_tp_gateway(
        card, tp_result["ranks"][0]["wave"]["step_ms_median"])
    by_path.update(tp_gw_paths)
    by_path["dryrun_decode_32k"], dryrun_result = phase_dryrun(device, card)

    # each kernel's launches come from the path it serves
    main_path = {"cim_gemv": "decode", "swiglu_qgemv": "decode",
                 "paged_flash_decode": "decode",
                 "paged_flash_verify": "spec_ngram",
                 "flash_decode": "contiguous_decode"}
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
    log("training summary " + json.dumps(train_result))
    log("other paths summary " + json.dumps(other_result))
    log("tp summary " + json.dumps(tp_result))
    log("tp moe / mla summary " + json.dumps(tp_moe_result))
    log("tp recurrent summary " + json.dumps(tp_rec_result))
    log("tp gateway summary " + json.dumps(tp_gw_result))
    log("dry-run / DSE summary " + json.dumps(dryrun_result))
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
