"""Serving launcher for the PyTorch port.

  python -m repro_torch.launch.serve --arch qwen2.5-3b --requests 4 \
      --tokens 16                                   # on the card
  python -m repro_torch.launch.serve --arch qwen2.5-3b --smoke \
      --device cpu --requests 3 --tokens 6          # plain versions, CPU
  python -m repro_torch.launch.serve --spec ngram --spec-k 4   # speculative
  python -m repro_torch.launch.serve --trace ...   # engine spans, counted
  python -m repro_torch.launch.serve --arch gemma3-4b --smoke \
      --device cpu --spec ngram     # also gemma2-27b, phi3-medium-14b
  python -m repro_torch.launch.serve --arch gemma2-27b --layers 4   # card
  python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \
      --smoke --device cpu [--spec ngram]      # Mixture-of-Experts
  python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \
      --layers 4                               # card: full width, 4 layers
  python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \
      --smoke --device cpu [--spec ngram|model]   # MLA + MoE
  python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \
      --layers 8                               # card: full width, 8 layers
  python -m repro_torch.launch.serve --arch xlstm-1.3b --smoke \
      --device cpu                             # recurrent: mLSTM + sLSTM
  python -m repro_torch.launch.serve --arch zamba2-7b --smoke \
      --device cpu                             # hybrid: Mamba2 + shared attn
  python -m repro_torch.launch.serve --arch zamba2-7b --layers 27   # card
  python -m repro_torch.launch.serve --gateway --replicas 2 \
      --policy prefix --port 8151          # HTTP/SSE gateway, 2 replicas
  python -m repro_torch.launch.serve --tp 2      # 2 tensor-parallel ranks
  python -m repro_torch.launch.serve --smoke --device cpu --tp 2
  python -m repro_torch.launch.serve --gateway --tp 2 --replicas 2 \
      --smoke --device cpu --port 8151    # the gateway on rank 0 of 2

Recurrent and hybrid families (xlstm, zamba) keep per-lane state in the
engine's StateArena: `--spec` on them is a capability error, and
`--no-prefix-cache` is implied (`check_capabilities`), as in the JAX
launcher.

`--gateway` serves HTTP instead of the offline request sweep, as the
JAX launcher does: SSE streaming `POST /v1/completions`, `GET /metrics`
(`?format=prometheus` too), `/healthz`, `/debug/trace` and `/debug/slo`
until Ctrl-C, over `--replicas` engines behind a `FleetRouter`
(`--policy`, `--max-pending` per replica, `--slo` burn-rate alerting).
The replicas share one card and one copy of the packed weights; each
has its own KV pool, CUDA graphs, stream and driver thread.

`--tp N` serves one engine over N tensor-parallel ranks: the launcher's
process is rank 0 and spawns ranks 1..N-1 (torch.multiprocessing, start
method "spawn") on a gloo group over loopback (its collectives time out
after `GROUP_TIMEOUT_S`, so a dead rank ends the others); each draws the
same weights from `--seed` and keeps its slice of the heads, the FFN
width, the experts and the vocab (`repro_torch.dist.shard`; the
recurrent cells and their state by `recurrent_splits`), and rank 0
prints the results.  On the card the ranks share the cards there are
(rank r on card r mod count: two ranks on one card with one card), and
the steps run eagerly.  Every family (`--arch qwen3-moe-235b-a22b
--layers 4 --tp 2`, `--arch deepseek-v2-lite-16b --smoke --device cpu
--tp 2`, `--arch xlstm-1.3b --tp 2`, `--arch zamba2-7b --layers 27 --tp
2`).  With `--gateway` (replicas x tp, as in the JAX launcher) every
rank builds the same `--replicas` engines in the same order, each on
its own pair of groups (`dist.shard.replica_groups`), the first from
the full weights and every other over the first one's shard (one copy
of the rank's shard a rank, as at tp = 1 one copy on the card); rank 0
serves HTTP over them and leads each engine (`dist.lockstep`), the
other ranks follow each engine on a thread of its own
(`dist.lockstep.follow`) and wait for rank 0's fleet messages
(`dist.lockstep.FleetChannel`): a program that drives rank 0 grows the
fleet while it serves with `add_tp_replica`, and every rank builds the
new replica over the same shard.  Ctrl-C (SIGINT to the launcher) stops
rank 0's gateway, which sends every engine's STOP tick and the fleet's
STOP, and the other ranks exit 0; they ignore SIGINT themselves.

Weights are random, drawn from `--seed` on the serving device and
quantized leaf by leaf (so a full-width model never holds all its float
weights at once).  Runs on CUDA unless `--device cpu` is given; with no
card it stops instead of falling back to the CPU.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import signal
import socket
import sys
import time
from collections import Counter

import numpy as np


def check_capabilities(model, spec_mode: str, no_prefix_cache: bool):
    """Validate the capability flags against the model's decode-state
    layout; returns the `prefix_cache` flag for `PagedServeEngine`.

    Prefix sharing and speculative decoding operate on attention KV
    pages only.  A model with recurrent state layers cannot rewind or
    adopt that state, so `--spec` raises a ValueError naming the
    capability, and the prefix cache is turned off (`--no-prefix-cache`
    implied) rather than erroring: there is no affirmative prefix flag
    to contradict."""
    from repro_torch.serve.engine import capability_error
    if model.supports_paged():
        return not no_prefix_cache
    if spec_mode != "off":
        raise ValueError(f"--spec {spec_mode}: "
                         + capability_error(model, "speculative-decoding"))
    if not no_prefix_cache:
        print(f"[serve] family {model.cfg.family!r} has recurrent state "
              "layers: --no-prefix-cache implied (prefix sharing is an "
              "attention-only capability)")
    return False


def build_model(cfg, precision: str, group: int, device, seed: int = 0):
    """(DecoderLM, params) with weights drawn on `device` from `seed`,
    packed per leaf when `precision` is int4/int8."""
    import functools

    import torch

    from repro_torch.models import DecoderLM, init_params
    from repro_torch.quant.ptq import quantize_leaf

    model = DecoderLM(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    leaf_fn = None
    if precision in ("int4", "int8"):
        leaf_fn = functools.partial(
            quantize_leaf, bits=4 if precision == "int4" else 8, group=group)
    params = init_params(model.param_specs(), gen, device,
                         dtype_override=torch.float32, leaf_fn=leaf_fn)
    return model, params


def build_draft(cfg, device):
    """The `--spec model` drafter: one layer of the target's shape at
    half width, float weights drawn on `device` from seed 7.  An explicit
    `head_dim` (gemma, phi3) stays, so the draft's heads keep the
    target's width; its one layer is local where the target's first is
    (and a MoE model's leading dense layer where it has one, as for
    deepseek; MLA's latent widths stay the target's)."""
    import torch

    from repro_torch.models import DecoderLM, init_params

    dcfg = cfg.replace(name=cfg.name + "-draft", n_layers=1,
                       d_model=max(cfg.d_model // 2, 32),
                       d_ff=max(cfg.d_ff // 2, 64))
    draft = DecoderLM(dcfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    return draft, init_params(draft.param_specs(), gen, device,
                              dtype_override=torch.float32)


def replica_engines(args, model, params, serve_cfg, spec_cfg, device):
    """The gateway's `args.replicas` engines: the first from `params`,
    every other over the first one's packed weights (its `params`), so
    a card holds one copy at tp = 1 and a rank one shard at tp > 1
    (`replica_engine`)."""
    eng = replica_engine(model, params, serve_cfg, spec_cfg, device)
    return [eng] + [replica_engine(model, eng.params, eng.config, spec_cfg,
                                   device)
                    for _ in range(args.replicas - 1)]


def replica_engine(model, params, serve_cfg, spec_cfg, device):
    """One replica's engine; at tp > 1 on a new pair of groups
    (`replica_groups`: every rank makes them, in the same order)."""
    from repro_torch.serve import PagedServeEngine
    groups = {}
    if serve_cfg.tp > 1:
        from repro_torch.dist import replica_groups
        groups = dict(zip(("group", "tick_group"),
                          replica_groups(serve_cfg.tp)))
    return PagedServeEngine(model, params, serve_cfg, spec=spec_cfg,
                            device=device, **groups)


def add_tp_replica(router, channel, build):
    """Rank 0 of a tensor-parallel fleet grows it by one replica while
    it serves (JAX's `FleetRouter.add_replica` at any tp): the fleet
    channel's ADD first, since every rank makes the new groups and the
    other ranks wait for rank 0's messages, then `build()` (the engine
    on its new groups, over the rank's shard, as the other ranks build
    theirs: `follow_engines`) into the router.  Returns the replica."""
    from repro_torch.dist import FleetChannel
    channel.send(FleetChannel.ADD, len(router.replicas) + 1)
    return router.add_replica(build())


def follow_engines(engines, channel, build):
    """Ranks >= 1 under `--gateway`: follow each engine on a thread of
    its own (`follow_all`) and take rank 0's fleet messages
    (`FleetChannel`) on another: at ADD build the next replica
    (`build()`, as rank 0 does in `add_tp_replica`) and follow it too;
    return (the engines, their threads) once the fleet's STOP came and
    every engine's STOP tick.  A thread that fails, a build that fails
    or a message out of step fails the rank (raises: its process exits,
    so rank 0's next collective with it fails at once)."""
    import queue
    import threading

    from repro_torch.dist import FleetChannel, LockstepError, follow_all
    engines = list(engines)
    runs = [follow_all(engines)]        # (threads, outcomes) a start
    inbox: "queue.Queue" = queue.Queue()

    def listen():
        try:
            while True:
                msg = channel.recv()
                inbox.put(msg)
                if msg[0] == FleetChannel.STOP:
                    return
        except Exception as e:      # the rank's end: its main thread
            inbox.put(e)            # raises it
    threading.Thread(target=listen, daemon=True,
                     name="fleet-channel").start()
    stopped = False
    while True:
        try:
            msg = inbox.get(timeout=0.2)
        except queue.Empty:
            msg = None
        if isinstance(msg, BaseException):
            raise msg
        if msg is not None:
            op, n = msg
            if n != len(engines) + (op == FleetChannel.ADD):
                raise LockstepError(
                    f"rank 0's fleet message {msg} where this rank has "
                    f"{len(engines)} replicas")
            if op == FleetChannel.STOP:
                stopped = True
            else:
                engines.append(build())
                runs.append(follow_all(engines[-1:],
                                       first=len(engines) - 1))
        threads = [t for ts, _ in runs for t in ts]
        failed = [o for _, os in runs for o in os
                  if isinstance(o, BaseException)]
        if failed:
            raise failed[0]
        if stopped and not any(t.is_alive() for t in threads):
            return engines, threads


def serve_gateway(args, engines, channel=None) -> None:
    """Serve HTTP over the replicas' engines until Ctrl-C.  Each has its
    own KV pool, CUDA graphs, stream and driver thread; at tp > 1 the
    fleet's STOP goes on `channel` once the gateway stopped."""
    import asyncio
    import sys

    from repro_torch.api import Gateway
    from repro_torch.fleet import FleetRouter

    router = FleetRouter(engines)
    access_log = (sys.stderr if args.access_log == "-"
                  else args.access_log)
    slos = slo_policy = None
    if args.slo is not None:
        from repro_torch.obs.slo import DEFAULT_SLOS, BurnRatePolicy
        slos = list(args.slo) or list(DEFAULT_SLOS)
        slo_policy = BurnRatePolicy(timescale=args.slo_timescale)
        print(f"[serve] SLOs: {', '.join(slos)} "
              f"(timescale {args.slo_timescale:g}, GET /debug/slo)")
    gw = Gateway(router, access_log=access_log, slos=slos,
                 slo_policy=slo_policy)
    try:
        asyncio.run(gw.serve_forever(args.host, args.port))
    except KeyboardInterrupt:      # the gateway stopped its router:
        print("[api] gateway stopped", flush=True)   # STOP ticks at tp > 1
    finally:
        if channel is not None:
            from repro_torch.dist import FleetChannel
            channel.send(FleetChannel.STOP, len(router.replicas))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b",
                    help="qwen2.5-3b, gemma3-4b, gemma2-27b, "
                         "phi3-medium-14b, qwen3-moe-235b-a22b, "
                         "deepseek-v2-lite-16b, xlstm-1.3b or zamba2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = full)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--precision", default=None,
                    choices=["fp", "int8", "int4"],
                    help="serving precision (ServeConfig.precision): "
                         "int4 is the paper's CIM operating point "
                         "(default)")
    ap.add_argument("--quant", default=None,
                    choices=["bf16", "int8", "int4"],
                    help="DEPRECATED alias for --precision "
                         "(bf16 maps to fp)")
    ap.add_argument("--kv-dtype", default="auto",
                    choices=["auto", "bf16", "f32", "int8"])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--spec", default="off",
                    choices=["off", "ngram", "model"],
                    help="speculative decoding drafter (model: a 1-layer "
                         "half-width draft of the same arch)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft window (tokens per verify step)")
    ap.add_argument("--spec-autok", action="store_true",
                    help="autotune the per-step draft length 1..k from "
                         "an EMA of the measured acceptance rate")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true",
                    help="record request/engine spans in the in-memory "
                         "tracer and print their counts (equivalent to "
                         "REPRO_TRACE=1)")
    ap.add_argument("--gateway", action="store_true",
                    help="serve HTTP instead of the offline request "
                         "sweep: SSE streaming POST /v1/completions + "
                         "GET /metrics until Ctrl-C")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8151)
    ap.add_argument("--max-pending", type=int, default=32,
                    help="gateway backpressure: samples in flight PER "
                         "REPLICA before new requests shed fleet-wide "
                         "with 429 + Retry-After")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engine replicas behind the "
                         "gateway (same model, one card, shared "
                         "weights; --gateway mode only)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel devices per engine (shards "
                         "heads/FFN/vocab over a ('model',) mesh; "
                         "composes with --replicas as replicas x tp; "
                         "the port spawns one process per rank on a "
                         "gloo group)")
    ap.add_argument("--policy", default="least-loaded",
                    choices=["rr", "least-loaded", "prefix"],
                    help="fleet dispatch policy: rr cycles replicas, "
                         "least-loaded follows pending depth + KV "
                         "occupancy, prefix routes repeated prompts to "
                         "the replica holding their committed KV pages")
    ap.add_argument("--slo", default=None, nargs="*", metavar="SPEC",
                    help="enable the SLO engine (--gateway mode): pass "
                         "spec strings like 'ttft_p95_s < 0.5' "
                         "'error_rate < 0.01', or no specs for the "
                         "defaults; burn-rate alerts + per-replica "
                         "drift audit served at GET /debug/slo")
    ap.add_argument("--slo-timescale", type=float, default=1.0,
                    help="compress the SRE burn-rate windows by this "
                         "factor (1/600 maps the 1h page window to 6 s)")
    ap.add_argument("--access-log", default=None, metavar="PATH",
                    help="append one structured JSON line per gateway "
                         "request (rid, replica, policy, status, ttft, "
                         "tokens) to PATH ('-' for stderr)")
    args = ap.parse_args(argv)

    # --quant predates ServeConfig; keep it working as an alias
    precision = args.precision
    if args.quant is not None:
        if precision is not None:
            raise SystemExit("pass --precision or --quant, not both")
        import warnings
        warnings.warn("--quant is deprecated; use --precision "
                      "(bf16 -> fp)", DeprecationWarning)
        precision = {"bf16": "fp", "int8": "int8",
                     "int4": "int4"}[args.quant]
    if precision is None:
        precision = "int4"          # the paper's operating point
    if args.replicas < 1:
        raise SystemExit(f"--replicas {args.replicas}: need at least 1")
    if args.replicas > 1 and not args.gateway:
        raise SystemExit("--replicas > 1 requires --gateway (the offline "
                         "sweep runs one engine)")
    if args.slo is not None and not args.gateway:
        raise SystemExit("--slo requires --gateway (burn-rate alerting "
                         "evaluates the live serving loop)")
    if args.tp < 1:
        raise SystemExit(f"--tp {args.tp}: need at least 1")
    if args.tp > 1:
        spawn_ranks(args, precision)
        return None, []
    return serve(args, precision)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(args, precision: str) -> None:
    """Run `serve` as rank 0 in this process and as ranks 1..tp-1 in
    spawned ones, on a gloo group over loopback; a rank that fails fails
    the launch (rank 0's failure ends the others)."""
    import torch.multiprocessing as mp
    init = f"tcp://127.0.0.1:{_free_port()}"
    ctx = mp.start_processes(_follower_main, args=(args, precision, init),
                             nprocs=args.tp - 1, join=False,
                             start_method="spawn")
    try:
        _rank_main(0, args, precision, init)
    except BaseException:
        for p in ctx.processes:
            p.terminate()
        raise
    while not ctx.join():
        pass


def _follower_main(i: int, args, precision: str, init: str) -> None:
    # rank 0 stops the followers (its STOP ticks): a terminal's Ctrl-C,
    # sent to every process of the group, is rank 0's to handle
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    sys.stdout = open(os.devnull, "w")      # rank 0 prints the results
    _rank_main(i + 1, args, precision, init)


def _rank_main(rank: int, args, precision: str, init: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.dist.shard import GROUP_TIMEOUT_S
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.tp))
    elif torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=args.tp,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        serve(args, precision)
    finally:
        dist.destroy_process_group()


def serve(args, precision: str):
    """Build the model and the engine (one rank's, under --tp), serve
    the offline request sweep or the gateway, and print the results."""
    if args.trace:
        from repro_torch.obs import get_tracer
        get_tracer().enable()

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.serve import (PagedServeEngine, SamplingParams,
                                   ServeConfig, ServeRequest)

    device = resolve_device(args.device)
    if args.tp > 1 and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).replace(dtype="float32", remat=False)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    if not cfg.embed_inputs:
        raise SystemExit(f"{args.arch} takes frontend-stub embeddings; the "
                         "token engine serves token-input archs")
    group = 16 if args.smoke else 128
    from repro_torch.models import DecoderLM
    prefix_cache = check_capabilities(DecoderLM(cfg), args.spec,
                                      args.no_prefix_cache)
    t0 = time.perf_counter()
    model, params = build_model(cfg, precision, group, device, args.seed)
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(4, 17, size=args.requests)]
    serve_cfg = ServeConfig(
        precision=precision, kv_dtype=args.kv_dtype, quant_group=group,
        max_batch=args.batch, max_seq=args.max_seq,
        page_size=args.page_size, n_pages=args.pages or None,
        prefix_cache=prefix_cache, seed=args.seed, replicas=args.replicas,
        policy=args.policy, max_pending=args.max_pending, tp=args.tp)
    spec_cfg = None
    if args.spec != "off":
        from repro_torch.spec import SpecConfig
        if args.spec == "model":
            draft, dparams = build_draft(cfg, device)
            spec_cfg = SpecConfig(k=args.spec_k, drafter="model",
                                  draft_model=draft, draft_params=dparams,
                                  draft_page_size=args.page_size,
                                  autok=args.spec_autok)
        else:
            spec_cfg = SpecConfig(k=args.spec_k, drafter="ngram",
                                  autok=args.spec_autok)
    if args.gateway:
        engines = replica_engines(args, model, params, serve_cfg, spec_cfg,
                                  device)
        del params
        if args.tp == 1:
            serve_gateway(args, engines)
            return engines[0], []
        from repro_torch.dist import FleetChannel, fleet_group
        channel = FleetChannel(fleet_group(args.tp))
        if channel.leader:
            serve_gateway(args, engines, channel)
        else:
            follow_engines(engines, channel, functools.partial(
                replica_engine, model, engines[0].params,
                engines[0].config, spec_cfg, device))
        return engines[0], []
    eng = PagedServeEngine(model, params, serve_cfg, spec=spec_cfg,
                           device=device)
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    reqs = [ServeRequest(prompt=p, max_new_tokens=args.tokens, rid=i,
                         sampling=sampling) for i, p in enumerate(prompts)]
    eng.run(reqs)
    m = eng.summary()
    tp_txt = (f", tp {args.tp} ({args.tp} ranks over gloo, steps eager)"
              if args.tp > 1 else "")
    print(f"[serve] {cfg.name} x{cfg.n_layers} layers, {precision} "
          f"weights, kv {eng.config.as_dict()['kv_dtype_resolved']}, "
          f"setup {setup_s:.1f} s{tp_txt}")
    print(f"[serve] {int(m['tokens'])} tokens, "
          f"{eng.throughput():.1f} tok/s decode, "
          f"ttft p50 {m['ttft_p50_s'] * 1e3:.1f} ms, "
          f"kv occupancy peak {m['kv_occupancy_peak'] * 100:.0f}% "
          f"({device})")
    if spec_cfg is not None:
        acc = m["spec_acceptance_rate"]
        acc_txt = (f"{acc * 100:.0f}%" if np.isfinite(acc)
                   else "n/a (0 drafted)")
        print(f"[serve] spec[{args.spec} k={args.spec_k}] acceptance "
              f"{acc_txt}, {m['tokens_per_decode_step']:.2f} tokens per "
              f"lane per decode step, {eng.verify_calls} verify + "
              f"{eng.decode_calls} plain decode calls")
    print(f"[serve] EdgeCIM cost model (simulated, not measured): "
          f"{m['sim_tokens_per_j']:.2f} tok/J, "
          f"{m['sim_tokens_per_s']:.1f} tok/s, "
          f"{m['sim_energy_j']:.4g} J for "
          f"{int(m['sim_decode_tokens'])} decode tokens at "
          f"w{int(m['sim_w_bits'])}/a{int(m['sim_a_bits'])}")
    if args.trace:
        names = Counter(e["name"] for e in eng.tracer.events())
        print(f"[serve] trace: {sum(names.values())} events "
              + json.dumps(dict(sorted(names.items()))))
    print("[serve] streams " + json.dumps([r.out_tokens for r in reqs]))
    return eng, reqs


if __name__ == "__main__":
    main()
