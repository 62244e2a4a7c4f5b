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

Weights are random, drawn from `--seed` on the serving device and
quantized leaf by leaf (so a full-width model never holds all its float
weights at once).  Runs on CUDA unless `--device cpu` is given; with no
card it stops instead of falling back to the CPU.
"""
from __future__ import annotations

import argparse
import json
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


def serve_gateway(args, model, eng, spec_cfg, device) -> None:
    """Serve HTTP over `args.replicas` engines until Ctrl-C.  The
    replicas share `eng`'s packed weights (one copy on the card); each
    gets its own KV pool, CUDA graphs, stream and driver thread."""
    import asyncio
    import sys

    from repro_torch.api import Gateway
    from repro_torch.fleet import FleetRouter
    from repro_torch.serve import PagedServeEngine

    engines = [eng] + [PagedServeEngine(model, eng.params, eng.config,
                                        spec=spec_cfg, device=device)
                       for _ in range(args.replicas - 1)]
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
    except KeyboardInterrupt:
        print("[api] gateway stopped")


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

    if args.trace:
        from repro_torch.obs import get_tracer
        get_tracer().enable()

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.serve import (PagedServeEngine, SamplingParams,
                                   ServeConfig, ServeRequest)

    device = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).replace(dtype="float32", remat=False)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
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
        policy=args.policy, max_pending=args.max_pending)
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
    eng = PagedServeEngine(model, params, serve_cfg, spec=spec_cfg,
                           device=device)
    if args.gateway:
        serve_gateway(args, model, eng, spec_cfg, device)
        return eng, []
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    reqs = [ServeRequest(prompt=p, max_new_tokens=args.tokens, rid=i,
                         sampling=sampling) for i, p in enumerate(prompts)]
    eng.run(reqs)
    m = eng.summary()
    print(f"[serve] {cfg.name} x{cfg.n_layers} layers, {precision} "
          f"weights, kv {eng.config.as_dict()['kv_dtype_resolved']}, "
          f"setup {setup_s:.1f} s")
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
    return eng, reqs


if __name__ == "__main__":
    main()
