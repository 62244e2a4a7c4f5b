"""Serving launcher for the PyTorch port.

  python -m repro_torch.launch.serve --arch qwen2.5-3b --requests 4 \
      --tokens 16                                   # on the card
  python -m repro_torch.launch.serve --arch qwen2.5-3b --smoke \
      --device cpu --requests 3 --tokens 6          # plain versions, CPU
  python -m repro_torch.launch.serve --spec ngram --spec-k 4   # speculative
  python -m repro_torch.launch.serve --trace ...   # engine spans, counted

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
    half width, float weights drawn on `device` from seed 7."""
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = full)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--precision", default="int4",
                    choices=["fp", "int8", "int4"])
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
    args = ap.parse_args(argv)

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
    t0 = time.perf_counter()
    model, params = build_model(cfg, args.precision, group, device,
                                args.seed)
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(4, 17, size=args.requests)]
    serve_cfg = ServeConfig(
        precision=args.precision, kv_dtype=args.kv_dtype, quant_group=group,
        max_batch=args.batch, max_seq=args.max_seq,
        page_size=args.page_size, n_pages=args.pages or None,
        prefix_cache=not args.no_prefix_cache, seed=args.seed)
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
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    reqs = [ServeRequest(prompt=p, max_new_tokens=args.tokens, rid=i,
                         sampling=sampling) for i, p in enumerate(prompts)]
    eng.run(reqs)
    m = eng.summary()
    print(f"[serve] {cfg.name} x{cfg.n_layers} layers, {args.precision} "
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
