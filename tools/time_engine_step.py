#!/usr/bin/env python3
"""Time the port's graph decode step end to end on one NVIDIA GPU, for
one or more source trees, in turns.

  python3 tools/time_engine_step.py                  # this tree
  python3 tools/time_engine_step.py --src A/src --src B/src --src B/src \
      --src A/src                                    # A, B, B, A
  python3 tools/time_engine_step.py --smoke --device cpu   # dry run

Each `--src` runs in its own process, which imports `repro_torch` from
that directory (and builds its kernels there).  A run serves what
chip_smoke.py's phase 3 serves: qwen2.5-3b at full width (36 layers,
INT4 weights drawn from seed 0 on the card, INT8 paged KV) through
`PagedServeEngine` with its steps as CUDA graphs, 4 requests of 16-64
prompt tokens and 16 new tokens each.  The first wave captures the
graphs; then `--waves` waves of new prompts (the same prompts in every
run) are timed.  A step's wall time runs from `step()` to a
`torch.cuda.synchronize()` after it; steps that made a prefill call are
left out, so the median is the decode step's.  The tracer stays off
(`REPRO_TRACE` is dropped from each run's environment).

Prints one JSON object per run with the decode step wall median, its
quartiles, the steps timed and the card's name and power limit.
Imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def worker(src: str, waves: int, smoke: bool, device: str,
           card: str) -> None:
    sys.path.insert(0, src)
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.serve import build_model
    from repro_torch.serve import PagedServeEngine, ServeConfig, ServeRequest

    cfg = (get_smoke_config("qwen2.5-3b") if smoke
           else get_config("qwen2.5-3b")).replace(dtype="float32",
                                                  remat=False)
    model, params = build_model(cfg, "int4", 16 if smoke else 128, device,
                                seed=0)
    eng = PagedServeEngine(model, params, ServeConfig(
        precision="int4", kv_dtype="auto", max_batch=4, max_seq=128,
        page_size=16, prefill_chunk=16), device=device)
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))
    rng = np.random.default_rng(0)
    step_ms = []
    for w in range(waves + 1):
        for i, n in enumerate(rng.integers(16, 65, size=4)):
            eng.submit(ServeRequest(
                prompt=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                max_new_tokens=16, rid=4 * w + i))
        while eng.busy:
            pre = eng.prefill_calls
            t0 = time.perf_counter()
            eng.step()
            sync()
            if w and eng.prefill_calls == pre:     # wave 0 captures
                step_ms.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(step_ms, [25, 50, 75])
    rec = getattr(eng, "recorder", None)
    print(json.dumps({
        "src": src, "model": f"{cfg.name} x{cfg.n_layers}",
        "device": str(eng.device), "waves": waves, "steps": len(step_ms),
        "decode_step_ms_median": float(med), "decode_step_ms_q1": float(q1),
        "decode_step_ms_q3": float(q3),
        "recorder_pushes": rec.pushes if rec is not None else None,
        "tracer_on": bool(getattr(getattr(eng, "tracer", None), "enabled",
                                  False)),
        "card": card}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append",
                    help="a tree's src/ directory (repeatable; default: "
                         "this tree's)")
    ap.add_argument("--waves", type=int, default=8,
                    help="waves timed after the capturing one")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke-sized model (a dry run of the script)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--card", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.waves, args.smoke, args.device, args.card)
        return
    card = ""
    if args.device != "cpu":
        import torch
        if not torch.cuda.is_available():
            sys.exit("time_engine_step: no CUDA device is available")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
                else "")
        print(card, flush=True)
    srcs = args.src or [str(Path(__file__).resolve().parent.parent / "src")]
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "REPRO_TRACE")}
    for src in srcs:
        cmd = [sys.executable, __file__, "--worker", str(Path(src).resolve()),
               "--waves", str(args.waves), "--device", args.device,
               "--card", card] + (["--smoke"] if args.smoke else [])
        rc = subprocess.run(cmd, env=env, timeout=900).returncode
        if rc:
            sys.exit(f"time_engine_step: the run on {src} failed ({rc})")


if __name__ == "__main__":
    main()
