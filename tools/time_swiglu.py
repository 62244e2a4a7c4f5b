#!/usr/bin/env python3
"""Time the port's `swiglu_qgemv` on one NVIDIA GPU, for one or more
source trees, in turns.

  python3 tools/time_swiglu.py                       # this tree
  python3 tools/time_swiglu.py --src A/src --src B/src --src B/src \
      --src A/src                                    # A, B, B, A
  python3 tools/time_swiglu.py --parts               # where the time goes

Each `--src` runs in its own process, which imports `repro_torch` from
that directory (and builds its kernels there).  A run draws the gate
and up weights of qwen2.5-3b's 36 layers (2048 -> 11008, INT4, group
128) from seed 0 on the card, checks one call against the plain
version, and times the 36 calls of one step at M = 4 (decode, batch 4)
and M = 20 (a verify step, batch 4 x k + 1 = 5) as a CUDA-graph replay
(0.84 GB of weights: cold in the 50 MB L2).

`--parts` also times copies of the tree's kernel with pieces taken out
(their outputs are wrong and not checked): without the weight copies,
without the FFMAs, without both (what is left is each block's fixed
chain: launch, x and scales, the warps' sum, the partials and the split
sum), and without the cross-block split sum.  They are built with the
tree's nvcc flags into its gitignored build/ directory.

Prints one JSON object per timing, with the card's name and power
limit.  Imports nothing of JAX; needs a CUDA device.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
LAYERS, D, F = 36, 2048, 11008
# (name, [(text of csrc/swiglu_gemv.cu, replacement)]) of the --parts runs
COPY = "if (p < min(rows, (warp + 1) * PL) && cb < F)"
COMPUTE = "if (!mine) continue;"
SPLIT_SUM = "  if (splits == 1) return;"
PARTS = [("no weight copies", [(COPY, "if (false)")]),
         ("no FFMAs", [(COMPUTE, "continue;")]),
         ("fixed chain only", [(COPY, "if (false)"), (COMPUTE, "continue;")]),
         ("no split sum", [(SPLIT_SUM, "  return;")])]


def graph_ms(fn, iters=20):
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(2):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_parts(src: str):
    """{part name: loaded library} for the --parts copies of the tree's
    kernel, all `nvcc`s started together."""
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "time_swiglu"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "swiglu_gemv.cu").read_text()
    procs = []
    for i, (name, edits) in enumerate(PARTS):
        part = text
        for old, new in edits:
            if old not in part:
                sys.exit(f"time_swiglu: {src} has no `{old}` to take out")
            part = part.replace(old, new)
        cu, so = out_dir / f"part{i}.cu", out_dir / f"libpart{i}.so"
        cu.write_text(part)
        procs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"time_swiglu: nvcc failed for `{name}`:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def worker(src: str, parts: bool, card: str) -> None:
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import swiglu_gemv as sw
    from repro_torch.quant.qarray import quantize
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    layers = [(quantize(torch.randn(D, F, generator=gen, device=dev) * 0.02,
                        4, 128),
               quantize(torch.randn(D, F, generator=gen, device=dev) * 0.02,
                        4, 128)) for _ in range(LAYERS)]
    nbytes = sum(g.nbytes_packed() + u.nbytes_packed() for g, u in layers)

    def run(m, label, check=True):
        x = torch.randn(m, D, generator=gen, device=dev)
        out = sw.swiglu_qgemv(x, *layers[0])
        ref = sw.swiglu_plain(x, *layers[0])
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = 1e-4 * float(ref.abs().max()) + 1e-6
        ms = graph_ms(lambda: [sw.swiglu_qgemv(x, g, u) for g, u in layers])
        b = nbytes + LAYERS * 4 * m * (D + F)
        fl = LAYERS * 2 * 2 * m * D * F
        bound = max(b / HBM_BYTES_PER_S, fl / F32_FLOPS) * 1e3
        print(json.dumps({
            "src": src, "kernel": label, "M": m, "calls": LAYERS, "ms": ms,
            "bound_ms": bound, "bound_share": bound / ms,
            "max_abs_err": err if check else None, "tol": tol,
            "ok": err <= tol if check else None, "card": card}), flush=True)

    for m in (4, 20):
        run(m, "whole")
    if parts:
        typed = sw._lib()                # the tree's own argument types
        for name, lib in build_parts(src).items():
            lib.swiglu_qgemv.argtypes = typed.swiglu_qgemv.argtypes
            lib.swiglu_qgemv.restype = typed.swiglu_qgemv.restype
            lib.swiglu_gemv_error_string.argtypes = [ctypes.c_int]
            lib.swiglu_gemv_error_string.restype = ctypes.c_char_p
            sw._lib = lambda lib=lib: lib
            for m in (4, 20):
                run(m, name, check=False)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append",
                    help="a tree's src/ directory (repeatable; default: "
                         "this tree's)")
    ap.add_argument("--parts", action="store_true",
                    help="also time the kernel with pieces taken out")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--card", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.parts, args.card)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_swiglu: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card, flush=True)
    srcs = args.src or [str(Path(__file__).resolve().parent.parent / "src")]
    for src in srcs:
        cmd = [sys.executable, __file__, "--worker",
               str(Path(src).resolve()), "--card", card]
        if args.parts:
            cmd.append("--parts")
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        rc = subprocess.run(cmd, env=env, timeout=900).returncode
        if rc:
            sys.exit(f"time_swiglu: the run on {src} failed ({rc})")


if __name__ == "__main__":
    main()
