#!/usr/bin/env python3
"""Time the port's `paged_flash_verify` on one NVIDIA GPU, for one or
more source trees, in turns.

  python3 tools/time_verify.py                       # this tree
  python3 tools/time_verify.py --src A/src --src B/src --src B/src \
      --src A/src                                    # A, B, B, A
  python3 tools/time_verify.py --min-keys 32 --parts # a plan variant,
                                                     # where time goes

Each `--src` runs in its own process, which imports `repro_torch` from
that directory (and builds its kernels there).  A run draws INT8 K/V
pools for qwen2.5-3b's 36 layers (2 kv heads x 8 query heads, hd 128,
pages of 16) from seed 0 on the card, checks one call against the plain
version (1e-4 * max|plain| + 1e-6), and times the 36 calls of one verify
step (s = 5) as a CUDA-graph replay at two shapes: batch 4 at lengths
1024/777/301/45 before the window over 72-page tables, and batch 1 at
length 4096 over a 260-page table.  A profile of the same calls splits
their device time by kernel.

`--min-keys N` runs every tree with `split_decode.VERIFY_MIN_KEYS` (the
least keys a verify split folds) set to N: the plan's splits change, the
kernel stays.  `--parts` also times copies of the tree's kernel with pieces
taken out (outputs wrong and not checked): without the q . k and p . v
work of the warps, without the K/V tile copies, and without both (what
is left is each block's fixed chain: launch, lengths and page ids, q's
copy, the barriers and the partials), built with the tree's nvcc flags
into its gitignored build/ directory.  Prints one JSON object per
timing, with the card's name and power limit.  Imports nothing of JAX;
needs a CUDA device.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
LAYERS, G, QPK, HD, PS, S_WIN = 36, 2, 8, 128, 16, 5
SHAPES = {"b4": ([1024, 777, 301, 45], 72), "b1": ([4096], 260)}
# (name, [(text of csrc/paged_flash_verify.cu, replacement)]) of --parts
PRODUCTS = "    if (rw0 < rw1) {"
COPIES = "      if (i < KT * Sh::CPR) {"
PARTS = [("no products", [(PRODUCTS, "    if (false) {")]),
         ("no K/V copies", [(COPIES, "      if (false) {")]),
         ("fixed chain only", [(PRODUCTS, "    if (false) {"),
                               (COPIES, "      if (false) {")])]


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


def split_ms(fn, steps=3):
    """{kernel name: device ms per step} from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / steps
    return out


def build_parts(src: str):
    """{part name: library path} for the --parts copies of the tree's
    kernel, all `nvcc`s started together."""
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "time_verify"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "paged_flash_verify.cu").read_text()
    procs = []
    for i, (name, edits) in enumerate(PARTS):
        part = text
        for old, new in edits:
            if part.count(old) != 1:
                sys.exit(f"time_verify: {src} has no single `{old}`")
            part = part.replace(old, new)
        cu, so = out_dir / f"part{i}.cu", out_dir / f"libpart{i}.so"
        cu.write_text(part)
        procs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    paths = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"time_verify: nvcc failed for `{name}`:\n{log}")
        paths[name] = so
    return paths


def worker(src: str, min_keys: int, parts: bool, card: str) -> None:
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import _build, split_decode
    from repro_torch.kernels import paged_flash_decode as pfd
    if min_keys:
        split_decode.VERIFY_MIN_KEYS = min_keys
    libs = [("whole", None)]
    if parts:
        libs += list(build_parts(src).items())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, (lens, max_pages) in SHAPES.items():
        b = len(lens)
        n_pages = b * max_pages
        kf = torch.randn(LAYERS, n_pages, PS, G, HD, generator=gen,
                         device=dev)
        vf = torch.randn(LAYERS, n_pages, PS, G, HD, generator=gen,
                         device=dev)
        ks = (kf.abs().amax(-1).clamp_min(1e-8) / 127).half()
        vs = (vf.abs().amax(-1).clamp_min(1e-8) / 127).half()
        kp = torch.round(kf / ks[..., None].float()).clamp(-127, 127).to(
            torch.int8)
        vp = torch.round(vf / vs[..., None].float()).clamp(-127, 127).to(
            torch.int8)
        del kf, vf
        q = torch.randn(b, S_WIN, G, QPK, HD, generator=gen, device=dev)
        tables = torch.randperm(n_pages, generator=gen, device=dev
                                ).reshape(b, max_pages).int()
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)

        def step(fn):
            for i in range(LAYERS):
                fn(q, kp[i], vp[i], tables, lengths, 0, 0.0, ks[i], vs[i])

        rows = sum(lens) + b * S_WIN
        keys = sum(S_WIN * n + S_WIN * (S_WIN + 1) // 2 for n in lens)
        nbytes = LAYERS * (rows * G * (2 * HD + 4) + 2 * q.numel() * 4
                           + b * (max_pages + 1) * 4)
        flops = LAYERS * keys * G * QPK * HD * 4
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
        plan = (pfd.verify_plan(b, G, S_WIN, QPK, max_pages, PS)
                if hasattr(pfd, "verify_plan") else None)
        for label, so in libs:
            if so is not None:      # the part, typed by the wrapper
                _build._LIBS["paged_flash_verify"] = ctypes.CDLL(str(so))
            out = pfd.paged_flash_verify(q, kp[0], vp[0], tables, lengths,
                                         0, 0.0, ks[0], vs[0])
            ref = pfd.paged_verify_plain(q, kp[0], vp[0], tables, lengths,
                                         0, 0.0, ks[0], vs[0])
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            tol = 1e-4 * float(ref.abs().max()) + 1e-6
            ms = graph_ms(lambda: step(pfd.paged_flash_verify))
            split = split_ms(lambda: step(pfd.paged_flash_verify))
            print(json.dumps({
                "src": src, "kernel": label, "min_keys": min_keys or None,
                "shape": shape, "calls": LAYERS, "ms": ms,
                "bound_ms": bound, "bound_share": bound / ms,
                "device_split_ms": split, "plan": plan,
                "max_abs_err": err if so is None else None, "tol": tol,
                "ok": err <= tol if so is None else None, "card": card}),
                flush=True)
        _build._LIBS.pop("paged_flash_verify", None)
        del kp, vp, ks, vs
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append",
                    help="a tree's src/ directory (repeat; default: this "
                    "tree's)")
    ap.add_argument("--min-keys", type=int, default=0,
                    help="set split_decode.VERIFY_MIN_KEYS in every run")
    ap.add_argument("--parts", action="store_true",
                    help="also time the kernel with pieces taken out")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_verify: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if args.worker:
        worker(args.worker, args.min_keys, args.parts, card)
        return
    here = str(Path(__file__).resolve().parents[1] / "src")
    for src in args.src or [here]:
        cmd = [sys.executable, __file__, "--worker", str(Path(src).resolve()),
               "--min-keys", str(args.min_keys)]
        if args.parts:
            cmd.append("--parts")
        rc = subprocess.run(cmd, timeout=900).returncode
        if rc:
            sys.exit(f"time_verify: the run of {src} failed ({rc})")


if __name__ == "__main__":
    main()
