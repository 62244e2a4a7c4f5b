"""Aggregate dry-run + probe JSONs into a roofline table, on the H100's
numbers (`roofline/analysis.py`).

Per (arch x shape) cell it merges:
  * probe JSON (full-depth flops / bytes / collective bytes from the
    two-point layer extrapolation),
  * full meta-run JSON (memory_per_device: peak bytes per device),
and derives the three roofline terms, dominant bottleneck, usefulness
ratios, and the roofline fraction:

    fraction = max(model_flops/PEAK, model_bytes/HBM) / bound_time

(model_bytes only for decode cells — decode moves bytes, not flops, so
its usefulness is bandwidth-side; train/prefill use the MFU-style
flops fraction.)  The memory term reads a record's `min_bytes`, the
bytes its step must move; a JAX record, which has none, gives XLA's
bytes accessed (`hlo_bytes`).  A record's own `collective_bw` (its mesh's slowest
link) sets its collective term; a JAX record, which has none, gets the
production meshes' cross-node rate.  The port's full records count
every layer and time step (no scan undercount), so a cell without a
probe reads `full`.

Usage:  PYTHONPATH=src python -m repro_torch.roofline.report [--md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Optional

from .analysis import COLLECTIVE_BW, HBM_BW, PEAK_FLOPS

N_DEVICES = 256             # the single-pod production mesh


def _is_baseline(fn: str) -> bool:
    # perf-iteration artifacts carry an extra __tag suffix; the baseline
    # table uses exactly arch__shape__mesh__quant.json
    return len(os.path.basename(fn)[:-5].split("__")) == 4


def load_results(dryrun_dir: str = "results/dryrun_torch",
                 probe_dir: str = "results/probe_torch") -> Dict:
    cells: Dict[tuple, Dict] = {}
    for fn in sorted(glob.glob(os.path.join(probe_dir, "*.json"))):
        if not _is_baseline(fn):
            continue
        with open(fn) as f:
            rec = json.load(f)
        key = (rec["arch"], rec["shape"], rec["quant"])
        cells.setdefault(key, {})["probe"] = rec
    for fn in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        if not _is_baseline(fn):
            continue
        with open(fn) as f:
            rec = json.load(f)
        key = (rec["arch"], rec["shape"], rec["quant"])
        cells.setdefault(key, {})[f"full_{rec['mesh']}"] = rec
    return cells


def derive_row(arch: str, shape: str, quant: str, entry: Dict
               ) -> Optional[Dict]:
    probe = entry.get("probe")
    full = entry.get("full_single")
    if probe is None and full is None:
        return None
    src = probe or full
    from repro_torch.configs.registry import SHAPES, get_config
    from repro_torch.launch.params_count import decode_model_bytes
    kind = SHAPES[shape][2]
    n_dev = src.get("n_devices", N_DEVICES)

    t_c = src["flops"] / PEAK_FLOPS
    t_m = src.get("min_bytes", src["hlo_bytes"]) / HBM_BW
    t_x = src["collective_bytes"] / src.get("collective_bw", COLLECTIVE_BW)
    bound = max(t_c, t_m, t_x)
    dominant = {t_c: "compute", t_m: "memory", t_x: "collective"}[bound]

    model_flops = src["model_flops"]
    useful_t = model_flops / PEAK_FLOPS
    model_bytes = None
    if kind == "decode":
        cfg = get_config(arch)
        model_bytes = decode_model_bytes(cfg, shape, quant, n_dev)
        useful_t = max(useful_t, model_bytes / HBM_BW)
    fraction = useful_t / bound if bound else 0.0

    row = {
        "arch": arch, "shape": shape, "quant": quant, "kind": kind,
        "t_compute_ms": t_c * 1e3, "t_memory_ms": t_m * 1e3,
        "t_collective_ms": t_x * 1e3, "dominant": dominant,
        "model_flops": model_flops, "model_bytes": model_bytes,
        "useful_flops_ratio": (model_flops / src["flops"]
                               if src["flops"] else 0.0),
        "roofline_fraction": fraction,
        "source": "probe" if probe else "full",
    }
    if full and full.get("memory_per_device"):
        row["peak_hbm_gib"] = full["memory_per_device"]["peak_bytes"] / 2**30
        row["fits_80g"] = row["peak_hbm_gib"] < 80e9 / 2**30
    if entry.get("full_multi"):
        row["multi_pod_ok"] = entry["full_multi"]["status"] == "ok"
    coll = src.get("collective_detail", {})
    if coll:
        top = max(coll, key=coll.get)
        row["top_collective"] = f"{top}:{coll[top]/2**20:.0f}MiB"
    return row


def bottleneck_sentence(row: Dict) -> str:
    """One sentence on what would move the dominant term down."""
    d = row["dominant"]
    if d == "collective":
        return ("reduce cross-device traffic: drop decode-path FSDP "
                "all-gathers / overlap collectives with compute"
                if row["kind"] == "decode" else
                "overlap FSDP all-gathers with layer compute; consider "
                "int8-compressed gradient reduction on the pod axis")
    if d == "memory":
        return ("quantize weights/KV (INT4 halves the stream) or split "
                "local-layer caches to window size"
                if row["kind"] == "decode" else
                "reduce remat traffic / fuse attention to avoid score "
                "materialization")
    return ("raise per-device utilization: larger microbatch or less "
            "remat recompute")


def render_markdown(cells: Dict) -> str:
    lines = [
        "| arch | shape | quant | t_comp ms | t_mem ms | t_coll ms | "
        "dominant | useful | roofline | HBM GiB | multi-pod |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    rows = []
    for (arch, shape, quant), entry in sorted(cells.items()):
        row = derive_row(arch, shape, quant, entry)
        if row:
            rows.append(row)
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['quant']} "
            f"| {r['t_compute_ms']:.2f} | {r['t_memory_ms']:.2f} "
            f"| {r['t_collective_ms']:.2f} | {r['dominant']} "
            f"| {r['useful_flops_ratio']:.3f} "
            f"| {r['roofline_fraction']:.3f} "
            f"| {r.get('peak_hbm_gib', float('nan')):.2f} "
            f"| {'yes' if r.get('multi_pod_ok') else '-'} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--dryrun-dir", default="results/dryrun_torch")
    ap.add_argument("--probe-dir", default="results/probe_torch")
    ap.add_argument("--json-out", default="results/roofline_table_torch.json")
    args = ap.parse_args(argv)
    cells = load_results(args.dryrun_dir, args.probe_dir)
    rows = []
    for (arch, shape, quant), entry in sorted(cells.items()):
        row = derive_row(arch, shape, quant, entry)
        if row:
            row["next_action"] = bottleneck_sentence(row)
            rows.append(row)
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    if args.md:
        print(render_markdown(cells))
    else:
        for r in rows:
            print(f"{r['arch']:24s} {r['shape']:12s} {r['quant']:5s} "
                  f"dom={r['dominant']:10s} rf={r['roofline_fraction']:.3f} "
                  f"hbm={r.get('peak_hbm_gib', -1):.1f}GiB")


if __name__ == "__main__":
    main()
