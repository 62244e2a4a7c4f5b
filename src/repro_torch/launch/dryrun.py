"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step once
on the meta device and report what the JAX package's dry-run reports.

For each cell (`launch/specs.py::build_cell`) the step runs on meta
tensors under `launch/metarun.MetaCounter` and the record keeps JAX's
keys where the port has a counterpart:

  memory_per_device   argument_bytes: each argument leaf's block under
                      the cell's rules (shape arithmetic, exact), leaves
                      the step never reads left out as jax.jit's
                      keep_unused=False leaves them; output_bytes and
                      alias_bytes: the step's results, those in an
                      argument's storage (a donated cache or state,
                      written in place) at that argument's block;
                      temp_bytes: the peak of live meta storages past
                      the arguments, less the new results; peak_bytes =
                      argument + output + temp - alias, as JAX sums it.
                      A count that is not an argument's is the whole
                      cell's divided evenly over the mesh; where XLA's
                      partitioner replicates work the two differ
  flops               the products and attention of the meta run
                      (torch.utils.flop_counter's formulas), divided
                      evenly over the devices; XLA also counts
                      elementwise work
  hlo_bytes           the bytes every op of the meta run reads and
                      writes, divided evenly over the devices (the key
                      keeps JAX's name so `roofline/report.py` reads
                      both packages' records); the plain route's,
                      unfused, so no bound
  min_bytes           the bytes the step must move, the roofline's
                      memory term: of each argument leaf's block, the
                      fraction its ops read plus the fraction they
                      wrote in place (each at most 1; a gather reads the
                      rows it returns, a scatter writes the rows it is
                      given), and the new results written once
  collective_*        the port's own tensor-parallel collectives
                      (`dist/shard.tp_all_reduce` / `tp_all_gather`),
                      counted in a meta run at tp = 2 on a
                      `CountingGroup` (their count a call and result
                      bytes do not depend on tp; train and prefill run
                      it at <= TP_SEQ tokens a row and scale the bytes,
                      which grow with the tokens), per device over the
                      batch axes; plus, for every leaf the rules shard
                      over `data` (FSDP), an all-gather a forward and in
                      train one more in the backward and a
                      reduce-scatter of its gradient, and in train an
                      all-reduce of every gradient over the batch axes
                      its leaf is not sharded on.  The KV-sequence split
                      of `long_500k` (`kv_seq` over the mesh) has no
                      runtime counterpart in the port: not modelled
  t_trace_s           the cell's seconds (JAX: t_lower_s, t_compile_s);
                      code_bytes and hlo_bytes_len have no counterpart

The meta run of a cell depends on its arch, shape, precision and config,
not on its mesh: it is made once a process and shared by the meshes.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape \\
      decode_32k --multi-pod --quant int4 --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --all        # every cell, both meshes
  python -m repro_torch.launch.dryrun --arch xlstm-1.3b --shape \\
      prefill_32k --probe                          # two-point probe

Records go to results/dryrun_torch/ (results/probe_torch/ for probes)
and never replace a file that exists.
"""
import argparse
import json
import os
import sys
import time
import traceback

TP = 2              # the counting group's ranks
TP_SEQ = 256        # cache rows a lane of the tp run of a decode cell
PAGE = 16           # its page size

_RUNS: dict = {}    # (arch, shape, quant, cfg, shapes) -> meta run
_MEMO: dict = {}    # MetaCounter's op memo, shared by every run


def _shapes_key(shapes):
    return None if shapes is None else tuple(sorted(shapes.items()))


def _leaf_index(args, pspecs, mesh_shape):
    """storage id -> (argument index, one device's bytes of its tensor),
    for every tensor of the arguments (a QTensor's data and scales
    each)."""
    from repro_torch.launch.specs import leaf_device_bytes, \
        leaves_with_pspecs
    from repro_torch.launch.metarun import tensors_of
    out = {}
    for i, (a, p) in enumerate(zip(args, pspecs)):
        for leaf, ps in leaves_with_pspecs(a, p):
            for t in tensors_of(leaf):
                out[t.untyped_storage()._cdata] = (
                    i, leaf_device_bytes(t, ps, mesh_shape))
    return out


def _meta_run(cell):
    """Run the cell's step on meta: whole-cell FLOPs, bytes, peak, the
    result storages and the argument storages read."""
    from repro_torch.launch.metarun import MetaCounter, tensors_of
    mc = MetaCounter(_MEMO)
    mc.hold(cell.args)
    t0 = time.perf_counter()
    with mc:
        out = cell.fn(*cell.args)
    seconds = time.perf_counter() - t0
    outs = {}
    for t in tensors_of(out):
        st = t.untyped_storage()
        outs[st._cdata] = st.nbytes()
    return {"flops": mc.flops, "bytes": mc.bytes, "peak": mc.peak_bytes,
            "ops": mc.ops, "outs": outs,
            "moved": mc.moved(),
            "seconds": seconds}


def _tp_decode_step(cell, tp, max_seq):
    """A thunk running the port's tensor-parallel decode step, the
    engine's `serve_step` of one token a lane, at rank 0's shapes of a
    tp-way group (`dist.shard`: SERVE_RULES and the recurrent split
    table): the cell's packed or float params sharded as the engine
    shards them, bf16 page pools (pages of 16) and the arena."""
    import torch

    from repro_torch.dist.shard import (recurrent_splits,
                                        shard_state_specs, shard_tree)
    from repro_torch.launch.specs import meta_tensor, meta_tree
    model = cell.model
    params = shard_tree(cell.args[0], model.param_specs(), 0, tp,
                        splits=recurrent_splits(model.cfg, tp))
    inp = cell.args[2]
    b = next(iter(inp.values())).shape[0]
    pages = -(-max_seq // PAGE)
    state = shard_state_specs(model.decode_state_specs(
        b, b * pages, PAGE, torch.bfloat16), model.cfg, tp)
    cache = {**meta_tree(state["paged"]), **meta_tree(state["arena"])}
    tables = meta_tensor((b, pages), torch.int32)
    lengths, n_new = meta_tensor((b,), torch.int32), meta_tensor((b,), torch.int32)

    def step():
        with torch.no_grad():
            model.serve_step(params, cache, inp, tables, lengths, n_new)
    return step


def _tp_run(arch, shape_id, quant, cfg, shapes, tp=TP):
    """The port's tensor-parallel collectives of a decode cell, counted
    on a CountingGroup of `tp` ranks: {kind: (count, whole-batch
    bytes)}, or why a cell has none.  The port's tensor parallelism is its
    serve path (`serve_step`): `forward`, `loss` and `decode_step` run
    at tp = 1, so train and prefill cells, and the contiguous cache,
    have none of their own."""
    from repro_torch.configs.registry import SHAPES
    from repro_torch.dist.shard import CountingGroup, use_tp
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.metarun import MetaCounter
    from repro_torch.launch.specs import build_cell
    table = dict(shapes or SHAPES)
    seq, batch, kind = table[shape_id]
    if kind != "decode":
        return ("the port's forward and loss have no tensor-parallel "
                "path (its tensor parallelism is the serve path's)")
    table[shape_id] = (min(seq, TP_SEQ), batch, kind)
    cell = build_cell(arch, shape_id, make_host_mesh(), quant=quant,
                      cfg=cfg, shapes=table)
    group = CountingGroup(tp)
    step = _tp_decode_step(cell, tp, table[shape_id][0])
    with use_tp(group), MetaCounter(_MEMO):
        step()
    return {k: (group.counts[k], group.bytes[k]) for k in group.counts}


def meta_runs(arch, shape_id, quant, cfg=None, shapes=None,
              serve_sharding=False):
    """The cell's meta run and tp run, made once a process."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import build_cell
    cfg = cfg if cfg is not None else get_config(arch)
    key = (arch, shape_id, quant, cfg, _shapes_key(shapes))
    if key not in _RUNS:
        t0 = time.perf_counter()
        cell = build_cell(arch, shape_id, make_host_mesh(), quant=quant,
                          cfg=cfg, shapes=shapes,
                          serve_sharding=serve_sharding)
        run = _meta_run(cell)
        run["arg_storages"] = _leaf_index(cell.args, cell.pspecs,
                                          make_host_mesh())
        run["tp"] = _tp_run(arch, shape_id, quant, cfg, shapes)
        run["seconds_total"] = time.perf_counter() - t0
        _RUNS[key] = run
    return _RUNS[key]


def step_collectives(cell, run):
    """CollectiveStats of one device of the cell's mesh (module
    docstring), and what is not modelled."""
    from repro_torch.dist.axes import axis_size
    from repro_torch.launch.specs import leaf_device_bytes, \
        leaves_with_pspecs
    from repro_torch.roofline.analysis import CollectiveStats
    stats = CollectiveStats()
    missing = []
    mesh, rules = cell.mesh_shape, cell.rules
    batch_entry = rules.get("batch")
    inp = cell.args[2] if cell.kind in ("train", "decode") else cell.args[1]
    first = next(iter(inp.values()))
    b_axes = axis_size(mesh, batch_entry)
    if batch_entry is None or first.shape[0] % b_axes:
        b_axes = 1
    if isinstance(run["tp"], str):
        missing.append("tensor-parallel collectives: " + run["tp"])
    else:
        for kind, (count, nbytes) in run["tp"].items():
            stats.add(kind, nbytes / b_axes, count)
    # FSDP and data-parallel gradients, from the sharded param specs
    names = (batch_entry,) if isinstance(batch_entry, str) else \
        tuple(batch_entry or ())
    for leaf, ps in leaves_with_pspecs(cell.args[0], cell.pspecs[0]):
        own = set()
        for e in ps:
            own.update((e,) if isinstance(e, str) else (e or ()))
        shard = leaf_device_bytes(leaf, ps, mesh)
        if "data" in own:
            full = shard * mesh["data"]
            stats.add("all-gather", full)
            if cell.kind == "train":
                stats.add("all-gather", full)
                stats.add("reduce-scatter", shard)
        if cell.kind == "train" and any(a not in own for a in names):
            stats.add("all-reduce", shard)
    if cell.shape_id == "long_500k":
        missing.append("the KV-sequence split (kv_seq over the mesh) has "
                       "no runtime counterpart in the port")
    return stats, missing


def cell_record(arch, shape_id, mesh_shape, mesh_name, quant, cfg=None,
                shapes=None, serve_sharding=False):
    """(record dict, Roofline) of one cell on `mesh_shape`."""
    from repro_torch.launch.specs import build_cell, n_devices
    from repro_torch.roofline.analysis import (Roofline, mesh_collective_bw,
                                               model_flops_for)
    t0 = time.perf_counter()
    run = meta_runs(arch, shape_id, quant, cfg, shapes, serve_sharding)
    cell = build_cell(arch, shape_id, mesh_shape, quant=quant, cfg=cfg,
                      shapes=shapes, serve_sharding=serve_sharding)
    n_dev = n_devices(mesh_shape)
    # the same leaves in the same order as the meta run's cell
    ids = list(run["arg_storages"].items())
    mine = list(_leaf_index(cell.args, cell.pspecs, mesh_shape).values())
    per_dev = {k: mine[j] for j, (k, _) in enumerate(ids)}
    moved = run["moved"]
    arg_bytes = sum(b for k, (i, b) in per_dev.items() if k in moved)
    unused = sum(b for k, (i, b) in per_dev.items() if k not in moved)
    alias = sum(per_dev[k][1] for k in run["outs"]
                if k in per_dev and per_dev[k][0] in cell.donate)
    aliased_whole = sum(n for k, n in run["outs"].items() if k in per_dev)
    new_whole = sum(run["outs"].values()) - aliased_whole
    out_bytes = alias + new_whole / n_dev
    temp = max(0.0, run["peak"] - new_whole) / n_dev
    min_bytes = sum(b * moved[k] for k, (i, b) in per_dev.items()
                    if k in moved) + new_whole / n_dev
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "temp_bytes": temp, "alias_bytes": alias,
           "peak_bytes": arg_bytes + out_bytes + temp - alias,
           "unused_argument_bytes": unused}
    coll, missing = step_collectives(cell, run)
    rf = Roofline(
        arch=arch, shape_id=shape_id, kind=cell.kind, mesh=mesh_name,
        quant=quant, flops=run["flops"] / n_dev,
        hlo_bytes=run["bytes"] / n_dev, min_bytes=min_bytes,
        collective_bytes=coll.total_bytes,
        model_flops=model_flops_for(arch, shape_id, n_dev, cfg=cfg,
                                    shapes=shapes),
        collective_detail=dict(coll.bytes_by_kind),
        memory_per_device=mem, collective_bw=mesh_collective_bw(mesh_shape))
    rec = rf.to_dict()
    rec.update({"t_trace_s": run["seconds_total"]
                + (time.perf_counter() - t0),
                "t_meta_run_s": run["seconds"], "ops": run["ops"],
                "n_devices": n_dev, "mesh_shape": dict(mesh_shape),
                "status": "ok",
                "collective_counts": dict(coll.count_by_kind),
                "not_modelled": missing})
    return rec, rf


def _write(rec, out_dir, fn, verbose):
    path = os.path.join(out_dir, fn)
    if os.path.exists(path):
        if verbose:
            print(f"  {path} exists: not replaced")
        return None
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def run_cell(arch: str, shape_id: str, multi_pod: bool, quant: str,
             out_dir: str = "results/dryrun_torch", verbose: bool = True,
             serve_sharding: bool = False, tag: str = "", cfg=None,
             shapes=None, mesh_shape=None) -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    mesh_name = "multi" if multi_pod else "single"
    if mesh_shape is None:
        mesh_shape = make_production_mesh(multi_pod=multi_pod)
    else:
        mesh_name = "x".join(str(n) for n in mesh_shape.values())
    rec, rf = cell_record(arch, shape_id, mesh_shape, mesh_name, quant, cfg,
                          shapes, serve_sharding)
    if out_dir:
        _write(rec, out_dir,
               f"{arch}__{shape_id}__{mesh_name}__{quant}{tag}.json",
               verbose)
    if verbose:
        mem = rec["memory_per_device"]
        print(f"[OK] {arch} {shape_id} {mesh_name} {quant}: "
              f"compute {rf.t_compute*1e3:.2f}ms  mem {rf.t_memory*1e3:.2f}ms"
              f"  coll {rf.t_collective*1e3:.2f}ms  dom={rf.dominant}  "
              f"useful={rf.useful_flops_ratio:.2f}  "
              f"peakHBM={mem['peak_bytes']/2**30:.2f}GiB  "
              f"(meta run {rec['t_meta_run_s']:.1f}s, {rec['ops']} ops)")
        print("  memory_per_device:", mem)
        print("  flops=%.3e min_bytes=%.3e bytes_by_op=%.3e"
              % (rf.flops, rf.min_bytes, rf.hlo_bytes))
        print("  collectives:", {k: f"{v/2**20:.1f}MiB"
                                 for k, v in rf.collective_detail.items()},
              rec["collective_counts"])
        for m in rec["not_modelled"]:
            print("  not modelled:", m)
    return rec


def run_probe(arch: str, shape_id: str, quant: str,
              out_dir: str = "results/probe_torch", verbose: bool = True,
              serve_sharding: bool = False, tag: str = "",
              cfg_override=None) -> dict:
    """Full-depth roofline terms by two-point layer extrapolation
    (launch/probe.py), single-pod mesh."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.probe import (extrapolate, probe_variants,
                                          time_scan_corrections)
    from repro_torch.launch.specs import n_devices
    from repro_torch.roofline.analysis import (Roofline, mesh_collective_bw,
                                               model_flops_for)
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=False)
    cfg_full = cfg_override if cfg_override is not None else get_config(arch)
    (cfg1, u1), (cfg2, u2), u_full = probe_variants(cfg_full)

    def measure(cfg_v):
        rec, _ = cell_record(arch, shape_id, mesh, "single", quant, cfg_v,
                             serve_sharding=serve_sharding)
        return {"flops": rec["flops"], "hlo_bytes": rec["hlo_bytes"],
                "min_bytes": rec["min_bytes"],
                "collective_bytes": rec["collective_bytes"],
                "_detail": rec["collective_detail"]}, rec["kind"]

    m1, kind = measure(cfg1)
    m2, _ = measure(cfg2)
    tot = extrapolate(m1, m2, u1, u2, u_full)
    detail = {k: (m1["_detail"].get(k, 0.0)
                  + (m2["_detail"].get(k, 0.0) - m1["_detail"].get(k, 0.0))
                  / (u2 - u1) * (u_full - u1))
              for k in set(m1["_detail"]) | set(m2["_detail"])}
    n_dev = n_devices(mesh)
    corr = time_scan_corrections(cfg_full, shape_id, n_dev)
    rf = Roofline(arch=arch, shape_id=shape_id, kind=kind, mesh="single",
                  quant=quant, flops=tot["flops"],
                  hlo_bytes=tot["hlo_bytes"], min_bytes=tot["min_bytes"],
                  collective_bytes=tot["collective_bytes"],
                  model_flops=model_flops_for(arch, shape_id, n_dev,
                                              cfg=cfg_full),
                  collective_detail=detail,
                  collective_bw=mesh_collective_bw(mesh))
    rec = rf.to_dict()
    rec.update({"status": "ok", "probe": True, "units": [u1, u2, u_full],
                "time_scan_correction": corr,
                "time_scan_correction_applied": False,
                "t_total_s": time.time() - t0})
    if out_dir:
        _write(rec, out_dir, f"{arch}__{shape_id}__probe__{quant}{tag}.json",
               verbose)
    if verbose:
        print(f"[PROBE] {arch} {shape_id} {quant}: "
              f"compute {rf.t_compute*1e3:.2f}ms mem {rf.t_memory*1e3:.2f}ms "
              f"coll {rf.t_collective*1e3:.2f}ms dom={rf.dominant} "
              f"useful={rf.useful_flops_ratio:.3f} "
              f"rf={rf.roofline_fraction:.3f} ({time.time()-t0:.0f}s)")
    return rec


def all_cells():
    """Every (arch, shape, multi_pod, quant) of `--all`, as JAX's."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs.registry import SHAPES, shapes_for
    for arch in ARCH_IDS:
        for shape_id in shapes_for(arch):
            for multi in (False, True):
                quants = ("bf16",) if SHAPES[shape_id][2] != "decode" \
                    else ("bf16", "int4")
                for q in quants:
                    yield arch, shape_id, multi, q


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--quant", default="bf16",
                    choices=["bf16", "int8", "int4"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="roofline probe (2-point layer extrapolation)")
    ap.add_argument("--serve-sharding", action="store_true",
                    help="no-FSDP decode rules")
    ap.add_argument("--tag", default="", help="suffix for result filename")
    args = ap.parse_args(argv)

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        if args.probe:
            run_probe(args.arch, args.shape, args.quant,
                      args.out.replace("dryrun", "probe"),
                      serve_sharding=args.serve_sharding, tag=args.tag)
        else:
            run_cell(args.arch, args.shape, args.multi_pod, args.quant,
                     args.out, serve_sharding=args.serve_sharding,
                     tag=args.tag)
        return

    failures = []
    for arch, shape_id, multi, q in all_cells():
        try:
            run_cell(arch, shape_id, multi, q, args.out)
        except Exception as e:  # noqa: BLE001 - listed, then exit 1
            traceback.print_exc()
            failures.append((arch, shape_id, multi, q, str(e)))
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)


if __name__ == "__main__":
    main()
