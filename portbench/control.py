"""The output check's readings on the chip, at a cell's own size: for
each seed, one run at the cell's load (the program's readings, as the
benchmark reads them), then the control's on the same served tokens:
the reference computed on TF32 inputs put in the program's place
(`correct.control_readings`).  The limit in the configuration file is
set between the program's largest reading and the control's smallest.

    python3 portbench/control.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...]

Prints one line a seed and a JSON summary last.  The benchmark's own
runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

import correct  # noqa: E402
import harness  # noqa: E402
import weights  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(harness.ROOT / "src"))
    cell = harness.cell_of(harness.manifest(), args.workload)
    conf = harness.load_config(cell["config"])
    z = weights.dims(conf)
    rows = []
    for seed in args.seeds:
        keep = {}
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               time.perf_counter(), keep=keep)
        served = keep["served"]
        row = {"seed": seed, "program": out["readings"],
               "control": correct.control_readings(conf, z, seed, "cuda",
                                                   served),
               "positions": int(sum(len(o) for _, o in served)),
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "correct": out["correct"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = rows[0]["program"]
    print(json.dumps({
        "workload": args.workload,
        "program_max": {k: max(r["program"][k] for r in rows) for k in names},
        "control_min": {k: min(r["control"][k] for r in rows) for k in names},
        "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
