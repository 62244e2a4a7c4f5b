"""Shared set-up of the CPU rehearsal checks: the benchmark and the port
on the path, and a smoke run of a cell on the CPU."""
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

import harness  # noqa: E402

CELLS = [c["name"] for c in harness.manifest()["workloads"]]


def smoke_run(cell: str, seed: int = 2 ** 31 + 3, seconds: float = 1.5,
              trace: bool = False, fault=None, keep=None) -> dict:
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                            device="cpu", smoke=True, fault=fault,
                            keep=keep)
