"""The control at a size a CPU test run holds: the reference computed on
TF32 inputs, put in the program's place, reads far more than the
program does.  Teacher-forced sequences of random tokens go through the
port's serve step (one chunk a sequence, as in `check_reference`) and
through the control; each side's token at a position is its best logit,
read under the float32 reference (`correct.readings`).  The limits
themselves are set at each cell's own size on the card (PERF.md)."""
import numpy as np
import pytest
import torch

from _cpu import CELLS, harness
import correct
import weights
from check_reference import _port_logits


@pytest.mark.parametrize("cell", CELLS)
def check_control_reads_higher(cell):
    conf = harness.load_config(harness.cell_of(harness.manifest(), cell)[
        "config"], smoke=True)
    z = weights.dims(conf)
    seed = 11
    w = weights.draw(conf, seed, "cpu")
    rng = np.random.default_rng(seed)
    served = [(rng.integers(0, z["vocab"], 8), rng.integers(
        0, z["vocab"], 64)) for _ in range(16)]
    picks = []
    for p, o in served:
        seq = torch.as_tensor(np.concatenate([p, o[:-1]]))[None]
        picks.append(_port_logits(conf, z, w, seq)[len(p) - 1:].argmax(-1))
    prog = correct.readings(conf, z, seed, "cpu", served, picks)
    ctl = correct.control_readings(conf, z, seed, "cpu", served)
    for k in conf["correct"]:
        assert ctl[k] > 0 and ctl[k] >= 3 * prog[k], (k, prog, ctl)
