"""The plain references against the port at smoke sizes: one lane's
whole sequence through the port's serve step as one chunk (INT4 weights,
the INT8 paged pools for attention, the recurrent state from zero), its
logits at every position against the reference's.  Tolerance: float32
sums in another order, and the INT8 K/V rounding of a value that f32
noise moves across a rounding boundary (one step of 1/127 of a row's
largest value)."""
import math

import numpy as np
import pytest
import torch

from _cpu import CELLS, harness
import weights
from reference.common import mm

TOL = 2e-4


def _port_logits(conf, z, w, tokens):
    from repro_torch.models import DecoderLM
    from repro_torch.models.common import map_specs
    model = DecoderLM(harness.program_config(conf, z, True))
    s, ps = tokens.shape[1], conf["serve"]["page_size"]
    pages = math.ceil(s / ps)
    specs = model.decode_state_specs(1, pages, ps, torch.int8)
    state = map_specs(lambda sp: torch.zeros(sp.shape, dtype=sp.dtype),
                      {**specs["paged"], **specs["arena"]})
    with torch.no_grad():
        logits, _ = model.serve_step(
            harness.program_params(w), state, {"tokens": tokens},
            torch.arange(pages, dtype=torch.int32)[None],
            torch.zeros(1, dtype=torch.int32),
            torch.tensor([s], dtype=torch.int32))
    return logits[0]


@pytest.mark.parametrize("cell", CELLS)
def check_reference_matches_port(cell):
    import importlib
    conf = harness.load_config(harness.cell_of(harness.manifest(), cell)[
        "config"], smoke=True)
    z = weights.dims(conf)
    w = weights.draw(conf, 7, "cpu")
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        0, z["vocab"], (1, 40)))
    ref = importlib.import_module(f"reference.{z['family']}")
    with torch.no_grad():
        want = mm(ref.hidden(z, w, tokens)[0], ref.head_weight(z, w), False)
    got = _port_logits(conf, z, w, tokens)
    err = float((got - want).abs().max())
    assert err < TOL, err
    # and the references are not trivially equal to anything: the control
    # (TF32 inputs) moves the logits
    with torch.no_grad():
        ctl = mm(ref.hidden(z, w, tokens, True)[0], ref.head_weight(z, w),
                 True)
    assert float((ctl - want).abs().max()) > 10 * err
