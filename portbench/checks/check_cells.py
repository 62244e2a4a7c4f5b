"""Each cell end to end at its configuration's smoke sizes on the CPU:
the result line's keys, and its metrics against BENCHMARK.json."""
import json

import pytest

from _cpu import CELLS, harness, smoke_run

MAN = harness.manifest()
DEVICE_ONLY = {"glue_ms_per_call", "mfu", "device_idle_share"}


def _wanted(section, cell):
    return {m["name"] for m in MAN[section]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def check_cell_runs(cell, trace):
    out = smoke_run(cell, trace=trace)
    json.dumps(out)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "readings", "checks"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    got = set(out["metrics"])
    if not trace:
        assert got == _wanted("end_to_end", cell)
        assert all(v["value"] > 0 for v in out["metrics"].values())
    else:
        # the device's metrics need the card; the host's are all there
        want = _wanted("per_layer", cell)
        assert got <= want
        assert want - got <= DEVICE_ONLY | {
            n for n in want if n.endswith("_roofline")}
    for m in out["metrics"].values():
        assert m["unit"]
    assert not harness.forbidden_loaded()


def check_manifest_files():
    for conf in MAN["configs"]:
        assert (harness.ROOT / conf["file"]).is_file()
        assert json.loads((harness.ROOT / conf["file"]).read_text())[
            "reduced"] == conf["reduced"]
    for cell in MAN["workloads"]:
        assert (harness.HERE / "traffic" / f"{cell['traffic']}.json").is_file()
    for m in MAN["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
