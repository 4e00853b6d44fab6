"""The per-layer metrics that read the program's own spans: a traced dry
run of each cell gives every one of them that the cell lists a number, and
an untraced run gives none of them, only the cell's end-to-end metrics."""

import json

import pytest

from bench import harness
from bench.tests import tiny

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
PROGRAM_SPANS = ("candgen_obs_share.mine", "match_gpu_ms.saturate", "host_cycle_ms.saturate")
CELLS = ["quest-t10i4d100k.mine", "quest-t10i4d100k.mine_stream", "quest-t40i10d100k.serve_saturate"]


def _run(cell, trace):
    over = harness._merge(tiny.OVERRIDES, tiny.T40) if cell.startswith("quest-t40") else tiny.OVERRIDES
    return harness.run_cell(cell, 2**35 + 11, 0.4, trace, device="cpu", overrides=over, log=lambda m: None)


def _listed(cell, names):
    return {m["name"] for m in SPEC["per_layer"] if m["name"] in names and cell in m["workloads"]}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_runs_read_the_programs_spans_and_untraced_runs_do_not(cell):
    traced = _run(cell, True)
    assert traced["correct"], traced["checks"]
    want = _listed(cell, PROGRAM_SPANS)
    assert bool(want) != cell.endswith(".mine")   # the in-memory route hands the miner no observer
    for name in want:
        assert traced["metrics"][name]["value"] > 0.0, name
    if "candgen_obs_share.mine" in want:
        assert traced["metrics"]["candgen_obs_share.mine"]["value"] <= 100.0
    plain = _run(cell, False)
    assert plain["correct"], plain["checks"]
    e2e = {m["name"] for m in SPEC["end_to_end"] if "workloads" not in m or cell in m["workloads"]}
    assert set(plain["metrics"]) == e2e and not set(plain["metrics"]) & set(PROGRAM_SPANS)
