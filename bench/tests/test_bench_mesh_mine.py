"""The four-card mesh mine's cell (``quest-t10i4d10m.mesh_mine``): its
reference over blocks, its control, its dry path on gloo ranks at a tiny
size, its readers, its prompt refusal of a program that cannot mine a DB held
in splits, and (marked ``gpu``, with four cards) the cell over NCCL at
400,000 rows.  Run the last on the card with

    PYTHONPATH=src python -m pytest -q -s -m gpu bench/tests/test_bench_mesh_mine.py
"""

import time

import numpy as np
import pytest
import torch

from bench import common, harness, ranks
from bench.drivers import mesh_jobs
from bench.reference import blocks as ref_blocks
from bench.reference import mine as ref_mine
from bench.tests import tiny

CELL = "quest-t10i4d10m.mesh_mine"
READERS = ["count_reduce_share.mesh_mine", "db_place_share.mesh_mine", "k3_roofline.mesh_mine",
           "device_idle_pct.mesh_mine"]
# four blocks of 250 rows, one a rank of a (4, 1) gloo mesh on the CPU
OVERRIDES = {"config": {"data": dict(tiny.DATA, block_rows=250), "mining": {"min_support": 0.05}},
             "traffic": {"backend": "gloo", "timeout_s": 120, "setup_timeout_s": 90}}


def _config():
    return harness._merge(harness.load_cell(CELL)["config"], OVERRIDES["config"])


@pytest.mark.parametrize("sizes", [[250, 250, 250, 250], [400, 0, 100, 500]], ids=["even", "uneven-empty"])
def test_blocks_reference_equals_the_whole_dbs(sizes):
    config = _config()
    dense = common.dataset(config)
    cuts = np.cumsum([0] + sizes)
    blocks = [dense[a:b] for a, b in zip(cuts, cuts[1:])]
    want = ref_mine.frequent_itemsets(dense, 0.05, 4)
    assert ref_blocks.frequent_itemsets(blocks, 0.05, 4) == want and max(len(s) for s in want) == 4


def test_block_zero_is_the_100k_data_sets_rows():
    """At 250 rows a block, block 0 is the first rows of the 100K data set's
    generator settings at 250 rows."""
    data = harness._merge(harness.load_cell(CELL)["config"], {"data": {"block_rows": 250}})["data"]
    base = harness._merge(harness.load_cell("quest-t10i4d100k.mine")["config"], {"data": {"num_transactions": 250}})
    assert np.array_equal(mesh_jobs.block(data, 0), common.dataset(base))


def test_the_control_fails_the_cells_limits():
    limits = harness.load_cell(CELL)["cell"]["limits"]
    numbers = mesh_jobs.control_numbers(_config(), "cpu")
    assert any(v > limits[k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_dry_path_on_four_gloo_ranks(trace):
    line = harness.run_cell(CELL, 2**40 + 9, 0.5, trace, device="cpu", overrides=OVERRIDES, log=lambda m: None)
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0, line["checks"]
    detail = line["_detail"]
    assert [r["rank"] for r in detail["ranks"]] == [0, 1, 2, 3] and detail["forbidden"] == []
    assert detail["split_rows"] == [250] * 4 and detail["reference_s"] > 0
    if trace:
        # the program's spans read on the CPU; the device's need a card
        assert {"count_reduce_share.mesh_mine", "db_place_share.mesh_mine"} <= set(line["metrics"])
        assert all(line["metrics"][n]["value"] > 0 for n in READERS[:2])
    else:
        assert set(line["metrics"]) == {"setup_s", "rulebook_s"}


def test_the_device_readers_read_every_cards_trace():
    """The roofline and the idle share of four cards' merged traces: one
    bound over all the cards' K3 seconds, each card's busy time averaged."""
    from bench.peaks import PARTS

    prof = dict(busy_s=2.0, window_s=10.0, kernel_s={"support_count_kernel": 4.0}, device_ops=[], idle_gaps=[])
    records = [dict(uuid=f"GPU-{r}", index=r, kind="H100", memory_peak_bytes=1, forbidden=[], profile=prof)
               for r in range(4)]
    config = harness.load_cell(CELL)["config"]
    run = dict(jobs=[dict(wall_s=1.0, phases={})] * 3, config=config, traffic={}, peaks=PARTS["sxm"],
               reference=dict(candidates={1: 1000, 2: 69378, 3: 22138, 4: 18078}),
               profile=ranks.merge(records, trace=True)["profile"])
    idle = harness.load_reader("device_idle_pct.mesh_mine").read(run)
    assert idle == pytest.approx(80.0)
    roof = harness.load_reader("k3_roofline.mesh_mine").read(run)
    from bench.readers import k3_bound_s

    assert roof == pytest.approx(100 * k3_bound_s(run) / (4 * 4.0)) and 0 < roof < 100


def test_a_program_without_the_split_input_fails_at_once(monkeypatch):
    """Where ``apriori.mine`` takes no ``split``, set-up raises before a
    rank is spawned."""
    from repro_torch.core import apriori

    def mine(transactions_dense, cfg=None, *, device="cuda", mesh=None, checkpoint_cb=None, resume_state=None,
             obs=None):
        raise AssertionError("never called")

    monkeypatch.setattr(apriori, "mine", mine)
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="takes no split"):
        harness.run_cell(CELL, 1, 0.5, False, device="cpu", overrides=OVERRIDES, log=lambda m: None)
    assert time.perf_counter() - t < 5.0


# ------------------------------------------------------------ on the cards --
@pytest.mark.gpu
def test_the_cell_over_nccl_on_four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    over = {"config": {"data": {"num_transactions": 400000}}}
    line = harness.run_cell(CELL, 2**33 + 17, 3.0, True, device="cuda", overrides=over)
    print(line)
    assert line["correct"] and line["attempted"] >= 1, line["checks"]
    assert line["device"]["count"] == 4 and line["device"]["kind"].startswith("NVIDIA H100")
    assert line["_detail"]["split_rows"] == [100000] * 4 and line["_detail"]["forbidden"] == []
    for name in READERS:
        assert line["metrics"][name]["value"] > 0, name
    assert 0 < line["metrics"]["k3_roofline.mesh_mine"]["value"] < 105
