"""A run whose window runs on spawned ranks reports every card it used: each
rank's ``bench/ranks.py`` record, merged into the line's device report and
profile; a run that used fewer cards than its cell asks for fails.

The ``gpu`` tests need two CUDA cards (one where ranks share card 0 and
the cell asks for one) and skip without them (decided in the tests).  Run them on the card with

    PYTHONPATH=src python -m pytest -q -s -m gpu bench/tests/test_bench_ranks.py
"""

import importlib
import json
import pickle
import time
import types

import pytest
import torch
import torch.distributed as dist

from bench import harness, ranks
from repro_torch.launch.mesh import spawn

H100 = "NVIDIA H100 80GB HBM3"
MIB = 1 << 20


# --------------------------------------------------------- a mesh's cell --
def probe_rank(mesh, trace: bool, nbytes: int, plant):
    """One rank of the probe cell's window: ``nbytes`` × (rank + 1) of ones
    on its device, summed over the mesh; the last rank imports ``plant``."""
    probe = ranks.start(trace, mesh.device)
    x = torch.ones(nbytes // 8 * (mesh.rank + 1), dtype=torch.int64, device=mesh.device)
    total = x.sum().reshape(1)
    dist.all_reduce(total)
    if plant and mesh.rank == mesh.size - 1:
        importlib.import_module(plant)
    probe.stop()
    assert int(total) == nbytes // 8 * mesh.size * (mesh.size + 1) // 2
    del x
    return probe.report()


def _setup(ctx):
    return None


def _window(state, ctx):
    t = ctx.traffic
    t0 = time.perf_counter()
    records = spawn(probe_rank, (t["ranks"], 1), ("data", "model"), device=t["device"], backend=t["backend"],
                    timeout_s=120, args=(ctx.trace, t["mib"] * MIB, t.get("plant")))
    return dict(metrics=dict(probe_s=(time.perf_counter() - t0, "s")), attempted=t["ranks"], failed=0,
                devices=records)


def _check(state, result, ctx):
    return [("ranks_missing", ctx.traffic["ranks"] - len(result["devices"]), 0)]


PROBE = types.SimpleNamespace(setup=_setup, window=_window, check=_check)


def _four_cards(state, ctx):
    """Four ranks' records as four cards would give them, without a spawn."""
    records = [_record(f"GPU-{r}", (r + 1) * MIB, index=r,
                       profile=_profile(0.1 * (r + 1), 5.0 + r, [("k3", 0.1)], [("host python", 1.0 + r)]))
               for r in range(4)]
    return dict(metrics=dict(probe_s=(1.0, "s")), attempted=4, failed=0, devices=records)


FOUR_CARDS = types.SimpleNamespace(setup=_setup, window=_four_cards, check=lambda state, result, ctx: [])


@pytest.fixture
def probe_cell(bench_copy, monkeypatch):
    """``probe_cell(name, chips, **traffic)`` writes a cell whose driver is
    :data:`PROBE` into the benchmark's copy."""
    real = harness.load_driver
    ours = dict(rank_probe=PROBE, four_cards=FOUR_CARDS)
    monkeypatch.setattr(harness, "load_driver", lambda name: ours[name] if name in ours else real(name))

    def make(name, chips, driver="rank_probe", **traffic):
        (bench_copy / "traffic" / f"{name}.json").write_text(json.dumps(dict(driver=driver, **traffic)))
        (bench_copy / "workloads" / f"{name}.json").write_text(json.dumps(
            dict(config="quest-t10i4d100k", traffic=name, chips=chips, why="a window on spawned ranks")))
        return name

    return make


# -------------------------------------------------------------- records --
def _record(uuid, peak, *, kind=H100, index=0, forbidden=(), profile=None):
    r = dict(uuid=uuid, index=index, kind=kind, memory_peak_bytes=peak, forbidden=list(forbidden))
    if profile is not None:
        r["profile"] = profile
    return r


def _profile(busy, window, kernels, gaps):
    return dict(busy_s=busy, window_s=window, kernel_s=dict(kernels), device_ops=[[k, v] for k, v in kernels],
                idle_gaps=[list(g) for g in gaps])


@pytest.mark.parametrize("uuids, peaks, count, peak", [
    (["a", "b", "c", "d"], [1, 4, 2, 3], 4, 4),     # four cards: the fullest card's peak
    (["a", "a", "a", "a"], [1, 4, 2, 3], 1, 10),    # four ranks on one card: their memory side by side
    (["a", "a", "b", "b"], [1, 4, 2, 3], 2, 5),     # two cards of two ranks each
], ids=["four-cards", "one-card", "two-cards"])
def test_merge_counts_cards_by_uuid_and_takes_the_fullest_card(uuids, peaks, count, peak):
    merged = ranks.merge([_record(u, p, index=i) for i, (u, p) in enumerate(zip(uuids, peaks))], trace=False)
    assert (merged["kind"], merged["count"], merged["memory_peak_bytes"]) == (H100, count, peak)
    assert merged["forbidden"] == [] and "profile" not in merged
    assert [r["rank"] for r in merged["ranks"]] == [0, 1, 2, 3]


@pytest.mark.parametrize("records, trace, match", [
    ([_record("a", 1), _record("b", 1, kind="NVIDIA H100 PCIe")], False, "different kinds"),
    ([], False, "no ranks"),
    ([_record("a", 1, profile=_profile(0.1, 1.0, [], [])), _record("b", 1)], True, r"rank\(s\) \[1\]"),
], ids=["mixed-kinds", "no-ranks", "untraced-rank"])
def test_merge_refuses_what_cannot_be_one_line(records, trace, match):
    with pytest.raises(ValueError, match=match):
        ranks.merge(records, trace)


def test_a_forbidden_module_on_any_rank_is_the_runs():
    merged = ranks.merge([_record("a", 1), _record("b", 1, forbidden=["jax"]), _record("c", 1, forbidden=["repro"])],
                         trace=False)
    assert merged["forbidden"] == ["jax", "repro"]


def test_traces_merge_busy_by_card_kernels_summed_and_gaps_by_rank():
    records = [
        _record("a", 1, index=0, profile=_profile(0.2, 10.0, [("k3", 0.15), ("memcpy", 0.05)],
                                                  [("annotation x", 3.0), ("host python", 1.0)])),
        _record("a", 1, index=0, profile=_profile(0.1, 10.5, [("k3", 0.1)], [("host op y", 2.0)])),
        _record("b", 1, index=1, profile=_profile(0.6, 10.2, [("k3", 0.5), ("nccl", 0.1)], [("host python", 4.0)])),
    ]
    prof = ranks.merge(records, trace=True)["profile"]
    assert prof["busy_s"] == pytest.approx((0.2 + 0.1 + 0.6) / 2)   # card a's two ranks, then card b
    assert prof["window_s"] == 10.5
    assert prof["kernel_s"] == pytest.approx(dict(k3=0.75, memcpy=0.05, nccl=0.1))
    assert prof["device_ops"][0] == ["k3", pytest.approx(0.75)]
    assert prof["idle_gaps"] == [["rank 2: host python", 4.0], ["rank 0: annotation x", 3.0],
                                 ["rank 1: host op y", 2.0], ["rank 0: host python", 1.0]]
    assert [(d["rank"], d["uuid"], d["busy_s"]) for d in prof["per_device"]] == [(0, "a", 0.2), (1, "a", 0.1),
                                                                                 (2, "b", 0.6)]


# ----------------------------------------------------------------- main --
def _line(count, forbidden=()):
    detail = dict(setup_s=1.0, ranks=[dict(rank=r, uuid=f"u{r}", index=r, memory_peak_bytes=r) for r in range(count)],
                  forbidden=list(forbidden))
    return dict(correct=True, attempted=count, failed=0, metrics=dict(setup_s=dict(value=1.0, unit="s")),
                device=dict(platform="gpu", kind=H100, count=count, memory_peak_bytes=count - 1),
                checks={}, _detail=detail)


@pytest.mark.parametrize("chips, line, rc", [
    (4, _line(1), 4),          # a four-card cell whose run used one card
    (4, _line(4), 0),
    (1, _line(1), 0),
    (1, _line(1, ["jax"]), 3),  # a rank loaded jax
], ids=["short", "four", "one", "rank-jax"])
def test_main_fails_a_run_that_used_fewer_cards_than_its_cell(bench_copy, monkeypatch, capsys, chips, line, rc):
    from bench import peaks

    (bench_copy / "workloads" / "cell.json").write_text(json.dumps(
        dict(config="quest-t10i4d100k", traffic="jobs_memory", chips=chips, why="a stubbed run")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: json.loads(json.dumps(line)))
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])   # this test process's own imports
    monkeypatch.setattr(peaks, "power_limit", lambda cards: [f"card {c}" for c in cards])
    assert harness.main(["--workload", "cell", "--seed", "1", "--seconds", "1"], time.perf_counter()) == rc
    out = capsys.readouterr()
    if rc:
        assert out.out == "" and out.err.startswith("bench: ")
    else:
        printed = json.loads(out.out.strip().splitlines()[-1])
        assert printed["device"]["count"] == line["device"]["count"] and "_detail" not in printed
        detail = json.loads((bench_copy / "out" / "cell.1.0.json").read_text())["detail"]
        assert detail["card"] == [f"card {r}" for r in range(line["device"]["count"])]


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_line_counts_the_ranks_cards_not_the_harness_process(probe_cell, trace):
    cell = probe_cell("probe.four", 4, driver="four_cards")
    line = harness.run_cell(cell, 3, 1.0, trace, device="cpu", log=lambda m: None)
    dev = line["device"]
    assert (dev["kind"], dev["count"], dev["memory_peak_bytes"]) == (H100, 4, 4 * MIB)
    assert line["_detail"]["ranks"][3] == dict(rank=3, uuid="GPU-3", index=3, memory_peak_bytes=4 * MIB)
    if trace:
        assert (dev["busy_s"], dev["window_s"]) == (pytest.approx(0.25), 8.0)
        assert line["breakdown"]["idle_gaps"][0] == ["rank 3: host python", 4.0]
        assert line["breakdown"]["device_ops"] == [["k3", pytest.approx(0.4)]]
        assert line["metrics"]["device_idle_pct.mine"]["value"] == pytest.approx(100 * (1 - 0.25 / 8.0))


# ------------------------------------------------------ ranks on the CPU --
def test_gloo_ranks_on_the_cpu_report_records_that_pickle_whole():
    records = spawn(probe_rank, (2, 1), ("data", "model"), device="cpu", backend="gloo", timeout_s=90,
                    args=(True, MIB, "repro"))
    assert pickle.loads(pickle.dumps(records)) == records
    for r in records:
        assert list(r) == ["uuid", "index", "kind", "memory_peak_bytes", "forbidden", "profile"]
        assert (r["uuid"], r["index"], r["kind"], r["memory_peak_bytes"]) == ("cpu", None, "cpu", 0)
        assert r["profile"]["window_s"] > 0 and set(r["profile"]) >= {"busy_s", "kernel_s", "device_ops", "idle_gaps"}
    assert [r["forbidden"] for r in records] == [[], ["repro"]]   # the JAX package, imported by rank 1 alone
    merged = ranks.merge(records, trace=True)
    assert (merged["count"], merged["forbidden"]) == (1, ["repro"])


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_cell_whose_window_runs_on_ranks_reports_their_merged_line(probe_cell, monkeypatch, trace):
    cell = probe_cell("probe.cpu", 1, backend="gloo", device="cpu", ranks=2, mib=1)
    line = harness.run_cell(cell, 7, 1.0, trace, device="cpu", log=lambda m: None)
    assert line["correct"] and line["attempted"] == 2
    assert list(line["device"])[:4] == ["platform", "kind", "count", "memory_peak_bytes"]
    assert (line["device"]["count"], line["device"]["kind"]) == (1, "cpu")
    detail = line["_detail"]
    assert [r["rank"] for r in detail["ranks"]] == [0, 1] and detail["forbidden"] == []
    if trace:
        assert line["device"]["window_s"] > 0 and line["device"]["busy_s"] == 0.0   # no card: host only
        assert all(name.startswith("rank ") for name, _ in line["breakdown"]["idle_gaps"])
    else:
        assert set(line["metrics"]) == {"probe_s", "setup_s"}


# ----------------------------------------------------- ranks on the card --
@pytest.fixture
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 1:
        pytest.skip("needs a CUDA card")
    return n


def _main_line(capsys, cell, seed, trace):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "1", "--trace", str(trace)],
                      time.perf_counter())
    out = capsys.readouterr()
    with capsys.disabled():   # the lines a run prints, to be read beside the test's verdict
        print(f"\n{cell} trace={trace} rc={rc}\n{out.out.strip() or out.err.strip()}")
    return rc, (json.loads(out.out.strip().splitlines()[-1]) if rc == 0 else None)


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1], ids=["untraced", "traced"])
def test_nccl_ranks_each_on_a_card_count_every_card(cards, probe_cell, capsys, trace):
    if cards < 2:
        pytest.skip("needs two CUDA cards")
    world = min(cards, 4)
    cell = probe_cell(f"probe.nccl{world}", world, backend="nccl", device="cuda", ranks=world, mib=64)
    rc, line = _main_line(capsys, cell, 11 + trace, trace)
    assert rc == 0 and line["correct"]
    dev = line["device"]
    detail = json.loads((harness.BENCH / "out" / f"{cell}.{11 + trace}.{trace}.json").read_text())["detail"]
    assert dev["count"] == world and len({r["uuid"] for r in detail["ranks"]}) == world
    assert dev["memory_peak_bytes"] == max(r["memory_peak_bytes"] for r in detail["ranks"])
    assert world * 64 * MIB <= dev["memory_peak_bytes"] < world * 64 * MIB + 2 * MIB   # the last rank's tensor
    assert len(detail["card"]) == world
    if trace:
        assert 0 < dev["busy_s"] < dev["window_s"]


@pytest.mark.gpu
def test_gloo_ranks_sharing_one_card_count_one(cards, probe_cell, capsys):
    cell = probe_cell("probe.gloo_shared", 1, backend="gloo", device="cuda:0", ranks=4, mib=64)
    rc, line = _main_line(capsys, cell, 21, 0)
    assert rc == 0 and line["device"]["count"] == 1
    assert line["device"]["memory_peak_bytes"] >= (1 + 2 + 3 + 4) * 64 * MIB   # four ranks' memory on card 0


@pytest.mark.gpu
def test_ranks_sharing_one_card_fail_a_cell_of_more_cards(cards, probe_cell, capsys):
    if cards < 2:
        pytest.skip("needs two CUDA cards: with fewer the machine check refuses the cell first")
    chips = min(cards, 4)
    cell = probe_cell(f"probe.gloo_shared{chips}", chips, backend="gloo", device="cuda:0", ranks=4, mib=64)
    rc, _ = _main_line(capsys, cell, 22, 0)
    assert rc == 4
