"""The harness is driven by data and clean: every entry of BENCHMARK.json is
found by its name, a missing piece is named, a cell added as files alone
runs, and nothing the benchmark loads is JAX or the JAX package."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness
from bench.tests import tiny

ROOT = Path(harness.ROOT)
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_entry_of_benchmark_json_is_found_by_name():
    for w in SPEC["workloads"]:
        piece = harness.load_cell(w["name"])
        assert {k: piece["cell"][k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert hasattr(piece["driver"], "setup") and hasattr(piece["driver"], "window")
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for m in SPEC["per_layer"]:
        reader = harness.load_reader(m["name"])
        assert reader.UNIT == m["unit"] and callable(reader.read)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert {"setup_s", "rulebook_s", "serve_qps"} == e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= {w["name"] for w in SPEC["workloads"]}


def test_a_missing_piece_is_named(bench_copy):
    (bench_copy / "workloads" / "x.json").write_text(json.dumps(
        dict(config="quest-t10i4d100k", traffic="no_such_mix", chips=1, why="a cell whose mix is missing")))
    with pytest.raises(harness.MissingPiece, match="no_such_mix.json"):
        harness.load_cell("x")
    (bench_copy / "workloads" / "y.json").write_text(json.dumps(
        dict(config="no_such_config", traffic="jobs_memory", chips=1, why="a cell whose config is missing")))
    with pytest.raises(harness.MissingPiece, match="no_such_config.json"):
        harness.load_cell("y")
    (bench_copy / "traffic" / "z.json").write_text(json.dumps(dict(driver="no_such_driver")))
    (bench_copy / "workloads" / "z.json").write_text(json.dumps(
        dict(config="quest-t10i4d100k", traffic="z", chips=1, why="a mix whose driver is missing")))
    with pytest.raises(harness.MissingPiece, match="drivers/no_such_driver.py"):
        harness.load_cell("z")
    with pytest.raises(harness.MissingPiece, match="no_such_cell.json"):
        harness.load_cell("no_such_cell")
    with pytest.raises(harness.MissingPiece, match="metrics/no_such_metric.py"):
        harness.load_reader("no_such_metric")


def test_a_cell_added_as_files_alone_runs_its_dry_path(bench_copy):
    (bench_copy / "traffic" / "jobs_memory_int8.json").write_text(json.dumps(
        dict(driver="jobs", route="memory", representation="dense", operand_dtype="int8")))
    (bench_copy / "workloads" / "quest-t10i4d100k.mine_int8.json").write_text(json.dumps(
        dict(config="quest-t10i4d100k", traffic="jobs_memory_int8", chips=1, why="a throwaway cell",
             limits=dict(itemsets_differing=0, rules_differing=0))))
    (bench_copy / "metrics" / "jobs_done.mine_int8.py").write_text(
        'UNIT = "jobs"\n\n\ndef read(run):\n    return len(run.get("jobs") or []) or None\n')
    line = harness.run_cell("quest-t10i4d100k.mine_int8", 2**40 + 3, 0.4, False, device="cpu",
                            overrides=tiny.OVERRIDES, log=lambda m: None)
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "rulebook_s"}
    # a driver that hands back no ranks' records: one card, this process's peak
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks", "_detail"]
    assert line["device"] == dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    assert not {"ranks", "forbidden"} & set(line["_detail"])
    traced = harness.run_cell("quest-t10i4d100k.mine_int8", 5, 0.4, True, device="cpu",
                              overrides=tiny.OVERRIDES, log=lambda m: None)
    assert traced["correct"] and traced["metrics"]["jobs_done.mine_int8"]["value"] >= 1
    assert "candgen_share.mine" in traced["metrics"] and list(traced)[-2:] == ["checks", "_detail"]
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks", "_detail"]
    assert list(traced["device"]) == ["platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"]
    assert traced["device"]["count"] == 1 and traced["device"]["memory_peak_bytes"] == 0
    assert traced["device"]["window_s"] > 0 and set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert not any(name.startswith("rank ") for name, _ in traced["breakdown"]["idle_gaps"])


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_the_benchmark_loads_is_jax_or_the_jax_package():
    for path in harness.BENCH.rglob("*.py"):
        if "tests" not in path.parts:
            assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path
    code = (
        "import sys, json\n"
        f"sys.path[0:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from bench import harness, control, sweep\n"
        "from bench.tests import tiny\n"
        "for w in ('quest-t10i4d100k.mine', 'quest-t10i4d100k.serve'):\n"
        "    harness.run_cell(w, 1, 0.3, True, device='cpu', overrides=tiny.OVERRIDES, log=lambda m: None)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        assert not _imports(path) & {"repro_torch", "repro", "jax"}, path
    code = (
        "import sys, json\n"
        f"sys.path[0:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import bench.reference.mine, bench.reference.rules\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert not set(json.loads(out.stdout.strip().splitlines()[-1])) & {"repro_torch", "repro", "jax"}


def test_the_command_refuses_a_machine_without_a_card():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "quest-t10i4d100k.mine", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
    assert out.returncode != 0 and out.stdout.strip() == ""
