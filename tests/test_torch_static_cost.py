"""PyTorch port: the count step's static cost (``launch/mine.py::
static_count_cost``) and the mine CLI's ``static_cost`` block, held against
the JAX package's.  The keys are the JAX CLI's; the flops of one dispatch
and the useful flops equal the JAX package's exactly, on one device in both
representations and, per rank, on 2 x 2 and (4, 1) layouts (the JAX side
lowers its shard_map step over 4 fake host devices in a subprocess); the
CLI with ``--device cpu --store --metrics-out`` writes the block with no
``error`` key and the JAX CLI's flops."""

import json
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

from repro.core.apriori import AprioriConfig as JCfg  # noqa: E402
from repro.launch.mine import static_count_cost as jax_static  # noqa: E402
from repro_torch.core.apriori import AprioriConfig  # noqa: E402
from repro_torch.launch.mesh import MeshLayout  # noqa: E402
from repro_torch.launch.mine import static_count_cost  # noqa: E402
from repro_torch.launch.roofline import PARTS  # noqa: E402

from conftest import REPO_ROOT, subprocess_env  # noqa: E402

SHAPES = [(1000, 64, 256), (4096, 200, 1024), (2048, 130, 512)]
CLI_KEYS = {"count_dispatches", "measured_count_kernel_s", "measured_vs_roofline"}


@pytest.mark.parametrize("representation", ["dense", "packed"])
@pytest.mark.parametrize("rows, items, k", SHAPES)
def test_one_device_flops_equal_jax(rows, items, k, representation):
    got = static_count_cost(AprioriConfig(representation=representation), None, rows, items, k)
    want = jax_static(JCfg(representation=representation, count_impl="jnp"), None, rows, items, k)
    assert set(got) == set(want)
    assert got["flops_per_dispatch"] == want["flops_per_dispatch"] == 2.0 * rows * items * k
    assert got["useful_flops_per_dispatch"] == want["useful_flops_per_dispatch"]
    assert got["useful_flops_ratio"] == want["useful_flops_ratio"]
    assert (got["rows_per_dispatch"], got["candidate_rows"]) == (rows, k)
    assert got["roofline_dominant"] in ("compute", "memory")
    assert got["hbm_bytes_per_dispatch"] >= rows * items + k * items   # operands read at least once


def test_flops_of_the_smoke_shape_and_its_roofline():
    """The smoke's ``[static-cost]`` shape: 8,192-row chunks of 1,000 items
    against a 65,536-candidate bucket, on the SXM part."""
    got = static_count_cost(AprioriConfig(representation="packed"), None, 8192, 1000, 65536,
                            chip=PARTS["sxm"])
    assert got["flops_per_dispatch"] == 2 * 8192 * 1000 * 65536
    bound = max(got["flops_per_dispatch"] / 989e12, got["hbm_bytes_per_dispatch"] / 3.35e12)
    assert got["roofline_s_per_dispatch"] == bound


_JAX_MESH = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    from repro.core.apriori import AprioriConfig
    from repro.launch.mesh import make_auto_mesh
    from repro.launch.mine import static_count_cost
    out = []
    for shape in [(2, 2), (4, 1)]:
        mesh = make_auto_mesh(shape, ("data", "model"))
        for rep in ["dense", "packed"]:
            cfg = AprioriConfig(data_axes=("data",), model_axis="model", count_impl="jnp",
                                representation=rep)
            for rows, items, k in SHAPES:
                out.append([list(shape), rep, rows, items, k,
                            static_count_cost(cfg, mesh, rows, items, k)])
    print(json.dumps(out))
""")


def test_per_rank_flops_equal_jax_per_device_on_meshes():
    code = f"SHAPES = {SHAPES!r}\n" + _JAX_MESH
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=subprocess_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rows_out = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(rows_out) == 12
    for shape, rep, rows, items, k, want in rows_out:
        cfg = AprioriConfig(model_axis="model", representation=rep)
        for rank in range(4):
            got = static_count_cost(cfg, MeshLayout(shape, ("data", "model"), rank=rank), rows, items, k)
            assert set(got) == set(want)
            assert got["flops_per_dispatch"] == want["flops_per_dispatch"] == \
                2.0 * (rows // shape[0]) * items * (k // shape[1]), (shape, rep, rows)
            assert got["useful_flops_per_dispatch"] == want["useful_flops_per_dispatch"]


def _cli(module, store, extra):
    args = ["--transactions", "3000", "--items", "64", "--min-support", "0.02", "--max-k", "3",
            "--store", store, "--stream-chunk-rows", "1000"] + extra
    # one torch thread: the test workers already share the cores
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO_ROOT,
                         env=dict(subprocess_env(), OMP_NUM_THREADS="1"), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


@pytest.mark.parametrize("representation", ["dense", "packed"])
def test_cli_metrics_out_block_matches_jax(tmp_path, representation):
    store = str(tmp_path / "store")
    port_m, jax_m = tmp_path / "port.json", tmp_path / "jax.json"
    rep = ["--representation", representation]
    _cli("repro_torch.launch.mine", store, rep + ["--device", "cpu", "--metrics-out", str(port_m)])
    _cli("repro.launch.mine", store, rep + ["--metrics-out", str(jax_m)])
    got = json.loads(port_m.read_text())["static_cost"]
    want = json.loads(jax_m.read_text())["static_cost"]
    assert "error" not in got and "error" not in want
    assert set(got) == set(want) and CLI_KEYS <= set(got)
    for key in ("rows_per_dispatch", "candidate_rows", "flops_per_dispatch",
                "useful_flops_per_dispatch", "useful_flops_ratio", "count_dispatches"):
        assert got[key] == want[key], key
    assert got["measured_count_kernel_s"] > 0 and got["measured_vs_roofline"] > 0
    ideal = got["roofline_s_per_dispatch"] * got["count_dispatches"]
    assert got["measured_vs_roofline"] == pytest.approx(got["measured_count_kernel_s"] / ideal)


def test_cli_metrics_out_on_a_mesh_costs_a_rank(tmp_path):
    store = str(tmp_path / "store")
    metrics = tmp_path / "m.json"
    _cli("repro_torch.launch.mine", store, ["--device", "cpu", "--host-devices", "4", "--mesh", "2x2",
                                             "--metrics-out", str(metrics)])
    got = json.loads(metrics.read_text())["static_cost"]
    assert "error" not in got
    layout = MeshLayout((2, 2), ("data", "model"))
    want = static_count_cost(AprioriConfig(model_axis="model"), layout, 1000, 64, got["candidate_rows"])
    assert got["flops_per_dispatch"] == want["flops_per_dispatch"] == \
        2.0 * 500 * 64 * got["candidate_rows"] / 2
