"""PyTorch port: the production dry run (``launch/mine_dryrun.py``) held
against ``python -m repro.launch.mine_dryrun --n 65536 --k 4096``.  The
variants and keys are the JAX package's; ``paper_1d`` and ``ours_2d`` flops
per rank equal JAX's per device exactly; ``ours_2d_blocked`` (slices, no
padding row) equals the port's ``ours_2d``; the collective bytes equal
JAX's: one all-reduce of the rank's counts over the data axes, the whole
(K,) vector on ``paper_1d`` (16,384 bytes at K = 4,096) and the rank's K/16
block on ``ours_2d`` (1,024 bytes).  At the default shapes the terms are
the H100 SXM data sheet's."""

import json
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mine_dryrun  # noqa: E402

from conftest import REPO_ROOT, subprocess_env  # noqa: E402

N, K = 65536, 4096


@pytest.fixture(scope="module")
def jax_recs():
    out = subprocess.run([sys.executable, "-m", "repro.launch.mine_dryrun", "--n", str(N), "--k", str(K)],
                         cwd=REPO_ROOT, env=subprocess_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return {r["variant"]: r for r in json.loads(out.stdout)}


@pytest.fixture(scope="module")
def port_recs():
    return {v: mine_dryrun.run(v, n=N, k_cands=K) for v in mine_dryrun.VARIANTS}


def test_variants_and_keys_are_jax(jax_recs, port_recs):
    assert list(port_recs) == list(jax_recs) == ["paper_1d", "ours_2d", "ours_2d_blocked"]
    for v in port_recs:
        assert set(port_recs[v]) == set(jax_recs[v])
        assert port_recs[v]["collective_counts"] == jax_recs[v]["collective_counts"] == {"all-reduce": 1}


@pytest.mark.parametrize("variant", ["paper_1d", "ours_2d"])
def test_flops_equal_jax(jax_recs, port_recs, variant):
    got, want = port_recs[variant], jax_recs[variant]
    assert got["flops_per_dev"] == want["flops_per_dev"] == 2.0 * 4096 * 2048 * 256
    assert got["useful_flops_ratio"] == want["useful_flops_ratio"] == 1.0


def test_blocked_flops_equal_ours_2d_without_padding(jax_recs, port_recs):
    assert port_recs["ours_2d_blocked"]["flops_per_dev"] == port_recs["ours_2d"]["flops_per_dev"]
    # the JAX package pads K/M = 256 to one 512-row block: twice the flops
    assert jax_recs["ours_2d_blocked"]["flops_per_dev"] == 2 * jax_recs["ours_2d"]["flops_per_dev"]


def test_collective_bytes_are_what_the_port_engine_sends(jax_recs, port_recs):
    assert port_recs["paper_1d"]["coll_per_dev"] == jax_recs["paper_1d"]["coll_per_dev"] == K * 4 == 16384
    for v in ("ours_2d", "ours_2d_blocked"):
        # the rank's model block, reduced over the data axes only
        assert port_recs[v]["coll_per_dev"] == jax_recs["ours_2d"]["coll_per_dev"] == K // 16 * 4 == 1024
    # every group of the 16 x 16 layout crosses nodes: one NDR port, 50 GB/s
    assert port_recs["ours_2d"]["collective_s"] == 1024 / 50e9


def test_default_shapes_on_the_sxm_data_sheet():
    recs = {v: mine_dryrun.run(v) for v in mine_dryrun.VARIANTS}
    flops = 2.0 * 4096 * 2048 * 65536      # = 2 * 65,536 * 2,048 * 4,096 on ours_2d
    for r in recs.values():
        assert r["flops_per_dev"] == flops
        assert r["compute_s"] == pytest.approx(flops / 989e12) and abs(r["compute_s"] - 1.11e-3) < 0.01e-3
    assert recs["paper_1d"]["coll_per_dev"] == 65536 * 4
    assert recs["ours_2d"]["coll_per_dev"] == recs["ours_2d_blocked"]["coll_per_dev"] == 65536 // 16 * 4 == 16384
    assert recs["ours_2d_blocked"]["temp_gb_per_dev"] < recs["ours_2d"]["temp_gb_per_dev"]
    pcie = mine_dryrun.run("ours_2d", part="pcie")
    assert pcie["compute_s"] == pytest.approx(flops / 756e12)


def test_cli_prints_the_records(capsys, tmp_path):
    out = tmp_path / "d.json"
    recs = mine_dryrun.main(["--variant", "ours_2d", "--n", str(N), "--k", str(K), "--out", str(out)])
    assert json.loads(capsys.readouterr().out) == recs == json.loads(out.read_text())
