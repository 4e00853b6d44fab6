"""PyTorch port: the H100 roofline (``launch/roofline.py``).  Card names map
to their parts and an unknown name raises; ``Roofline`` picks the dominant
term, the bound and the compute fraction as the JAX package's does for the
same terms; the SXM rates are the ones every bound in ``chip_smoke.py`` is
computed from; a group's link is NVLink inside a node of 8, NDR across
nodes; importing the module touches no CUDA state."""

import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401  (both frameworks in one process; only numbers cross)

from repro.launch import roofline as jrl  # noqa: E402
from repro_torch.launch import roofline as trl  # noqa: E402
from repro_torch.launch.mesh import MeshLayout, production_mesh_shape  # noqa: E402

from conftest import REPO_ROOT, subprocess_env  # noqa: E402


@pytest.mark.parametrize("name, part", [
    ("NVIDIA H100 80GB HBM3", "sxm"),
    ("NVIDIA H100 SXM5 80GB", "sxm"),
    ("NVIDIA H100 PCIe", "pcie"),
    ("NVIDIA H100 NVL", "nvl"),
])
def test_card_names_map_to_their_parts(name, part):
    assert trl.part_for_name(name) is trl.PARTS[part]
    assert trl.detect_chip(part=part) is trl.PARTS[part]


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H200", "Tesla T4", ""])
def test_unknown_card_raises(name):
    with pytest.raises(ValueError, match="no roofline"):
        trl.part_for_name(name)


def test_unknown_part_raises():
    with pytest.raises(ValueError, match="unknown part"):
        trl.detect_chip(part="h100")
    with pytest.raises(ValueError, match="no peak rate"):
        trl.PARTS["sxm"].peak("fp8")


def test_sxm_rates_are_the_data_sheet_figures_the_smoke_bounds_use():
    sxm = trl.PARTS["sxm"]
    assert (sxm.hbm_bytes_per_s, sxm.fp32_flop_per_s, sxm.bf16_flop_per_s, sxm.int8_op_per_s) == (
        3.35e12, 67e12, 989e12, 1979e12)
    assert sxm.int32_op_per_s == 132 * 64 * 1.98e9
    assert sxm.power_w == 700.0
    pcie, nvl = trl.PARTS["pcie"], trl.PARTS["nvl"]
    assert (pcie.bf16_flop_per_s, pcie.int8_op_per_s, pcie.hbm_bytes_per_s) == (756e12, 1513e12, 2.0e12)
    assert (nvl.bf16_flop_per_s, nvl.int8_op_per_s, nvl.hbm_bytes_per_s) == (835e12, 1671e12, 3.9e12)
    # the int32 lanes are a quarter of the fp32 figure, which counts an FMA as two
    for chip in trl.PARTS.values():
        assert abs(chip.int32_op_per_s / chip.fp32_flop_per_s - 0.25) < 0.01


@pytest.mark.parametrize("terms", [
    (1.0, 2.0, 3.0), (3.0, 2.0, 1.0), (2.0, 3.0, 1.0), (0.0, 0.0, 0.0), (5e-6, 5e-6, 1e-9),
    (1e-3, 1.2e-3, 5e-6),
])
def test_roofline_behaves_as_the_jax_roofline(terms):
    got, want = trl.Roofline(*terms), jrl.Roofline(*terms)
    assert got.dominant == want.dominant
    assert got.bound_s == want.bound_s
    assert got.compute_fraction == want.compute_fraction


@pytest.mark.parametrize("part", sorted(trl.PARTS))
@pytest.mark.parametrize("dtype", ["bf16", "int8", "fp32", "int32"])
def test_roofline_terms_divide_by_the_parts_rates(part, dtype):
    chip = trl.PARTS[part]
    rl = trl.roofline_terms(1e12, 4e9, 2e6, chip=chip, dtype=dtype)
    assert rl.compute_s == 1e12 / chip.peak(dtype)
    assert rl.memory_s == 4e9 / chip.hbm_bytes_per_s
    assert rl.collective_s == 2e6 / chip.nvlink_bytes_per_s
    ndr = trl.roofline_terms(1e12, 4e9, 2e6, chip=chip, dtype=dtype, link_bytes_per_s=trl.NDR_BYTES_PER_S)
    assert ndr.collective_s == 2e6 / 50e9
    assert trl.roofline_terms(1e12, 0, 0).compute_s == 1e12 / 989e12   # SXM, bf16 by default


def test_links_nvlink_inside_a_node_ndr_across():
    sxm = trl.PARTS["sxm"]
    assert trl.link_bytes_per_s(range(8), sxm) == 450e9
    assert trl.link_bytes_per_s((8, 9, 15), sxm) == 450e9
    assert trl.link_bytes_per_s((7, 8), sxm) == trl.NDR_BYTES_PER_S
    assert trl.link_bytes_per_s((), sxm) == 450e9
    # every group of the dry run's 16 x 16 layout spans nodes; a 2 x 2 mesh's none
    prod = MeshLayout(*production_mesh_shape(), rank=37)
    for axes in (("data",), ("model",), ("data", "model")):
        assert trl.link_bytes_per_s(prod.group_ranks(axes)) == trl.NDR_BYTES_PER_S
    small = MeshLayout((2, 2), ("data", "model"), rank=3)
    assert trl.link_bytes_per_s(small.group_ranks(("data", "model"))) == 450e9


def test_import_touches_no_cuda():
    code = ("import sys, torch\n"
            "torch.cuda.get_device_properties = lambda *a, **k: sys.exit('read the card')\n"
            "import repro_torch.launch.roofline as r\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert r.detect_chip(part='sxm').part == 'sxm'\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=subprocess_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
