"""PyTorch port: the static walk on meta tensors (``launch/op_analysis.py``),
the counterpart of ``tests/test_dryrun_unit.py``'s HLO analyzer tests.  The
flops of a loop of L matmuls equal the hand count (a loop's body counted at
every trip, where XLA's cost analysis counts a while body once); the bytes
and the peak of live intermediates of a short op chain equal the hand
count; the mesh engine's collective is recorded with its group, not run;
the walk allocates no memory for data; and the shape-only ``MeshLayout``
places ranks as the live mesh does."""

import resource

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.core.apriori import AprioriConfig, _candidate_quantum, make_count_step  # noqa: E402
from repro_torch.launch import mine_dryrun, op_analysis  # noqa: E402
from repro_torch.launch.mesh import MeshLayout, host_mesh_shape, production_mesh_shape  # noqa: E402

meta = op_analysis.meta


def test_flops_of_a_loop_of_matmuls_count_every_trip():
    L, D, F = 8, 64, 128

    def fwd(w1, w2, x):
        h = x
        for layer in range(L):
            h = torch.tanh(h @ w1[layer]) @ w2[layer]
        return h.sum()

    c = op_analysis.analyze(fwd, meta((L, D, F), torch.float32), meta((L, F, D), torch.float32),
                            meta((4, D), torch.float32))
    assert c.flops == 2 * 4 * D * F * 2 * L   # two matmuls per layer, L layers


def test_bytes_and_peak_of_a_short_op_chain():
    n = 100 * 10

    def chain(x, y):
        a = x * 2            # reads x, writes a: 2n·4
        b = a + y            # reads a, y, writes b: 3n·4
        del a
        c = b.view(10, 100)  # a view moves nothing
        return c.sum()       # reads b, writes 4 bytes

    c = op_analysis.analyze(chain, meta((100, 10), torch.float32), meta((100, 10), torch.float32))
    assert c.hbm_bytes == (2 * n + 3 * n + n) * 4 + 4
    assert c.temp_bytes == 2 * n * 4          # a and b alive at once, never more
    assert c.flops == 0 and c.collective_bytes == 0


def test_in_place_result_is_its_operand_counted_once():
    def bump(x):
        x.add_(1)
        return x

    c = op_analysis.analyze(bump, meta((50,), torch.int32))
    assert c.hbm_bytes == 50 * 4 and c.temp_bytes == 0


def test_support_count_flops_equal_the_hand_count():
    from repro_torch.kernels import ops

    c = op_analysis.analyze(ops.support_count, meta((1000, 64), torch.int8), meta((256, 64), torch.int8),
                            meta((256,), torch.int32))
    assert c.flops == 32_768_000 == 2 * 1000 * 64 * 256


@pytest.mark.parametrize("shape, model_axis, want_ranks", [
    ((2, 2), "model", (0, 2)),           # split output: its block of 256, over rank 0's data group
    ((2, 2), None, (0, 2)),              # rank 0's data group only
    ((4, 1), "model", (0, 1, 2, 3)),
])
def test_mesh_step_collective_recorded_not_run(shape, model_axis, want_ranks):
    layout = MeshLayout(shape, ("data", "model"))
    cfg = AprioriConfig(model_axis=model_axis, count_impl="ref")
    step = make_count_step(cfg, layout)
    kb = 512 // (shape[1] if model_axis else 1)
    c = op_analysis.analyze(step, meta((300, 40), torch.int8), meta((kb, 40), torch.int8),
                            meta((kb,), torch.int32))
    assert c.flops == 2 * 300 * 40 * kb
    assert c.collective_counts == {"all-reduce": 1}
    assert c.collective_bytes == c.collective_by_type["all-reduce"] == kb * 4
    assert c.collective_groups == [want_ranks]
    assert not dist.is_initialized()


def test_other_collectives_raise():
    def bcast(x):
        dist.broadcast(x, 0)

    with pytest.raises(NotImplementedError, match="broadcast"):
        op_analysis.analyze(bcast, meta((4,), torch.int32))


def test_walk_needs_meta_tensors():
    with pytest.raises(RuntimeError, match="meta"):
        op_analysis.analyze(lambda x: x * 2, torch.ones(3))


def test_walk_allocates_no_memory_for_data():
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    rec = mine_dryrun.run("ours_2d")          # 0.54 GB of rows and a 1.07 GB product a rank
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - before
    assert rec["temp_gb_per_dev"] > 1.5
    assert grown < 0.2e9, grown


def test_layout_places_ranks_as_the_mesh_does():
    assert production_mesh_shape() == ((16, 16), ("data", "model"))
    assert production_mesh_shape(multi_pod=True) == ((2, 16, 16), ("pod", "data", "model"))
    assert host_mesh_shape() == ((2, 2), ("data", "model"))
    lay = MeshLayout((2, 3), ("data", "model"), rank=4)
    assert (lay.coord("data"), lay.coord("model")) == (1, 1)
    assert lay.shard(("data", "model")) == (4, 6) and lay.shard("model") == (1, 3)
    assert lay.group_ranks("data") == (1, 4)
    assert lay.group_ranks("model") == (3, 4, 5)
    assert lay.group_ranks(("model", "data")) == tuple(range(6))
    assert lay.group("model") == (3, 4, 5) and lay.group_size(("data", "model")) == 6
    pod = MeshLayout((2, 2, 2), ("pod", "data", "model"), rank=5)
    assert pod.group_ranks(("pod", "data")) == (1, 3, 5, 7)
    # the candidate pad quantum reads only the shape: 3 model shards give 258
    cfg = AprioriConfig(model_axis="model")
    assert _candidate_quantum(cfg, lay) == 258
    assert _candidate_quantum(cfg, MeshLayout(*production_mesh_shape())) == 256
    with pytest.raises(ValueError):
        MeshLayout((2, 2), ("data", "model"), rank=4)
