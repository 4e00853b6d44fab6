"""PyTorch port, dense representation on the CPU: the plain versions of K3
and the ``support_count`` wrapper against the JAX package's oracle, its
blocked path and its Pallas kernel in interpret mode; ``pack_bits_device``
byte-equal to the JAX packer (F3); and the dense ``mine`` dict-identical to
the JAX package's dense mine and to the port's packed mine.  Counts are
exact: no tolerance anywhere."""

import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import apriori as japr  # noqa: E402
from repro.core import itemsets as jenc  # noqa: E402
from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.blocked import support_count_blocked as jblocked  # noqa: E402
from repro_torch.core import apriori as tapr  # noqa: E402
from repro_torch.core import itemsets as tenc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import support_count as k3  # noqa: E402

from conftest import random_problem  # noqa: E402
from test_kernels import SHAPES  # noqa: E402

TORCH_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def _dense(x, operand_dtype):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int8)).to(TORCH_DTYPES[operand_dtype])


@pytest.fixture(scope="module")
def quest_db():
    return gen_transactions(QuestConfig(num_transactions=3000, num_items=96, avg_len=8, seed=5))


# ------------------------------------------------------------------ K3 -------
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("operand_dtype", ["bf16", "int8"])
def test_support_count_plain_matches_jax(shape, operand_dtype):
    """The plain versions and the wrapper (what CPU tensors take) equal the
    JAX oracle, its blocked path and the Pallas kernel in interpret mode."""
    n, i, k = shape
    t, c, lengths = random_problem(n, i, k, seed=n + i + k)
    jt, jc, jl = jnp.asarray(t), jnp.asarray(c), jnp.asarray(lengths)
    want = np.asarray(jops.support_count(jt, jc, jl, impl="jnp"))
    pallas = np.asarray(jops.support_count(jt, jc, jl, impl="pallas_interpret", operand_dtype=operand_dtype,
                                           block_n=128, block_k=128, block_i=128))
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(np.asarray(jblocked(jt, jc, jl)), want)
    tt, tc, tl = _dense(t, operand_dtype), _dense(c, operand_dtype), torch.from_numpy(lengths)
    got = tops.support_count(tt, tc, tl, operand_dtype=operand_dtype)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tref.support_count_ref(tt, tc, tl).numpy(), want)
    np.testing.assert_array_equal(tref.support_count_blocked(tt, tc, tl, block_k=64).numpy(), want)


@pytest.mark.parametrize("operand_dtype", ["bf16", "int8"])
def test_support_count_padding_inert(operand_dtype):
    """Zero transaction rows, zero item columns and len = -1 candidate rows
    change no count; an all-padding pass counts zero."""
    t, c, lengths = random_problem(64, 48, 16, seed=5)
    kw = dict(operand_dtype=operand_dtype)
    want = tops.support_count(_dense(t, operand_dtype), _dense(c, operand_dtype),
                              torch.from_numpy(lengths), **kw).numpy()
    t_pad = np.pad(t, ((0, 40), (0, 17)))
    c_pad = np.pad(c, ((0, 7), (0, 17)))
    c_pad[16:, :5] = 1                      # padding rows with bits: len = -1 still never matches
    len_pad = np.concatenate([lengths, np.full(7, -1, np.int32)])
    got = tops.support_count(_dense(t_pad, operand_dtype), _dense(c_pad, operand_dtype),
                             torch.from_numpy(len_pad), **kw).numpy()
    np.testing.assert_array_equal(got[:16], want)
    np.testing.assert_array_equal(got[16:], 0)
    zeros = np.zeros((12, t.shape[1]), np.int8)
    allpad = tops.support_count(_dense(t, operand_dtype), _dense(zeros, operand_dtype),
                                torch.full((12,), -1, dtype=torch.int32), **kw)
    np.testing.assert_array_equal(allpad.numpy(), 0)


# (N, I, K) at the card kernel's edges: N = 1,000 spans four 256-row tiles and
# is a multiple of neither 64 nor 128; I = 130 and 1,100 give item axes of
# 160 and 1,120, not multiples of a 128-byte TMA box; K = 600 holds a whole
# 128-candidate tile of padding rows (still holding bits) in the middle and a
# ragged tail tile.  The card tests hold the kernel to these plain versions.
EDGE_SHAPES = [(1000, 130, 600), (1000, 1100, 600)]


def _edge_problem(n, i, k, seed):
    t, c, lengths = random_problem(n, i, k, seed=seed)
    t[::7] = 0
    lengths[128:256] = -1
    return t, c, lengths


def _placed(x, num_items, operand_dtype):
    """x with the item axis padded by zero columns to the kernel's width, in
    the operand dtype, as ``place_db`` and the candidate placement hand it
    over."""
    return _dense(np.pad(x, ((0, 0), (0, k3.item_width(num_items) - num_items))), operand_dtype)


@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("operand_dtype", ["bf16", "int8"])
def test_support_count_plain_matches_jax_at_kernel_edges(shape, operand_dtype):
    n, i, k = shape
    t, c, lengths = _edge_problem(n, i, k, seed=sum(shape))
    jt, jc, jl = jnp.asarray(t), jnp.asarray(c), jnp.asarray(lengths)
    want = np.asarray(jops.support_count(jt, jc, jl, impl="jnp"))
    pallas = np.asarray(jops.support_count(jt, jc, jl, impl="pallas_interpret", operand_dtype=operand_dtype,
                                           block_n=128, block_k=128, block_i=128))
    np.testing.assert_array_equal(pallas, want)
    assert not want[128:256].any() and want.any()
    assert k3.item_width(i) == {130: 160, 1100: 1120}[i]
    tt, tc, tl = _placed(t, i, operand_dtype), _placed(c, i, operand_dtype), torch.from_numpy(lengths)
    np.testing.assert_array_equal(tops.support_count(tt, tc, tl, operand_dtype=operand_dtype).numpy(), want)
    np.testing.assert_array_equal(tref.support_count_ref(tt, tc, tl).numpy(), want)


@pytest.mark.parametrize("operand_dtype", ["bf16", "int8"])
def test_support_count_empty_candidate_counts_n(operand_dtype):
    """A candidate with no items and len = 0 is contained in every row, the
    zero rows included: it counts N, and no row past N (the kernel's
    zero-filled tile rows) may add to it."""
    n, i, k = EDGE_SHAPES[0]
    t, c, lengths = _edge_problem(n, i, k, seed=3)
    c[5], lengths[5] = 0, 0
    want = np.asarray(jops.support_count(jnp.asarray(t), jnp.asarray(c), jnp.asarray(lengths), impl="jnp"))
    assert want[5] == n
    got = tops.support_count(_placed(t, i, operand_dtype), _placed(c, i, operand_dtype),
                             torch.from_numpy(lengths), operand_dtype=operand_dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES[:4])
def test_packed_route_equals_dense(shape):
    """Packing on the device with ``pack_bits_device`` and counting through
    K1's plain version gives the dense counts and the JAX wrapper's
    ``impl="packed_jnp"`` counts."""
    n, i, k = shape
    t, c, lengths = random_problem(n, i, k, seed=n + i + k)
    lengths[::5] = -1
    tt, tc, tl = _dense(t, "int8"), _dense(c, "int8"), torch.from_numpy(lengths)
    before = tops.launch_counts()
    got = tops.support_count_packed(tops.pack_bits_device(tt), tops.pack_bits_device(tc), tl).numpy()
    np.testing.assert_array_equal(got, tops.support_count(tt, tc, tl).numpy())
    want = np.asarray(jops.support_count(*(jnp.asarray(x) for x in (t, c, lengths)), impl="packed_jnp"))
    np.testing.assert_array_equal(got, want)
    assert tops.launch_counts() == before


def test_support_count_wrapper_checks():
    t, c, lengths = random_problem(8, 16, 4, seed=1)
    tt, tc, tl = _dense(t, "int8"), _dense(c, "int8"), torch.from_numpy(lengths)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.support_count(tt, tc, tl, impl="kernel")
    with pytest.raises(TypeError):
        tops.support_count(tt.to(torch.int32), tc, tl)
    with pytest.raises(TypeError):
        tops.support_count(t, tc, tl)                     # numpy, not a tensor
    with pytest.raises(ValueError):
        tops.support_count(tt, tc[:, :3].contiguous(), tl)
    with pytest.raises(ValueError):
        tops.support_count(tt, tc, tl[:-1])
    with pytest.raises(ValueError):
        tops.support_count(tt, tc, tl, operand_dtype="fp8")
    with pytest.raises(ValueError):
        tops.support_count(tt, tc, tl, impl="pallas")
    with pytest.raises(ValueError):
        tops.support_count(tt, tc, tl, impl="packed")   # auto | kernel | ref only
    with pytest.raises(ValueError):
        tops.support_count(tt.t(), tc, tl)               # not contiguous
    before = tops.launch_counts()
    tops.support_count(tt, tc, tl, impl="ref")
    assert tops.launch_counts() == before  # the plain version is no launch


# ----------------------------------------------------- pack_bits_device ------
@pytest.mark.parametrize("num_items", [7, 32, 33, 64, 130])
def test_pack_bits_device_byte_equal_f3(num_items):
    """F3: words with bit 31 set (negative in the int32 view) come out with
    the same 32 bits as the JAX packer's wrapping uint32 sum and the host
    ``pack_bits``."""
    rng = np.random.default_rng(num_items)
    dense = (rng.random((17, num_items)) < 0.5).astype(np.int8)
    dense[:, 31::32] = 1
    dense[3] = 1
    want = np.asarray(jops.pack_bits_device(jnp.asarray(dense), num_items))
    for dt in (torch.int8, torch.bfloat16):
        got = tops.pack_bits_device(torch.from_numpy(dense).to(dt), num_items)
        assert got.dtype == torch.int32 and got.shape == want.shape
        words = got.numpy().view(np.uint32)
        assert words.tobytes() == want.tobytes() == jenc.pack_bits(dense).tobytes()
    if num_items >= 32:
        assert (got[:, 0] < 0).all()
    with pytest.raises(ValueError):
        tops.pack_bits_device(torch.from_numpy(dense), num_items + 1)


def test_itemsets_to_dense_byte_equal():
    sets = np.array([[0, 3, 9], [1, 2, 70], [5, 6, 7]], np.int32)
    for i in (71, 96, 128):
        got, want = tenc.itemsets_to_dense(sets, i), jenc.itemsets_to_dense(sets, i)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError):
        tenc.itemsets_to_dense(np.arange(4), 8)


# -------------------------------------------------------------- mine ---------
def _both(db, operand_dtype, **kw):
    jres = japr.mine(db, japr.AprioriConfig(count_impl="jnp", representation="dense",
                                            operand_dtype=operand_dtype, **kw))
    tres = tapr.mine(db, tapr.AprioriConfig(representation="dense", operand_dtype=operand_dtype, **kw),
                     device="cpu")
    packed = tapr.mine(db, tapr.AprioriConfig(representation="packed", **kw), device="cpu")
    return jres, tres, packed


@pytest.mark.parametrize("operand_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("per_pass", [1 << 16, 64])
def test_dense_mine_matches_jax_small_db(small_db, operand_dtype, per_pass):
    jres, tres, packed = _both(small_db, operand_dtype, min_support=0.05, max_k=4,
                               max_candidates_per_pass=per_pass)
    assert tres.as_dict() == jres.as_dict() == packed.as_dict()
    assert (tres.min_count, tres.num_transactions) == (jres.min_count, jres.num_transactions)
    for k, (sets, sup) in tres.levels.items():
        assert sets.dtype == jres.levels[k][0].dtype and sup.dtype == jres.levels[k][1].dtype


@pytest.mark.parametrize("operand_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("per_pass", [1 << 16, 64])
def test_dense_mine_matches_jax_quest(quest_db, operand_dtype, per_pass):
    jres, tres, packed = _both(quest_db, operand_dtype, min_support=0.03, max_k=4,
                               max_candidates_per_pass=per_pass, candidate_pad=32)
    assert tres.total_frequent > 100 and max(tres.levels) >= 3
    assert tres.as_dict() == jres.as_dict() == packed.as_dict()


def test_default_config_mines_dense(small_db):
    """``AprioriConfig()`` is dense bf16, and it mines (no unported path)."""
    cfg = tapr.AprioriConfig()
    assert (cfg.representation, cfg.operand_dtype) == ("dense", "bf16")
    res = tapr.mine(small_db, tapr.AprioriConfig(min_support=0.05, max_k=3), device="cpu")
    jres = japr.mine(small_db, japr.AprioriConfig(min_support=0.05, max_k=3, count_impl="jnp"))
    assert res.as_dict() == jres.as_dict() and res.total_frequent > 0
    ref = tapr.mine(small_db, tapr.AprioriConfig(min_support=0.05, max_k=3, count_impl="ref"), device="cpu")
    assert ref.as_dict() == res.as_dict()
    with pytest.raises(ValueError):
        tapr.mine(small_db, tapr.AprioriConfig(operand_dtype="fp8"), device="cpu")
    with pytest.raises(ValueError):
        tapr.mine(small_db, tapr.AprioriConfig(representation="sparse"), device="cpu")


@pytest.mark.parametrize("operand_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("num_items", [32, 96, 100])
def test_dense_placement_widths_agree(operand_dtype, num_items):
    """``place_db`` and the candidate placement pad the item axis to the same
    kernel multiple, in the operand dtype, with zero columns and rows."""
    rng = np.random.default_rng(num_items)
    db = (rng.random((50, num_items)) < 0.3).astype(np.int8)
    cfg = tapr.AprioriConfig(operand_dtype=operand_dtype)
    t_dev = tapr.place_db(db, cfg, device="cpu")
    width = -(-num_items // 32) * 32
    assert t_dev.shape == (50, width) and t_dev.dtype == TORCH_DTYPES[operand_dtype]
    np.testing.assert_array_equal(t_dev.to(torch.int8).numpy()[:, :num_items], db)
    assert not t_dev[:, num_items:].any()
    cands = np.array([[0, 5], [3, num_items - 1]], np.int32)
    c_dev, ln = tapr._place_candidates(cands, 256, num_items, cfg, "cpu")
    assert c_dev.shape == (256, width) and c_dev.dtype == t_dev.dtype
    np.testing.assert_array_equal(c_dev.to(torch.int8).numpy()[:2, :num_items],
                                  jenc.itemsets_to_dense(cands, num_items))
    assert not c_dev[2:].any() and not c_dev[:, num_items:].any()
    assert ln.tolist() == [2, 2] + [-1] * 254


def test_dense_pipeline_runs_several_passes(small_db, monkeypatch):
    """max_candidates_per_pass=64 splits a level into several dense passes,
    each padded to its bucket with len = -1 rows."""
    calls = []
    real = tops.support_count

    def spy(t, c, ln, **kw):
        calls.append((c.shape[0], int((ln >= 0).sum()), kw["operand_dtype"]))
        return real(t, c, ln, **kw)

    monkeypatch.setattr(tops, "support_count", spy)
    cfg = tapr.AprioriConfig(min_support=0.05, max_k=3, operand_dtype="int8",
                             max_candidates_per_pass=64, candidate_pad=32)
    tapr.mine(small_db, cfg, device="cpu")
    assert sum(1 for _, real, _ in calls if real == 64) >= 2
    assert all(real <= 64 and kp % 32 == 0 and kp >= real and dt == "int8" for kp, real, dt in calls)
