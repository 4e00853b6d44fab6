"""PyTorch port: host encodings, candidate generation and synthetic data are
byte-equal to the JAX package's; words survive the int32 view (F2); the
package stays free of jax and of the JAX package; entry points refuse to run
without CUDA unless asked for the CPU."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401  (both frameworks in one process; only numpy crosses)
import numpy as np  # noqa: E402

from repro.core import candidates as jcand  # noqa: E402
from repro.core import itemsets as jenc  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import candidates as tcand  # noqa: E402
from repro_torch.core import itemsets as tenc  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

from conftest import REPO_ROOT  # noqa: E402


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ----------------------------------------------------------- encodings -------
@pytest.mark.parametrize("num_items", [7, 32, 33, 96, 130])
def test_packing_byte_equal(num_items):
    """Inputs of tests/test_packed.py: itemsets_to_packed, pack_bits,
    unpack_bits and packed_words agree byte for byte."""
    rng = np.random.default_rng(num_items)
    sets = np.sort(rng.choice(num_items, size=(20, min(4, num_items)), replace=True), axis=1).astype(np.int32)
    dense = (rng.random((13, num_items)) < 0.4).astype(np.int8)
    _equal(tenc.itemsets_to_packed(sets, num_items), jenc.itemsets_to_packed(sets, num_items))
    _equal(tenc.pack_bits(dense), jenc.pack_bits(dense))
    _equal(tenc.unpack_bits(jenc.pack_bits(dense), num_items), jenc.unpack_bits(jenc.pack_bits(dense), num_items))
    assert tenc.packed_words(num_items) == jenc.packed_words(num_items)


def test_small_helpers_byte_equal():
    lists = [[0, 5, 63], [], [7], list(range(0, 64, 3))]
    _equal(tenc.dense_from_lists(lists, 64), jenc.dense_from_lists(lists, 64))
    _equal(tenc.singleton_itemsets(9), jenc.singleton_itemsets(9))
    with pytest.raises(ValueError):
        tenc.itemsets_to_packed(np.array([[0, 5]], np.int32), 5)


def test_unpack_bits_ref_matches_host_unpack():
    rng = np.random.default_rng(3)
    for i in (17, 32, 75, 128):
        dense = (rng.random((13, i)) < 0.4).astype(np.int8)
        words = torch.from_numpy(tenc.pack_bits(dense).view(np.int32))
        np.testing.assert_array_equal(tref.unpack_bits_ref(words, i).numpy(), dense.astype(np.float32))


def test_f2_high_bit_words_roundtrip_through_int32_view():
    """F2: words with bit 31 set are negative in the int32 view; shifts
    sign-extend, so every unpack masks with & 1 — the bits must round-trip."""
    words = np.array([[0x80000000, 0xFFFFFFFF], [0x80000001, 0x7FFFFFFF]], np.uint32)
    t = torch.from_numpy(words.view(np.int32))
    assert (t < 0).any()
    got = tref.unpack_bits_ref(t, 64).numpy().astype(np.int8)
    np.testing.assert_array_equal(got, jenc.unpack_bits(words, 64))
    pop = tref.popcount32(t).numpy()
    np.testing.assert_array_equal(pop, [[1, 32], [2, 31]])
    back = t.numpy().view(np.uint32)
    _equal(back, words)


# ---------------------------------------------------------- candidates -------
@pytest.mark.parametrize("seed", range(6))
def test_generate_candidates_identical(seed):
    rng = np.random.default_rng(seed)
    k = 1 + seed % 4
    num_items = k + 12
    rows = {tuple(sorted(rng.choice(num_items, size=k, replace=False))) for _ in range(30)}
    freq = np.array(sorted(rows), dtype=np.int32)
    _equal(tcand.generate_candidates(freq), jcand.generate_candidates(freq))


def test_candidate_helpers_identical():
    table = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
    q = np.array([[0, 1], [1, 3], [1, 2]], np.int32)
    _equal(tcand.rows_isin(q, table), jcand.rows_isin(q, table))
    _equal(tcand.all_k_subsets_of_universe(6, 3), jcand.all_k_subsets_of_universe(6, 3))


# ----------------------------------------------------------- synthetic -------
def test_quest_rows_identical_under_seed():
    cfg = dict(num_transactions=500, num_items=64, avg_len=8, num_patterns=10, seed=11)
    _equal(tsyn.gen_transactions(tsyn.QuestConfig(**cfg)), jsyn.gen_transactions(jsyn.QuestConfig(**cfg)))
    chunks_t = list(tsyn.gen_transactions_chunked(tsyn.QuestConfig(**cfg), chunk_rows=77))
    _equal(np.concatenate(chunks_t), jsyn.gen_transactions(jsyn.QuestConfig(**cfg)))


# ------------------------------------------------------------- hygiene -------
def _port_files():
    root = Path(REPO_ROOT)
    return sorted((root / "src" / "repro_torch").rglob("*.py")) + [root / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = []
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{f.relative_to(REPO_ROOT)}:{node.lineno} imports {name}")
    assert not bad, bad


def test_entry_points_need_cuda_or_explicit_cpu(small_db):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    from repro_torch.core.apriori import AprioriConfig, mine
    from repro_torch.serving.recommend import recommend
    from repro_torch.serving.rulebook import compile_rulebook, place_rulebook

    cfg = AprioriConfig(min_support=0.1, max_k=2, representation="packed")
    with pytest.raises(RuntimeError, match="CUDA"):
        mine(small_db, cfg)
    res = mine(small_db, cfg, device="cpu")
    rb = compile_rulebook(res, min_confidence=0.3, num_items=small_db.shape[1], pad_multiple=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        recommend(rb, small_db[:4])
    with pytest.raises(RuntimeError, match="CUDA"):
        place_rulebook(rb)
    assert recommend(rb, small_db[:4], device="cpu").items.shape[0] == 4


def test_nvcc_command_targets_sm90a():
    from repro_torch.kernels import _build

    cmd = _build.nvcc_command(Path("x.cu"), Path("x.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-Xptxas" in cmd
    assert set(_build.SOURCES) == {"support_count_packed", "rule_match", "support_count"}
    assert all(p.exists() for p in _build.SOURCES.values())


def test_import_builds_nothing():
    """Importing every module of the port touches no CUDA state and builds
    no library."""
    import importlib

    from repro_torch.kernels import _build

    for f in Path(REPO_ROOT, "src", "repro_torch").rglob("*.py"):
        mod = ".".join(f.relative_to(Path(REPO_ROOT, "src")).with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))
    assert _build._LIBS == {}
