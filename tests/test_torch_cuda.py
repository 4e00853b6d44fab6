"""PyTorch port on the card: each CUDA kernel against its plain version at
the sweep shapes, the mine -> compile -> recommend chain through the
kernels, and the dense and SON mines through K3.  Marked ``gpu``; every test skips without a card (decided in the
fixture, so every worker collects the same tests).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import sys

import numpy as np
import pytest
from conftest import REPO_ROOT

torch = pytest.importorskip("torch")

sys.path.insert(0, REPO_ROOT)
from chip_smoke import k1_edge_problem  # noqa: E402  (K1's edges, shared with the smoke and tools)
from repro_torch.core.itemsets import itemsets_to_packed, pack_bits, packed_words  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.gpu

# (N, I, K) of the JAX package's tests/test_kernels.py sweep, plus a W > 32
# case that exercises the kernel's word-chunk loop
SHAPES = [(8, 16, 4), (100, 64, 33), (256, 128, 128), (300, 130, 257), (512, 512, 300),
          (200, 1100, 70)]
# K3 adds its edges: N = 1,000 (a ragged 256-row tile), item axes of 160 and
# 1,120 (not multiples of a 128-byte TMA box), K = 600 (an all-padding tile
# in the middle, a ragged tail); N = 20,000 gives each persistent block
# several work units; K = 70,000 takes two launch windows of 65,536.
DENSE_SHAPES = SHAPES + [(1000, 130, 600), (1000, 1100, 600), (20000, 1000, 3000), (300, 64, 70000)]
# (B, I, R) of tests/test_rule_match.py
RULE_SHAPES = [(8, 16, 4), (100, 37, 33), (64, 96, 300), (33, 130, 257), (16, 31, 128)]
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _words(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32).view(np.int32)).to(dev)


def _count_problem(shape, seed):
    n, i, k = shape
    rng = np.random.default_rng(seed)
    t = (rng.random((n, i)) < 0.3).astype(np.int8)
    sizes = rng.integers(1, min(6, i) + 1, size=k)
    c = np.zeros((k, i), np.int8)
    for row, s in enumerate(sizes):
        c[row, rng.choice(i, size=s, replace=False)] = 1
    lengths = c.sum(1).astype(np.int32)
    lengths[rng.random(k) < 0.1] = -1
    return pack_bits(t), pack_bits(c), lengths


def _rule_problem(shape, seed):
    b, i, r = shape
    rng = np.random.default_rng(seed)
    baskets = pack_bits((rng.random((b, i)) < 0.3).astype(np.int8))
    ante = np.stack([itemsets_to_packed(np.sort(rng.choice(i, rng.integers(1, min(4, i) + 1), replace=False))[None], i)[0]
                     for _ in range(r)])
    cons = np.stack([itemsets_to_packed(np.sort(rng.choice(i, rng.integers(1, min(3, i) + 1), replace=False))[None], i)[0]
                     for _ in range(r)])
    lengths = np.array([sum(bin(int(w)).count("1") for w in row) for row in ante], np.int32)
    scores = rng.random(r).astype(np.float32)
    pad = rng.random(r) < 0.2
    ante[pad], cons[pad], lengths[pad], scores[pad] = 0, 0, -1, 0
    return baskets, ante, lengths, cons, scores


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["and_cmp", "popcount"])
def test_support_count_kernel_exact(cuda, shape, mode):
    tp, cp, lengths = _count_problem(shape, seed=sum(shape))
    t, c, ln = _words(tp, cuda), _words(cp, cuda), torch.from_numpy(lengths).to(cuda)
    before = ops.launch_counts()["support_count_packed"]
    got = ops.support_count_packed(t, c, ln, mode=mode)
    want = ops.support_count_packed(t, c, ln, mode=mode, impl="ref")
    torch.cuda.synchronize()
    assert ops.launch_counts()["support_count_packed"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), ops.support_count_packed(t.cpu(), c.cpu(), ln.cpu(), mode=mode))


@pytest.mark.parametrize("n", [1, 77, 1000])
@pytest.mark.parametrize("mode", ["and_cmp", "popcount"])
def test_k1_kernel_edges(cuda, n, mode):
    """K1 on its edges: exactly the plain row-layout version and the plain
    bitmap count, in both modes; the empty candidates count n (len 0) and,
    in popcount mode, 0 (len 3)."""
    from repro_torch.kernels import ref

    tp, cp, lengths = k1_edge_problem(n, seed=n)
    t, c, ln = _words(tp, cuda), _words(cp, cuda), torch.from_numpy(lengths).to(cuda)
    before = ops.launch_counts()["support_count_packed"]
    got = ops.support_count_packed(t, c, ln, mode=mode)
    want = ops.support_count_packed(t, c, ln, mode=mode, impl="ref")
    bitmap = ref.support_count_bitmaps(ref.item_bitmaps(t), c, ln, n, mode)
    torch.cuda.synchronize()
    assert ops.launch_counts()["support_count_packed"] == before + 1
    assert torch.equal(got, want) and torch.equal(got, bitmap)
    assert int(got[0]) == n and int(got[1]) == (n if mode == "and_cmp" else 0)


@pytest.mark.parametrize("mode", ["and_cmp", "popcount"])
def test_k1_kernel_row_slabs(cuda, mode, monkeypatch):
    """With the bitmap scratch capped at one slab of 1,024 rows, a launch
    walks 5 slabs of 4,100 rows and still gives the plain version's counts."""
    from repro_torch.kernels import support_count_packed as k1

    tp, cp, lengths = k1_edge_problem(4100, seed=4)
    t, c, ln = _words(tp, cuda), _words(cp, cuda), torch.from_numpy(lengths).to(cuda)
    monkeypatch.setattr(k1, "SCRATCH_CAP", 128 * t.shape[1] * 32)
    assert k1.slab_words(4100, t.shape[1]) == 32
    got = ops.support_count_packed(t, c, ln, mode=mode)
    want = ops.support_count_packed(t, c, ln, mode=mode, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_k1_level2_pass_equals_k3(cuda):
    """At the main path's level-2 pass (FIMI T10I4D100K shape: N = 100,000,
    41,616 candidates in a bucket of 65,536) K1 in both modes gives K3's
    counts."""
    from repro_torch.core import apriori
    from repro_torch.core.candidates import generate_candidates
    from repro_torch.data.synthetic import QuestConfig, gen_transactions

    db = gen_transactions(QuestConfig(num_transactions=100_000, num_items=1_000, avg_len=10.0, seed=0))
    freq1 = np.flatnonzero(db.sum(0, dtype=np.int64) >= 200).astype(np.int32)[:, None]
    cands = generate_candidates(freq1)
    kp = apriori._pad_bucket(cands.shape[0], apriori._candidate_quantum(apriori.AprioriConfig()))
    dense = apriori.AprioriConfig()
    want = ops.support_count(apriori.place_db(db, dense, cuda),
                             *apriori._place_candidates(cands, kp, db.shape[1], dense, cuda))
    packed = apriori.AprioriConfig(representation="packed")
    t = apriori.place_db(db, packed, cuda)
    c, ln = apriori._place_candidates(cands, kp, db.shape[1], packed, cuda)
    for mode in ("and_cmp", "popcount"):
        assert torch.equal(ops.support_count_packed(t, c, ln, mode=mode), want)


def _dense_problem(shape, seed):
    """Zero rows, len = -1 rows, a whole tile of them where K reaches 256."""
    n, i, k = shape
    rng = np.random.default_rng(seed)
    t = (rng.random((n, i)) < 0.3).astype(np.int8)
    t[::7] = 0
    c = np.zeros((k, i), np.int8)
    for row in range(k):
        c[row, rng.choice(i, size=rng.integers(1, min(6, i) + 1), replace=False)] = 1
    lengths = c.sum(1).astype(np.int32)
    lengths[rng.random(k) < 0.1] = -1
    lengths[128:256] = -1
    return t, c, lengths


def _dense_kernel_exact(dev, t, c, lengths, operand_dtype):
    """K3 on (t, c, lengths) with the item axis padded to the kernel's width:
    one launch, exactly the plain version on the card and on the CPU, and
    K1's counts on the same candidates.  Returns the counts."""
    from repro_torch.kernels import support_count as k3

    i = t.shape[1]
    _, dt = k3.DTYPES[operand_dtype]
    pad = ((0, 0), (0, k3.item_width(i) - i))
    tt = torch.from_numpy(np.pad(t, pad)).to(dev).to(dt)
    tc = torch.from_numpy(np.pad(c, pad)).to(dev).to(dt)
    ln = torch.from_numpy(lengths).to(dev)
    before = ops.launch_counts()["support_count"]
    got = ops.support_count(tt, tc, ln, operand_dtype=operand_dtype)
    want = ops.support_count(tt, tc, ln, impl="ref")
    torch.cuda.synchronize()
    assert ops.launch_counts()["support_count"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), ops.support_count(tt.cpu(), tc.cpu(), ln.cpu()))
    packed = ops.support_count_packed(ops.pack_bits_device(tt), ops.pack_bits_device(tc), ln)
    assert torch.equal(got, packed)
    return got


@pytest.mark.parametrize("shape", DENSE_SHAPES)
@pytest.mark.parametrize("operand_dtype", ["bf16", "int8"])
def test_dense_support_count_kernel_exact(cuda, shape, operand_dtype):
    """K3 equals its plain version and K1 exactly, with zero rows, len = -1
    rows, a whole tile of them where K reaches 256, and the item axis padded
    to the kernel's width; one launch per call."""
    _dense_kernel_exact(cuda, *_dense_problem(shape, seed=sum(shape)), operand_dtype)


@pytest.mark.parametrize("operand_dtype", ["bf16", "int8"])
def test_dense_kernel_empty_candidate_counts_n(cuda, operand_dtype):
    """A candidate with no items and len = 0 counts N: no zero-filled tile
    row past N adds to it."""
    t, c, lengths = _dense_problem((1000, 130, 600), seed=3)
    c[5], lengths[5] = 0, 0
    got = _dense_kernel_exact(cuda, t, c, lengths, operand_dtype)
    assert int(got[5]) == 1000


def test_dense_kernel_takes_placed_operands_only(cuda):
    """The kernel route copies nothing: an operand of another dtype than the
    operand dtype, or an item axis off the kernel's multiple, raises."""
    t = torch.ones((8, 64), dtype=torch.int8, device=cuda)
    ln = torch.ones(4, dtype=torch.int32, device=cuda)
    before = ops.launch_counts()["support_count"]
    with pytest.raises(TypeError):
        ops.support_count(t, t[:4], ln, operand_dtype="bf16")
    with pytest.raises(ValueError):
        ops.support_count(t[:, :48].contiguous(), t[:4, :48].contiguous(), ln, operand_dtype="int8")
    assert ops.launch_counts()["support_count"] == before


def test_dense_and_son_mines_through_kernels(cuda):
    from repro_torch.core.apriori import AprioriConfig, mine
    from repro_torch.core.son import mine_son
    from repro_torch.data.synthetic import QuestConfig, gen_transactions

    db = gen_transactions(QuestConfig(num_transactions=3000, num_items=100, avg_len=8, seed=5))
    for dtype in ("bf16", "int8"):
        cfg = AprioriConfig(min_support=0.03, max_k=4, operand_dtype=dtype)
        cpu = mine(db, cfg, device="cpu").as_dict()
        before = ops.launch_counts()["support_count"]
        assert mine(db, cfg).as_dict() == cpu
        mid = ops.launch_counts()["support_count"]
        assert mine_son(db, cfg, num_partitions=4).as_dict() == cpu
        assert mid > before and ops.launch_counts()["support_count"] > mid


@pytest.mark.parametrize("shape", RULE_SHAPES)
def test_rule_match_kernel_close_and_deterministic(cuda, shape):
    args = [torch.from_numpy(x).to(cuda) if x.dtype != np.uint32 else _words(x, cuda)
            for x in _rule_problem(shape, seed=sum(shape))]
    i = shape[1]
    got = ops.rule_match(*args, num_items=i)
    again = ops.rule_match(*args, num_items=i)
    want = ops.rule_match(*args, num_items=i, impl="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, again)


def test_rule_match_padding_inert(cuda):
    baskets, ante, lengths, cons, scores = _rule_problem((20, 64, 40), seed=9)
    w = packed_words(64)
    z = torch.zeros((12, w), dtype=torch.int32, device=cuda)
    out = ops.rule_match(_words(baskets, cuda), z, torch.full((12,), -1, dtype=torch.int32, device=cuda),
                         z, torch.zeros(12, device=cuda), num_items=64)
    assert torch.count_nonzero(out) == 0
    out = ops.rule_match(torch.zeros((8, w), dtype=torch.int32, device=cuda), _words(ante, cuda),
                         torch.from_numpy(lengths).to(cuda), _words(cons, cuda),
                         torch.from_numpy(scores).to(cuda), num_items=64)
    assert torch.count_nonzero(out) == 0


# (B, I, R): W = 1, 9, 10, 32 and 35 with R past the kernel's 1,024-rule
# chunk, then W = 157 and 782, which take 3 and 13 item windows of 64
# words; W = 1,329 and 2,188 (F4: wider than one block's shared memory
# held before the windows), the second with item ids past 65,535
ORDERED_SHAPES = RULE_SHAPES + [(64, 20, 40), (64, 280, 300), (64, 300, 1030), (1024, 1000, 2500),
                                (64, 1100, 1030), (16, 5000, 300), (8, 25000, 100),
                                (8, 42528, 300), (8, 70000, 300)]


def _ghost_rows(problem, seed):
    """Rows with len = -1 that keep their bits and score; every 5th basket zero."""
    baskets, ante, lengths, cons, scores = problem
    rng = np.random.default_rng(seed)
    ghost = rng.choice(np.flatnonzero(lengths >= 0), max(1, len(lengths) // 10), replace=False)
    lengths[ghost] = -1
    baskets[::5] = 0
    return baskets, ante, lengths, cons, scores


def _on(problem, dev):
    return [torch.from_numpy(x).to(dev) if x.dtype != np.uint32 else _words(x, dev) for x in problem]


@pytest.mark.parametrize("shape", ORDERED_SHAPES)
@pytest.mark.parametrize("case", ["random", "padding", "all_match"])
def test_rule_match_kernel_bit_equal_to_ordered(cuda, shape, case):
    """K2 returns exactly the bits of ref.rule_match_ordered: the ascending-r
    fp32 sum, with len = -1 rows holding bits, zero baskets, and baskets
    holding every item (every real rule matches)."""
    from repro_torch.kernels import ref

    problem = _rule_problem(shape, seed=sum(shape) + 1)
    if case == "padding":
        problem = _ghost_rows(problem, seed=sum(shape))
    elif case == "all_match":
        problem = _ghost_rows(problem, seed=sum(shape))
        problem = (pack_bits(np.ones((problem[0].shape[0], shape[1]), np.int8)),) + problem[1:]
    args = _on(problem, cuda)
    before = ops.launch_counts()["rule_match"]
    got = ops.rule_match(*args)
    want = ref.rule_match_ordered(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rule_match"] == before + 1
    assert torch.equal(got, want)
    torch.testing.assert_close(got, ops.rule_match(*args, impl="ref"), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [s for s in ORDERED_SHAPES if packed_words(s[1]) > 4])
def test_rule_match_kernel_wide_rules(cuda, shape):
    """Rules whose antecedent or consequent holds bits in more than the four
    words the kernel compacts are read whole from the rulebook: still bit for
    bit rule_match_ordered."""
    from repro_torch.kernels import ref

    b, i, r = shape
    rng = np.random.default_rng(sum(shape))
    baskets = pack_bits((rng.random((b, i)) < 0.7).astype(np.int8))
    baskets[::3] = pack_bits(np.ones((1, i), np.int8))

    def sets(lo, hi):
        return np.stack([itemsets_to_packed(np.sort(rng.choice(i, rng.integers(lo, hi + 1), replace=False))[None], i)[0]
                         for _ in range(r)])

    ante, cons = np.where((rng.random(r) < 0.5)[:, None], sets(5, 8), sets(1, 3)), sets(1, 8)
    lengths = np.array([sum(bin(int(x)).count("1") for x in row) for row in ante], np.int32)
    lengths[rng.random(r) < 0.1] = -1
    args = _on((baskets, ante, lengths, cons, rng.random(r).astype(np.float32)), cuda)
    got = ops.rule_match(*args)
    want = ref.rule_match_ordered(*args)
    torch.cuda.synchronize()
    assert torch.count_nonzero(want) > 0
    assert torch.equal(got, want)


def test_rule_match_kernel_unstaged_baskets(cuda):
    """At 1,500,000 items (46,875 words, 733 windows) the kernel reads each
    basket's words from global memory, as at every width past one window:
    still bit for bit rule_match_ordered, with padding rows."""
    from repro_torch.kernels import ref

    args = _on(_ghost_rows(_rule_problem((4, 1_500_000, 64), seed=15), seed=16), cuda)
    got = ops.rule_match(*args)
    want = ref.rule_match_ordered(*args)
    torch.cuda.synchronize()
    assert torch.count_nonzero(want) > 0
    assert torch.equal(got, want)


def test_recommend_rows_independent_of_batch_size(cuda):
    """recommend at batch 1,024 and at batch 256 gives the same score bits
    for the same 2,048 baskets."""
    from repro_torch.core.apriori import AprioriConfig, mine
    from repro_torch.data.synthetic import QuestConfig, gen_transactions
    from repro_torch.serving.recommend import recommend
    from repro_torch.serving.rulebook import compile_rulebook, place_rulebook

    db = gen_transactions(QuestConfig(num_transactions=4000, num_items=200, avg_len=10, seed=7))
    res = mine(db, AprioriConfig(min_support=0.01, max_k=4, representation="packed"))
    rb = place_rulebook(compile_rulebook(res, min_confidence=0.2, num_items=200))
    big = recommend(rb, db[:2048], top_k=10, batch_size=1024)
    small = recommend(rb, db[:2048], top_k=10, batch_size=256)
    assert np.array_equal(big.scores.view(np.uint32), small.scores.view(np.uint32))
    assert np.array_equal(big.items, small.items)


def test_chain_through_kernels(cuda):
    from repro_torch.core.apriori import AprioriConfig, mine
    from repro_torch.data.synthetic import QuestConfig, gen_transactions
    from repro_torch.serving.recommend import recommend, recommend_python
    from repro_torch.serving.rulebook import compile_rulebook, place_rulebook

    db = gen_transactions(QuestConfig(num_transactions=2000, num_items=96, avg_len=8, seed=5))
    cfg = AprioriConfig(min_support=0.03, max_k=4, representation="packed")
    res = mine(db, cfg)
    cpu = mine(db, cfg, device="cpu")
    assert res.as_dict() == cpu.as_dict()
    rb = place_rulebook(compile_rulebook(res, min_confidence=0.4, num_items=96))
    before = ops.launch_counts()["rule_match"]
    out = recommend(rb, db[:300], top_k=5, batch_size=128)
    assert ops.launch_counts()["rule_match"] == before + 3
    want = recommend_python(rb, db[:300], top_k=5)
    np.testing.assert_allclose(out.scores, want.scores, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------- out of core ---
def _stream_db(n=20_000, i=300, seed=21):
    rng = np.random.default_rng(seed)
    return (rng.random((n, i)) < 0.05).astype(np.int8)


def _stream_cands(i=300, seed=22):
    rng = np.random.default_rng(seed)
    pairs = np.sort(rng.choice(i, size=(3000, 2)), axis=1)
    triples = np.sort(rng.choice(i, size=(700, 3)), axis=1)
    return [pairs.astype(np.int32), triples.astype(np.int32)]


def _in_memory_counts(db, cands, cfg, dev):
    from repro_torch.core import apriori

    t_dev = apriori.place_db(db, cfg, dev)
    return apriori._count_level(apriori.make_count_step(cfg), t_dev, cands, db.shape[1], cfg)


@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_pipeline_chunks_equal_host_chunks(cuda, prefetch):
    """Every chunk the pinned pipeline hands out equals its host array, read
    on the consumer's stream right after it arrives, while the next copies
    out of the ring of pinned buffers are in flight."""
    from repro_torch.data.pipeline import ShardedBatchIterator

    rng = np.random.default_rng(prefetch)
    host = [rng.integers(-2**31, 2**31 - 1, size=(4096, 32), dtype=np.int32) for _ in range(64)]
    with ShardedBatchIterator(iter(host), cuda, prefetch=prefetch) as it:
        got = [chunk.sum(dtype=torch.int64) for chunk in it]
    want = [int(h.sum(dtype=np.int64)) for h in host]
    assert [int(g) for g in got] == want


@pytest.mark.parametrize("prefetch", [1, 2, 4])
@pytest.mark.parametrize("representation", ["packed", "dense"])
def test_streamed_counts_equal_kernel_counts(cuda, tmp_path, prefetch, representation):
    """Every streamed count, through the pinned pipeline and K1 / K3 at
    chunk shapes, equals the in-memory kernel count of the same candidates."""
    from repro_torch.core import streaming
    from repro_torch.core.apriori import AprioriConfig
    from repro_torch.data.store import ingest_dense

    db = _stream_db()
    store = ingest_dense(db, str(tmp_path / "db"), shard_rows=4_500)
    cfg = AprioriConfig(representation=representation, candidate_pad=256)
    for cands in _stream_cands():
        want = _in_memory_counts(db, cands, cfg, cuda)
        kernel = "support_count_packed" if representation == "packed" else "support_count"
        before = ops.launch_counts()[kernel]
        got = streaming.count_supports_streamed(store, cands, cfg, device=cuda, chunk_rows=1_000,
                                                prefetch=prefetch)
        np.testing.assert_array_equal(got, want)
        assert ops.launch_counts()[kernel] - before == 20


def test_pipeline_close_mid_pass_then_fresh_pass(cuda, tmp_path):
    """close() in the middle of a pass, with copies in flight, joins the
    worker and waits for the copies; a fresh pass then counts right."""
    from repro_torch.core import streaming
    from repro_torch.core.apriori import AprioriConfig
    from repro_torch.data.pipeline import ShardedBatchIterator
    from repro_torch.data.store import ingest_dense

    db = _stream_db()
    store = ingest_dense(db, str(tmp_path / "db"), shard_rows=4_500)
    big = (np.full((1 << 16, 64), v, dtype=np.int32) for v in range(1_000))
    it = ShardedBatchIterator(big, cuda, prefetch=4)
    first = next(it)
    assert int(first[0, 0]) == 0
    it.close()
    assert not it._thread.is_alive()
    assert list(it) == []
    cfg = AprioriConfig(representation="packed")
    cands = _stream_cands()[0]
    got = streaming.count_supports_streamed(store, cands, cfg, device=cuda, chunk_rows=777)
    np.testing.assert_array_equal(got, _in_memory_counts(db, cands, cfg, cuda))


@pytest.mark.parametrize("rows", [1, 127, 6_000, 8_192])
@pytest.mark.parametrize("operand_dtype", ["bf16", "int8"])
def test_k3_at_chunk_rows(cuda, rows, operand_dtype):
    """K3 on a streamed chunk's operand (packed words unpacked on the card
    by ``place_words``) at chunk row counts that are not multiples of its
    256-row tile, against its plain version."""
    from repro_torch.core import apriori
    from repro_torch.kernels import support_count as k3

    rng = np.random.default_rng(rows)
    t = (rng.random((rows, 1000)) < 0.3).astype(np.int8)
    if rows > 1:
        t[-1] = 0   # a zero-padded row
    _, c, lengths = _dense_problem((1, 1000, 3000), seed=rows)
    cfg = apriori.AprioriConfig(operand_dtype=operand_dtype)
    x = apriori.place_words(_words(pack_bits(t), cuda), 1000, cfg)
    assert x.shape == (rows, 1024) and x.dtype == k3.DTYPES[operand_dtype][1]
    cc = torch.from_numpy(np.pad(c, ((0, 0), (0, 24)))).to(cuda).to(x.dtype)
    ln = torch.from_numpy(lengths).to(cuda)
    got = ops.support_count(x, cc, ln, operand_dtype=operand_dtype, impl="kernel")
    want = ops.support_count(x, cc, ln, impl="ref")
    assert torch.equal(got, want)


def test_device_packing_and_unpacking_byte_equal(cuda):
    """Item (a) on the card: the packed ``place_db`` equals host
    ``pack_bits``; ``unpack_bits_device`` inverts it at I = 1, 31, 33, 1000."""
    from repro_torch.core import apriori
    from repro_torch.core.itemsets import unpack_bits

    for i in (1, 31, 33, 1000):
        db = (np.random.default_rng(i).random((3000, i)) < 0.4).astype(np.int8)
        words = apriori.place_db(db, apriori.AprioriConfig(representation="packed"), cuda)
        assert np.array_equal(words.cpu().numpy().view(np.uint32), pack_bits(db))
        assert np.array_equal(ops.unpack_bits_device(words, i).cpu().numpy(),
                              unpack_bits(pack_bits(db), i))


def test_streamed_mines_through_kernels(cuda, tmp_path):
    """mine_streamed (packed, dense), mine_son_streamed through the retrying
    executor with two mapper threads, and a resumed mine are dict-identical
    to the in-memory mine on the card."""
    from repro_torch.core import streaming
    from repro_torch.core.apriori import AprioriConfig, mine
    from repro_torch.data.store import ingest_quest
    from repro_torch.data.synthetic import QuestConfig, gen_transactions
    from repro_torch.distributed.fault_tolerance import FaultConfig

    qcfg = QuestConfig(num_transactions=6000, num_items=120, avg_len=8, seed=5)
    store = ingest_quest(qcfg, str(tmp_path / "db"), shard_rows=1_500)
    want = mine(gen_transactions(qcfg), AprioriConfig(min_support=0.02, max_k=4), device="cpu").as_dict()
    for rep in ("packed", "dense"):
        cfg = AprioriConfig(min_support=0.02, max_k=4, representation=rep)
        assert streaming.mine_streamed(store, cfg, chunk_rows=1_000).as_dict() == want
        son = streaming.mine_son_streamed(store, cfg, chunk_rows=1_000, fault=FaultConfig(max_workers=2))
        assert son.as_dict() == want and son.fault_report.completed == 4
        streaming.mine_streamed(store, cfg, chunk_rows=1_000, checkpoint=True, checkpoint_every_chunks=2)
        resumed = streaming.mine_streamed(store, cfg, chunk_rows=1_000, checkpoint=True,
                                          checkpoint_every_chunks=2, resume=True)
        assert resumed.as_dict() == want
