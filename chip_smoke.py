"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
against its plain PyTorch version on the card (K1 packed and K3 dense
support counting exactly, K1 also on its edges, over row slabs and against
its plain bitmap count, K3 in both operand dtypes and against K1's counts;
K2 rule matching within rtol=1e-5, atol=1e-6 of the plain version and bit
for bit equal to ``ref.rule_match_ordered``, its ordered-sum contract, also
on a batch where every rule matches and, ``[k2-wide]``, on rulebooks of
42,528 and 70,000 items), times them, then drives three paths
through the port's entry points at the
FIMI T10I4D100K shape, each with the launch counts set to 0 just before it
and read just after:

* ``[main]``: packed ``mine`` -> ``compile_rulebook`` -> ``place_rulebook``
  -> ``recommend`` (K1, K2), checked against the plain path and the Python
  oracle;
* ``[main-dense]``: ``mine`` at the default dense bf16 config (K3),
  dict-identical to the packed mine and to the plain dense mine;
* ``[son]``: ``mine_son`` over 8 partitions, dense (K3 in both phases),
  dict-identical to the level-wise mine, with K3's device time by CUDA
  events;

then the out-of-core paths over the same DB, ingested into an on-disk store
of 8 shards (``[store]``), each dict-identical to its in-memory twin with
exact launch counts:

* ``[stream]``: the packed ``mine_streamed`` through K1 at 8,192-row chunks,
  with its breakdown (prefetch stall, count dispatch, host sync, K1 device
  time);
* ``[serve-chain]``: ``compile_rulebook`` on that result, then ``recommend``
  of the store's first 4,096 packed rows through K2, bit for bit the
  in-memory chain's;
* ``[stream-dense]``: the dense bf16 ``mine_streamed`` through K3 at
  6,000-row chunks, unpacked on the card;
* ``[stream-son]``: ``mine_son_streamed`` over the 8 shards through the
  retrying phase-1 executor, K3 in both phases;
* ``[stream-resume]``: a checkpointed packed ``mine_streamed`` stopped after
  its third save, mid-level, then resumed.

Any failed check raises, and the script exits non-zero.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launches, errors and times.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")

# Published H100 SXM rates (NVIDIA data sheet, 700 W): HBM bandwidth and the
# fp32 rate outside the tensor cores.  The int32 rate is the same data
# sheet's SM count and boost clock with 64 int32 lanes per SM (half the 128
# fp32 lanes behind the 67 TFLOP/s figure): 132 x 64 x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT32_OP_PER_S = 132 * 64 * 1.98e9
# Dense tensor-core rates of the same data sheet (no sparsity): bf16 with
# fp32 accumulation, and int8.
BF16_TC_FLOP_PER_S = 989e12
INT8_TC_OP_PER_S = 1979e12
TC_RATES = {"bf16": BF16_TC_FLOP_PER_S, "int8": INT8_TC_OP_PER_S}

RTOL, ATOL = 1e-5, 1e-6
# The row-layout K1 that the item bitmaps replaced (one candidate per
# thread, every word tested; commit ffc206a and before) at the level-2
# pass, ms: the range of PERF.md's K1 row (H100 80GB HBM3, 700 W), printed
# beside this run's time
ROW_LAYOUT_K1_MS = {"and_cmp": (17.421, 17.596), "popcount": (53.493, 54.160)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alternate(plain, kernel, kernel_reps: int, plain_reps: int = 1):
    """Warm both, then time plain / kernel / kernel / plain; mean of each."""
    plain()
    kernel()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain, plain_reps)
    k1 = cuda_ms(kernel, kernel_reps)
    k2 = cuda_ms(kernel, kernel_reps)
    p2 = cuda_ms(plain, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(byte_count: float, ops_ms: float):
    """(bound_ms, bound_by): the larger of the bytes' time at the HBM rate
    and the operations' time."""
    bytes_ms = byte_count / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def words(x: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32).view(np.int32)).to(dev)


# ------------------------------------------------------------ problems -------
def count_problem(n, i, k, seed):
    """Random packed (transactions, candidates, lengths), as in the JAX
    package's kernel tests, with some len = -1 padding rows."""
    from repro_torch.core.itemsets import pack_bits

    rng = np.random.default_rng(seed)
    t = (rng.random((n, i)) < 0.3).astype(np.int8)
    sizes = rng.integers(1, min(6, i) + 1, size=k)
    c = np.zeros((k, i), np.int8)
    for row, s in enumerate(sizes):
        c[row, rng.choice(i, size=s, replace=False)] = 1
    lengths = c.sum(1).astype(np.int32)
    pad = rng.random(k) < 0.1
    c[pad], lengths[pad] = 0, -1
    return pack_bits(t), pack_bits(c), lengths


def rule_problem(b, i, r, seed):
    """Random (baskets, antecedents, lengths, consequents, scores) with 20%
    padding rules (zero words, len = -1, score 0)."""
    from repro_torch.core.itemsets import itemsets_to_packed, pack_bits

    rng = np.random.default_rng(seed)
    baskets = pack_bits((rng.random((b, i)) < 0.3).astype(np.int8))
    na = rng.integers(1, min(4, i) + 1, r)
    nc = rng.integers(1, min(3, i) + 1, r)
    ante = np.concatenate([itemsets_to_packed(np.sort(rng.choice(i, m, replace=False))[None], i) for m in na])
    cons = np.concatenate([itemsets_to_packed(np.sort(rng.choice(i, m, replace=False))[None], i) for m in nc])
    lengths = na.astype(np.int32)
    scores = rng.random(r).astype(np.float32)
    pad = rng.choice(r, max(1, r // 5), replace=False)
    ante[pad], cons[pad], lengths[pad], scores[pad] = 0, 0, -1, 0
    return baskets, ante, lengths, cons, scores


# -------------------------------------------------------------- phases -------
def k1_edge_problem(n, seed):
    """K1's edges over 1,300 items (41 words) and n rows: 96 candidates, two
    of them empty (len 0 and len 3), the rest of 1, 4, 9, 40, 2 or 3 items
    taken from one row's items; every 7th len = -1 keeping its bits, every
    5th / 6th / 11th a length one below / one above its item count / 0
    (popcount counts the rows holding exactly that many of its items).
    The card tests, the CPU tests and tools/k1_variants.py take it from here."""
    from repro_torch.core.itemsets import pack_bits

    rng = np.random.default_rng(seed)
    i = 1300
    t = (rng.random((n, i)) < 0.3).astype(np.int8)
    sizes = [1, 4, 9, 40, 2, 3]
    c = np.zeros((96, i), np.int8)
    for row in range(2, 96):
        held = np.flatnonzero(t[rng.integers(n)])
        c[row, rng.choice(held, size=min(sizes[row % 6], held.size), replace=False)] = 1
    lengths = c.sum(1).astype(np.int32)
    lengths[1] = 3
    lengths[5::5] = np.maximum(lengths[5::5] - 1, 0)
    lengths[6::6] += 1
    lengths[11::11] = 0
    lengths[7::7] = -1
    return pack_bits(t), pack_bits(c), lengths


def k1_sweep(ops, dev):
    """The sweep shapes, then K1's edges (N = 1, 77, 1,000) against the
    plain row-layout version and the plain bitmap count, then 4,100 rows
    through 5 row slabs of a capped scratch; both modes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import support_count_packed as k1

    shapes = [(8, 16, 4), (100, 64, 33), (256, 128, 128), (300, 130, 257), (512, 512, 300),
              (200, 1100, 70)]
    for mode in ("and_cmp", "popcount"):
        for n, i, k in shapes:
            tp, cp, ln = count_problem(n, i, k, seed=n + i + k)
            t, c, l_ = words(tp, dev), words(cp, dev), torch.from_numpy(ln).to(dev)
            got = ops.support_count_packed(t, c, l_, mode=mode, impl="kernel")
            want = ops.support_count_packed(t, c, l_, mode=mode, impl="ref")
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K1 {mode} {(n, i, k)}: counts differ from the plain version")
        for n in (1, 77, 1000):
            tp, cp, ln = k1_edge_problem(n, seed=n)
            t, c, l_ = words(tp, dev), words(cp, dev), torch.from_numpy(ln).to(dev)
            got = ops.support_count_packed(t, c, l_, mode=mode, impl="kernel")
            want = ops.support_count_packed(t, c, l_, mode=mode, impl="ref")
            bitmap = ref.support_count_bitmaps(ref.item_bitmaps(t), c, l_, n, mode)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(got, bitmap)):
                raise AssertionError(f"K1 {mode} edges at N={n}: counts differ from the plain versions")
            if int(got[0]) != n or int(got[1]) != (n if mode == "and_cmp" else 0):
                raise AssertionError(f"K1 {mode} edges at N={n}: empty candidates count {got[:2].tolist()}")
        tp, cp, ln = k1_edge_problem(4100, seed=4)
        t, c, l_ = words(tp, dev), words(cp, dev), torch.from_numpy(ln).to(dev)
        cap, k1.SCRATCH_CAP = k1.SCRATCH_CAP, 128 * t.shape[1] * 32  # one slab of 1,024 rows
        try:
            got = k1.launch(t, c, l_, mode)
        finally:
            k1.SCRATCH_CAP = cap
        if not torch.equal(got, ops.support_count_packed(t, c, l_, mode=mode, impl="ref")):
            raise AssertionError(f"K1 {mode} over 5 row slabs: counts differ from the plain version")
    log(f"[k1] sweep: {2 * len(shapes)} cases exactly equal to the plain version (both modes); edges "
        "(N = 1, 77, 1000; empty candidates with len 0 and 3, len = -1 rows keeping bits, 1, 4, 9 and "
        "40 items, popcount lengths below and above the item count) exactly equal to the plain version "
        "and the plain bitmap count; 4,100 rows over 5 row slabs exact")


def k1_main_shape(ops, t_dev, cands, num_items, dev, card):
    """K1 at the main path's level-2 pass: the DB against the level-2
    candidates padded to their bucket, both modes, timed."""
    from repro_torch.core.itemsets import itemsets_to_packed
    from repro_torch.kernels import ref

    kp = 1
    while kp < max(256, cands.shape[0]):
        kp *= 2
    c_host = np.zeros((kp, t_dev.shape[1]), np.uint32)
    c_host[: cands.shape[0]] = itemsets_to_packed(cands, num_items)
    ln = np.full(kp, -1, np.int32)
    ln[: cands.shape[0]] = cands.shape[1]
    c, l_ = words(c_host, dev), torch.from_numpy(ln).to(dev)
    n, w = t_dev.shape
    out = {}
    for mode in ("and_cmp", "popcount"):
        got = ops.support_count_packed(t_dev, c, l_, mode=mode, impl="kernel")
        want = ops.support_count_packed(t_dev, c, l_, mode=mode, impl="ref")
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1 {mode} at N={n} Kp={kp} W={w}: counts differ from the plain version")
        ms, plain_ms = alternate(
            lambda: ops.support_count_packed(t_dev, c, l_, mode=mode, impl="ref"),
            lambda: ops.support_count_packed(t_dev, c, l_, mode=mode, impl="kernel"),
            kernel_reps=5,
        )
        dense_tests = n * kp * w
        live = l_ >= 0
        needed_tests = n * int(((c != 0).sum(1) * live).sum().item())
        # the bitmap count: an AND per candidate item per 32 rows, and a
        # popc (a quarter of the int32 rate) per candidate per 32 rows
        nb = -(-n // 32)
        items = int((ref.popcount32(c).sum(1) * live).sum().item())
        bitmap_ops = items * nb + 4 * int(live.sum().item()) * nb
        byte_count = 4 * (n * w + kp * w + kp + kp)
        bound_ms, bound_by = bound(byte_count, bitmap_ops / INT32_OP_PER_S * 1e3)
        out[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         max_abs_err=float((got - want).abs().max().item()))
        lo, hi = ROW_LAYOUT_K1_MS[mode]
        log(f"[k1] {mode} N={n} Kp={kp} W={w}: exact; kernel {ms:.3f} ms (the row-layout design {lo}-{hi} ms in "
            f"PERF.md: {lo / ms:.1f}x), plain {plain_ms:.1f} ms; bitmap bound {bound_ms:.4f} ms ({bound_by}: "
            f"{items * nb:.3e} item-word ANDs and {int(live.sum().item()) * nb:.3e} popc, 4 op each, over {nb} "
            f"bitmap words at {INT32_OP_PER_S:.3e} int32 op/s, {byte_count:.3e} B); word-test bound "
            f"{needed_tests / INT32_OP_PER_S * 1e3:.4f} ms ({needed_tests:.3e} word tests on candidate words "
            f"that hold a bit); dense-count bound {dense_tests / INT32_OP_PER_S * 1e3:.3f} ms "
            f"({dense_tests:.3e} = N*Kp*W word tests) [{card}]")
    return out, got   # the counts, the same in both modes


def k2_check(ops, args, what: str, num_items=None):
    """K2 on ``args``: bit-identical across two runs and to the ordered
    plain version (``ref.rule_match_ordered``), and within RTOL / ATOL of the
    plain version.  Returns (kernel output, the plain version's)."""
    from repro_torch.kernels import ref

    got = ops.rule_match(*args, num_items=num_items, impl="kernel")
    again = ops.rule_match(*args, num_items=num_items, impl="kernel")
    want = ops.rule_match(*args, num_items=num_items, impl="ref")
    ordered = ref.rule_match_ordered(*args)[:, : got.shape[1]]
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    if not torch.equal(got, again):
        raise AssertionError(f"K2 {what}: two runs differ")
    if not torch.equal(got, ordered):
        raise AssertionError(f"K2 {what}: not bit-identical to rule_match_ordered")
    return got, want


def k2_sweep(ops, dev):
    from repro_torch.core.itemsets import itemsets_to_packed, pack_bits

    # the shapes of tests/test_rule_match.py, then W = 9, 10 and 35 with R
    # past the kernel's 1,024-rule chunk, and W = 157 and 782, where a block
    # holds 4 baskets and 1
    shapes = [(8, 16, 4), (100, 37, 33), (64, 96, 300), (33, 130, 257), (16, 31, 128),
              (64, 280, 300), (64, 300, 1030), (64, 1100, 1030), (16, 5000, 300), (8, 25000, 100)]
    for b, i, r in shapes:
        bk, a, ln, c, s = rule_problem(b, i, r, seed=b + i + r)
        args = (words(bk, dev), words(a, dev), torch.from_numpy(ln).to(dev), words(c, dev),
                torch.from_numpy(s).to(dev))
        k2_check(ops, args, str((b, i, r)), num_items=i)
    # all-padding rules and zero baskets score zero
    bk, a, ln, c, s = rule_problem(20, 64, 40, seed=9)
    w = bk.shape[1]
    z = torch.zeros((12, w), dtype=torch.int32, device=dev)
    out, _ = k2_check(ops, (words(bk, dev), z, torch.full((12,), -1, dtype=torch.int32, device=dev), z,
                            torch.zeros(12, device=dev)), "all-padding rules", num_items=64)
    out2, _ = k2_check(ops, (torch.zeros((8, w), dtype=torch.int32, device=dev), words(a, dev),
                             torch.from_numpy(ln).to(dev), words(c, dev), torch.from_numpy(s).to(dev)),
                       "zero baskets", num_items=64)
    if torch.count_nonzero(out) or torch.count_nonzero(out2):
        raise AssertionError("K2: padding rules or zero baskets scored non-zero")
    # rows with len = -1 that keep their bits and score, among zero baskets
    bk, a, ln, c, s = rule_problem(64, 300, 1030, seed=11)
    ln[np.random.default_rng(11).choice(np.flatnonzero(ln >= 0), 100, replace=False)] = -1
    bk[::5] = 0
    out, _ = k2_check(ops, (words(bk, dev), words(a, dev), torch.from_numpy(ln).to(dev), words(c, dev),
                            torch.from_numpy(s).to(dev)), "len = -1 rows holding bits", num_items=300)
    if torch.count_nonzero(out[::5]):
        raise AssertionError("K2: zero baskets scored non-zero")
    # half the antecedents and most consequents hold bits in more than the
    # four words the kernel compacts
    rng = np.random.default_rng(12)
    bk = pack_bits((rng.random((64, 300)) < 0.7).astype(np.int8))
    bk[::3] = pack_bits(np.ones((1, 300), np.int8))
    wide = np.concatenate([itemsets_to_packed(np.sort(rng.choice(300, m, replace=False))[None], 300)
                           for m in rng.integers(5, 9, 1030)])
    a = np.where((rng.random(1030) < 0.5)[:, None], wide, a)
    c = np.concatenate([itemsets_to_packed(np.sort(rng.choice(300, m, replace=False))[None], 300)
                        for m in rng.integers(1, 9, 1030)])
    ln = np.array([sum(bin(int(x)).count("1") for x in row) for row in a], np.int32)
    ln[rng.random(1030) < 0.1] = -1
    k2_check(ops, (words(bk, dev), words(a, dev), torch.from_numpy(ln).to(dev), words(c, dev),
                   torch.from_numpy(s).to(dev)), "rules holding bits in more than four words", num_items=300)
    log(f"[k2] sweep: {len(shapes)} shapes within rtol={RTOL} atol={ATOL}, bit-identical across runs "
        "and to rule_match_ordered (torch.equal); all-padding rules, zero baskets, len = -1 rows "
        "holding bits and rules wider than four words likewise, the padding inert")


def k2_wide(ops, dev, card):
    """K2 past the width one block held before its item windows (F4): 8
    baskets over 42,528 and 70,000 items (1,329 and 2,188 words, the second
    with item ids past 65,535, kept in far slots), and over 1,500,000
    items (46,875 words, 733 windows),
    against 300 rules, bit for bit ``rule_match_ordered``; timed."""
    for i in (42_528, 70_000, 1_500_000):
        bk, a, ln, c, s = rule_problem(8, i, 300, seed=i)
        args = (words(bk, dev), words(a, dev), torch.from_numpy(ln).to(dev), words(c, dev),
                torch.from_numpy(s).to(dev))
        got, _ = k2_check(ops, args, f"(8, {i}, 300)", num_items=i)
        far = int((words(a, dev)[:, 2048:] != 0).any(1).sum().item()) if a.shape[1] > 2048 else 0
        ms = cuda_ms(lambda: ops.rule_match(*args, impl="kernel"), 5)
        log(f"[k2-wide] B=8 I={i} W={a.shape[1]} R=300: within rtol={RTOL} atol={ATOL} of the plain "
            f"version, bit-identical across runs and to rule_match_ordered; {far} antecedents hold an item "
            f"past 65,535 (far slots), {int(torch.count_nonzero(got).item())} non-zero scores; kernel {ms:.4f} ms [{card}]")


def k2_main_shape(ops, rb, b_words, dev, card):
    """K2 at the main path's batch: 1024 baskets against the mined rulebook,
    then 1024 baskets that hold every item."""
    from repro_torch.core.itemsets import pack_bits
    from repro_torch.kernels import ref

    b = words(b_words, dev)
    args = (b, rb.ante_packed, rb.ante_len, rb.cons_packed, rb.scores)
    t0 = time.perf_counter()
    got, want = k2_check(ops, args, "main shape")
    check_s = time.perf_counter() - t0
    ms, plain_ms = alternate(lambda: ops.rule_match(*args, impl="ref"),
                             lambda: ops.rule_match(*args, impl="kernel"), kernel_reps=20, plain_reps=3)
    nb, w = b.shape
    r = rb.ante_packed.shape[0]
    dense_flops = 2 * nb * r * 32 * w
    # what these inputs need: a word test per antecedent word that holds a
    # bit, and two flops per (matched rule, consequent item)
    valid = rb.ante_len >= 0
    needed_tests = nb * int(((rb.ante_packed != 0).sum(1) * valid).sum().item())
    cons_items = ref.popcount32(rb.cons_packed).sum(1).to(torch.float32)
    matched_items = 0.0
    per_basket = []
    for b0 in range(0, nb, 64):
        blk = b[b0 : b0 + 64]
        hit = ((blk[:, None, :] & rb.ante_packed[None]) == rb.ante_packed[None]).all(-1) & valid
        matched_items += float((hit.to(torch.float32) @ cons_items).sum().item())
        per_basket.append(hit.sum(1))
    per_basket = torch.cat(per_basket).to(torch.float64)
    needed_flops = 2 * matched_items
    byte_count = 4 * (nb * w + 2 * r * w + 2 * r + nb * 32 * w)
    ops_ms = max(needed_tests / INT32_OP_PER_S, needed_flops / FP32_FLOP_PER_S) * 1e3
    bound_ms, bound_by = bound(byte_count, ops_ms)
    err = float((got - want).abs().max().item())
    log(f"[k2] B={nb} R={r} W={w}: max |kernel - plain| {err:.3e}, bit-identical across runs and to "
        f"rule_match_ordered on all {nb} baskets (checks took {check_s:.1f} s); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms; matched rules per basket mean {per_basket.mean().item():.1f}, max "
        f"{int(per_basket.max().item())}; bound {bound_ms:.4f} ms ({bound_by}: "
        f"{byte_count:.3e} B, {needed_tests:.3e} antecedent word tests, {needed_flops:.3e} fan-out "
        f"flop of matched rules = {needed_flops / dense_flops:.2e} of the dense count); dense-count bound "
        f"{dense_flops / FP32_FLOP_PER_S * 1e3:.4f} ms ({dense_flops:.3e} = 2*B*R*32W fp32 flop at "
        f"{FP32_FLOP_PER_S:.2e}/s) [{card}]")

    # the worst case for a sparse fan-out: every basket holds every item, so
    # every real rule matches every basket
    full = words(pack_bits(np.ones((nb, rb.num_items), np.int8)), dev)
    all_args = (full, rb.ante_packed, rb.ante_len, rb.cons_packed, rb.scores)
    t0 = time.perf_counter()
    k2_check(ops, all_args, "all-match batch")
    check_s = time.perf_counter() - t0
    all_ms = cuda_ms(lambda: ops.rule_match(*all_args, impl="kernel"), 5)
    live = int(valid.sum().item())
    log(f"[k2] all-match B={nb} R={r} W={w}: all {live} real rules match each basket; within "
        f"rtol={RTOL} atol={ATOL} of the plain version, bit-identical across runs and to "
        f"rule_match_ordered on all {nb} baskets (checks took {check_s:.1f} s); kernel {all_ms:.4f} ms "
        f"(limit 17.6 ms) [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                all_match_ms=all_ms)


def dense_problem(n, i, k, seed):
    """Random dense (transactions, candidates, lengths) with every 7th row
    zero, some len = -1 padding rows that still hold bits, and, where K
    reaches 256, a whole 128-candidate tile of them."""
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


def k3_exact(ops, dev, t, c, ln, operand_dtype, what):
    """K3 on (t, c, lengths) with the item axis padded with zero columns to
    the kernel's width, as the dense placement pads it: exactly equal to its
    plain version.  Returns the counts."""
    from repro_torch.kernels import support_count as k3

    i = t.shape[1]
    dt = k3.DTYPES[operand_dtype][1]
    pad = ((0, 0), (0, k3.item_width(i) - i))
    tt = torch.from_numpy(np.pad(t, pad)).to(dev).to(dt)
    tc = torch.from_numpy(np.pad(c, pad)).to(dev).to(dt)
    l_ = torch.from_numpy(ln).to(dev)
    got = ops.support_count(tt, tc, l_, operand_dtype=operand_dtype, impl="kernel")
    want = ops.support_count(tt, tc, l_, impl="ref")
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"K3 {operand_dtype} {what}: counts differ from the plain version")
    return got


def k3_sweep(ops, dev):
    """The shapes of tests/test_kernels.py plus one with I > 1,024, then the
    kernel's edges: N = 1,000 (a ragged 256-row tile), item axes of 160 and
    1,120 (not multiples of the 128-byte TMA box), K = 600 (an all-padding
    tile in the middle, a ragged tail), N = 20,000 (several work units per
    persistent block) and K = 70,000 (two launch windows); and an empty
    candidate (len = 0), which counts N.  Both operand dtypes."""
    from repro_torch.kernels import support_count as k3

    shapes = [(8, 16, 4), (100, 64, 33), (256, 128, 128), (300, 130, 257), (512, 512, 300),
              (200, 1100, 70), (1000, 130, 600), (1000, 1100, 600), (20000, 1000, 3000), (300, 64, 70000)]
    for operand_dtype in k3.DTYPES:
        for n, i, k in shapes:
            k3_exact(ops, dev, *dense_problem(n, i, k, seed=n + i + k), operand_dtype, str((n, i, k)))
        t, c, ln = dense_problem(1000, 130, 600, seed=3)
        c[5], ln[5] = 0, 0
        got = k3_exact(ops, dev, t, c, ln, operand_dtype, "with an empty candidate")
        if int(got[5]) != 1000:
            raise AssertionError(f"K3 {operand_dtype}: the empty candidate counts {int(got[5])}, not N = 1000")
    log(f"[k3] sweep: {2 * len(shapes)} cases exactly equal to the plain version (bf16 and int8, "
        "zero rows, len = -1 rows, an all-padding candidate tile, ragged row, item and candidate edges, "
        "two launch windows); an empty candidate counts N in both dtypes")


def k3_main_shape(ops, db, cands, k1_counts, dev, card):
    """K3 at the main path's level-2 pass: the dense DB (placed by
    ``place_db``) against the level-2 candidates (placed by the main path's
    ``_place_candidates``), both operand dtypes: exact against the plain
    version and K1's counts, timed beside its bound and the bare product."""
    from repro_torch.core import apriori

    num_items = db.shape[1]
    kp = apriori._pad_bucket(cands.shape[0], apriori._candidate_quantum(apriori.AprioriConfig()))
    out = {}
    for operand_dtype in ("bf16", "int8"):
        cfg = apriori.AprioriConfig(operand_dtype=operand_dtype)
        t = apriori.place_db(db, cfg, dev)
        c, l_ = apriori._place_candidates(cands, kp, num_items, cfg, dev)
        got = ops.support_count(t, c, l_, operand_dtype=operand_dtype, impl="kernel")
        want = ops.support_count(t, c, l_, impl="ref")
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K3 {operand_dtype} at the main shape: counts differ from the plain version")
        if not torch.equal(got, k1_counts):
            raise AssertionError(f"K3 {operand_dtype} at the main shape: counts differ from K1's")
        ms, plain_ms = alternate(
            lambda: ops.support_count(t, c, l_, impl="ref"),
            lambda: ops.support_count(t, c, l_, operand_dtype=operand_dtype, impl="kernel"),
            kernel_reps=5,
        )
        n, ip = t.shape
        live = int((l_ >= 0).sum().item())
        # what this pass needs: the real candidates against the real items;
        # padding rows (len = -1) count 0 by definition, zero columns add 0
        op_count = 2 * n * live * num_items
        dense_ops = 2 * n * kp * ip
        byte_count = t.element_size() * (n + live) * num_items + 4 * (kp + kp)
        bound_ms, bound_by = bound(byte_count, op_count / TC_RATES[operand_dtype] * 1e3)
        out[operand_dtype] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                  max_abs_err=float((got - want).abs().max().item()))
        if operand_dtype == "bf16":
            prod = lambda: torch.matmul(t, c.T)  # noqa: E731  (the product alone; never on the port's path)
            prod()
            torch.cuda.synchronize()
            out["bf16"]["gemm_ms"] = cuda_ms(prod, 3)
        gemm_ms = out["bf16"]["gemm_ms"]
        extra = f", bf16 torch.matmul of the same operands {gemm_ms:.3f} ms" if operand_dtype == "bf16" else ""
        log(f"[k3] {operand_dtype} N={n} Kp={kp} Ip={ip}: exact, equal to K1's counts; kernel {ms:.3f} ms "
            f"= {ms / gemm_ms:.3f}x the bare bf16 product's time, plain {plain_ms:.1f} ms{extra}; "
            f"bound {bound_ms:.4f} ms ({bound_by}: {op_count:.3e} = "
            f"2*N*K*I operations for the {live} real candidates and {num_items} items at "
            f"{TC_RATES[operand_dtype]:.3e}/s, {byte_count:.3e} B) = {op_count / (ms * 1e-3) / 1e12:.1f} "
            f"T op/s achieved; dense-count bound {dense_ops / TC_RATES[operand_dtype] * 1e3:.3f} ms "
            f"({dense_ops:.3e} = 2*N*Kp*Ip) [{card}]")
        del t, c
    return out


class PhaseTimes:
    """Collects the miners' phase times by name and the streamed chunks
    (their ``obs`` hook)."""

    def __init__(self):
        self.seconds = {}
        self.chunks = 0

    def on_level_start(self, k, n):
        pass

    def on_level_end(self, k, n):
        pass

    def observe_max_candidate_bucket(self, kp):
        pass

    def add_phase(self, name, t0, t1):
        self.seconds[name] = self.seconds.get(name, 0.0) + t1 - t0

    def on_chunk(self, rows):
        self.chunks += 1

    @property
    def candidate_gen_s(self):
        return self.seconds.get("candidate_gen", 0.0)


class KernelEvents:
    """Within ``with``: every call of ``module.<attr>`` records a CUDA event
    pair around it on the current stream (from any thread); :meth:`ms` sums
    their device time.  The wrapped function still counts its launches."""

    def __init__(self, module, attr):
        self.module, self.attr, self.events = module, attr, []

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.attr)

        def timed(*args, **kwargs):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            self.events.append((e0, e1))
            return out

        setattr(self.module, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(e0.elapsed_time(e1) for e0, e1 in self.events)


def device_profile(run):
    """One call of ``run`` under ``torch.profiler`` (device activity only):
    (host wall s, {CUDA kernel or copy name: (device ms, count)})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, {e.key: (e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                  if e.device_time_total > 0}


def kernel_name(key: str) -> str:
    """A profiler key's CUDA function name, without template and arguments."""
    return key.removeprefix("void ").removeprefix("(anonymous namespace)::").split("(")[0].split("<")[0]


# the CUDA kernels of each wrapper's launch, by name
K1_KERNELS = ("candidate_meta_kernel", "bitmap_kernel", "count_kernel")
K3_KERNELS = ("support_count_kernel",)
K2_KERNELS = ("compact_rules_kernel", "rule_match_kernel")


def profiled_breakdown(tag, run, kernels, what, launches, card):
    """The streamed mine once more, warm, under the profiler: the device time
    of the wrapper's kernels (``kernels``), of the host -> device copies and
    of the rest, and the device's busy share of the wall.  Returns the
    wrapper's device ms a launch."""
    wall, times = device_profile(run)
    mine_ms = sum(ms for key, (ms, _) in times.items() if kernel_name(key) in kernels)
    h2d = sum(ms for key, (ms, _) in times.items() if "HtoD" in key)
    busy = sum(ms for ms, _ in times.values())
    log(f"[{tag}] profiled warm run {wall:.3f} s: {what} device time {mine_ms:.3f} ms over {launches} launches "
        f"= {mine_ms / launches:.4f} ms a chunk launch; host -> device copies {h2d:.3f} ms; other device work "
        f"{busy - mine_ms - h2d:.3f} ms; device busy {busy:.2f} ms = {busy / 1e3 / wall:.4f} of the wall [{card}]")
    for key, (ms, count) in sorted(times.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"[{tag}] profile: {key[:70]} {ms:.3f} ms over {count} [{card}]")
    return mine_ms / launches


def mine_breakdown(db, cfg, dev, card, kernel):
    """The mine again, through the same functions, with its phases timed:
    DB placement, candidate generation, counting (host wall of the passes,
    of which candidate placement on the host, and device time of the
    ``kernel`` launches by CUDA events)."""
    from repro_torch.core import apriori

    before = ""
    if cfg.representation == "packed":
        # the packed placement before it packed on the card: host pack_bits, then one copy
        from repro_torch.core.itemsets import pack_bits

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(pack_bits(db).view(np.int32)).to(dev)
        torch.cuda.synchronize()
        before = f" (host pack_bits and copy, as before the card packed: {time.perf_counter() - t0:.3f} s)"
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    t_dev = apriori.place_db(db, cfg, dev)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t_start
    step = apriori.make_count_step(cfg)
    events = []

    def timed_step(t, c, ln):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step(t, c, ln)
        e1.record()
        events.append((e0, e1))
        return out

    count_s = [0.0]
    place_c_s = [0.0]
    place_candidates = apriori._place_candidates

    def timed_place(*args):
        t0 = time.perf_counter()
        out = place_candidates(*args)
        place_c_s[0] += time.perf_counter() - t0
        return out

    def count_fn(cands, k):
        t0 = time.perf_counter()
        out = apriori._count_level(timed_step, t_dev, cands, db.shape[1], cfg)
        count_s[0] += time.perf_counter() - t0
        return out

    phases = PhaseTimes()
    apriori._place_candidates = timed_place
    try:
        apriori.run_level_loop(count_fn, db.shape[0], db.shape[1], cfg, obs=phases)
    finally:
        apriori._place_candidates = place_candidates
    wall = time.perf_counter() - t_start
    torch.cuda.synchronize()
    kernel_ms = sum(e0.elapsed_time(e1) for e0, e1 in events)
    log(f"[breakdown] {cfg.representation} mine wall {wall:.3f} s: place_db {place_s:.3f} s{before}, candidate "
        f"generation {phases.candidate_gen_s:.3f} s, counting passes {count_s[0]:.3f} s (of which "
        f"candidate placement on the host {place_c_s[0]:.3f} s; {kernel} device time {kernel_ms:.2f} ms "
        f"over {len(events)} launches), rest {wall - place_s - phases.candidate_gen_s - count_s[0]:.3f} s; "
        f"device busy with {kernel} {kernel_ms / 1e3 / wall:.4f} of the wall [{card}]")


def recommend_breakdown(rb, baskets, card):
    """The recommend call again, warm: basket packing on the host, then
    recommend on the packed baskets as it is (warm queries/s), then once
    more with its phases timed: each batch's H2D copy, match step (host wall,
    and K2's device time by CUDA events), top-k sort and D2H copy.  Each timed
    phase synchronises before and after, so the phases do not overlap."""
    from repro_torch.serving import recommend as rec_mod

    t0 = time.perf_counter()
    packed = rec_mod.pack_baskets(baskets, rb.num_items)
    pack_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec_mod.recommend(rb, packed, top_k=10, batch_size=1024, device=rb.device)
    warm_s = time.perf_counter() - t0

    step = rec_mod.make_match_step()
    events = []
    phase_s = {"h2d": 0.0, "match": 0.0, "topk": 0.0, "d2h": 0.0}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            phase_s[name] += time.perf_counter() - t
            return out
        return run

    def event_step(*args):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step(*args)
        e1.record()
        events.append((e0, e1))
        return out

    hooks = {"_to_device": "h2d", "_topk_items": "topk", "_to_host": "d2h"}
    originals = {attr: getattr(rec_mod, attr) for attr in hooks}
    for attr, name in hooks.items():
        setattr(rec_mod, attr, timed(name, originals[attr]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec_mod.recommend(rb, packed, top_k=10, batch_size=1024, device=rb.device,
                          match_step=timed("match", event_step))
        wall = time.perf_counter() - t0
    finally:
        for attr, fn in originals.items():
            setattr(rec_mod, attr, fn)
    kernel_ms = sum(e0.elapsed_time(e1) for e0, e1 in events)
    n = len(packed)
    rest = wall - sum(phase_s.values())
    log(f"[breakdown] recommend of {n} baskets: packing on the host {pack_s:.4f} s; warm recommend on "
        f"packed baskets {warm_s:.4f} s = {n / warm_s:.0f} queries/s ({n / (pack_s + warm_s):.0f} with "
        f"packing); phases, synchronised, {wall:.4f} s: H2D {phase_s['h2d']:.4f} s, match "
        f"{phase_s['match']:.4f} s (K2 device time {kernel_ms:.3f} ms over {len(events)} launches), "
        f"top-k sort {phase_s['topk']:.4f} s, D2H {phase_s['d2h']:.4f} s, rest {rest:.4f} s [{card}]")


def level_passes(res, num_items, cfg) -> dict:
    """k -> the candidate passes the level loop counts at level k for this
    result: one per ``max_candidates_per_pass`` slice of its candidates."""
    from repro_torch.core.candidates import generate_candidates

    passes = {1: math.ceil(num_items / cfg.max_candidates_per_pass)}
    for k in range(2, cfg.max_k + 1):
        prev = res.levels.get(k - 1)
        if prev is None or prev[0].shape[0] < k:
            break
        n_c = generate_candidates(prev[0]).shape[0]
        if n_c == 0:
            break
        passes[k] = math.ceil(n_c / cfg.max_candidates_per_pass)
        if k not in res.levels:
            break
    return passes


def expected_passes(res, num_items, cfg) -> int:
    """Candidate passes the level loop counts for this result."""
    return sum(level_passes(res, num_items, cfg).values())


# ------------------------------------------------------- out of core ---------
STORE_SHARD_ROWS = 12_500     # 8 shards: the in-memory SON's 8 partitions
STREAM_CHUNK_ROWS = 8_192     # 13 chunks a pass, the last 1,696 rows zero-padded
DENSE_CHUNK_ROWS = 6_000      # 17 chunks a pass; not a multiple of K3's 256-row tile


def store_phase(qcfg, db, root):
    """``[store]``: ``ingest_quest`` into an on-disk store of 8 shards of
    12,500 rows, byte-equal to the host packing of the generated DB."""
    from repro_torch.core.itemsets import pack_bits
    from repro_torch.data.store import ingest_quest

    t0 = time.perf_counter()
    store = ingest_quest(qcfg, os.path.join(root, "store"), shard_rows=STORE_SHARD_ROWS)
    ingest_s = time.perf_counter() - t0
    n = db.shape[0]
    if store.manifest.shard_rows != (STORE_SHARD_ROWS,) * (n // STORE_SHARD_ROWS):
        raise AssertionError(f"[store] shard rows {store.manifest.shard_rows}")
    packed = pack_bits(db)
    for p in range(store.num_partitions):
        if not np.array_equal(store.partition_packed(p), packed[p * STORE_SHARD_ROWS:(p + 1) * STORE_SHARD_ROWS]):
            raise AssertionError(f"[store] shard {p} differs from the packed DB")
    log(f"[store] ingest_quest {n} x {store.num_items} into {store.num_partitions} shards of "
        f"{STORE_SHARD_ROWS} rows ({store.manifest.words} words a row) in {ingest_s:.3f} s on the host; "
        "every shard byte-equal to the packed generated DB")
    return store


def stream_breakdown(tag, obs, wall, kernel, kernel_ms, launches, extra=""):
    phases = ", ".join(f"{name} {sec:.3f} s" for name, sec in sorted(obs.seconds.items()))
    log(f"[{tag}] wall {wall:.3f} s: {phases}, {obs.chunks} chunks; {kernel} by CUDA events around each "
        f"launch {kernel_ms:.2f} ms over {launches} launches = {kernel_ms / max(launches, 1):.4f} ms a chunk "
        f"launch, {kernel_ms / 1e3 / wall:.4f} of the wall (an event pair spans the launch's host-side "
        f"enqueue too, while the device waits for it){extra}")


def stream_phase(streaming, ops, store, cfg, res, mine_s, dev, card):
    """``[stream]``: the packed ``mine_streamed`` through K1 at 8,192-row
    chunks, dict-identical to the in-memory packed mine, K1 launched
    passes x 13 times; its breakdown."""
    n = store.num_transactions
    chunks = -(-n // STREAM_CHUNK_ROWS)
    passes = expected_passes(res, store.num_items, cfg)
    obs = PhaseTimes()
    ops.reset_launch_counts()
    with KernelEvents(ops, "support_count_packed") as k1_events:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = streaming.mine_streamed(store, cfg, device=dev, chunk_rows=STREAM_CHUNK_ROWS, obs=obs)
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()["support_count_packed"]
    k1_ms = k1_events.ms()
    log(f"[stream] packed mine_streamed {wall:.3f} s (in-memory packed mine {mine_s:.3f} s): {passes} passes x "
        f"{chunks} chunks of {STREAM_CHUNK_ROWS} rows (the last {n - (chunks - 1) * STREAM_CHUNK_ROWS} real, "
        f"zero-padded); launches {ops.launch_counts()} [{card}]")
    if launches != passes * chunks or obs.chunks != passes * chunks:
        raise AssertionError(f"[stream] K1 launched {launches} times ({obs.chunks} chunks) for "
                             f"{passes} passes x {chunks} chunks")
    if got.as_dict() != res.as_dict():
        raise AssertionError("[stream] mine_streamed differs from the in-memory packed mine")
    stream_breakdown("stream", obs, wall, "K1", k1_ms, launches, f" [{card}]")
    log(f"[stream] dict-identical to the in-memory packed mine ({len(got.as_dict())} itemsets)")
    ms = profiled_breakdown(
        "stream", lambda: streaming.mine_streamed(store, cfg, device=dev, chunk_rows=STREAM_CHUNK_ROWS),
        K1_KERNELS, "K1", launches, card)
    return got, dict(launches=launches, ms_per_launch=ms, event_ms_per_launch=k1_ms / launches)


def serve_chain_phase(ops, store, sres, rb_host, rec, dev, card):
    """``[serve-chain]``: compile the streamed result, then recommend the
    store's first 4,096 packed rows through K2; bit for bit the in-memory
    chain's recommend."""
    from repro_torch.serving.recommend import recommend
    from repro_torch.serving.rulebook import compile_rulebook, place_rulebook

    t0 = time.perf_counter()
    rb_s = compile_rulebook(sres, min_confidence=0.4, score="confidence", num_items=store.num_items)
    compile_s = time.perf_counter() - t0
    for col in ("ante_packed", "ante_len", "cons_packed", "scores"):
        if not np.array_equal(getattr(rb_s, col), getattr(rb_host, col)):
            raise AssertionError(f"[serve-chain] rulebook column {col} differs from the in-memory chain's")
    rb = place_rulebook(rb_s, dev)
    baskets, valid = next(iter(store.iter_chunks(4096, representation="packed")))
    ops.reset_launch_counts()
    with KernelEvents(ops, "rule_match") as k2_events:
        t0 = time.perf_counter()
        got = recommend(rb, baskets, top_k=10, batch_size=1024, device=dev)
        rec_s = time.perf_counter() - t0
    launches = ops.launch_counts()["rule_match"]
    k2_ms = k2_events.ms()
    batches = -(-valid // 1024)
    log(f"[serve-chain] compile {compile_s:.3f} s ({rb_s.num_rules} rules, the in-memory chain's rulebook); "
        f"recommend of the store's first {valid} packed rows {rec_s:.4f} s; K2 launched {launches} times, "
        f"device time {k2_ms:.3f} ms [{card}]")
    if launches != batches:
        raise AssertionError(f"[serve-chain] K2 launched {launches} times for {batches} batches")
    if not (np.array_equal(got.items, rec.items) and np.array_equal(got.scores, rec.scores)):
        raise AssertionError("[serve-chain] recommend on the store's rows differs from the in-memory chain's")
    log("[serve-chain] items and scores bit for bit the in-memory chain's recommend")
    ms = profiled_breakdown(
        "serve-chain", lambda: recommend(rb, baskets, top_k=10, batch_size=1024, device=dev),
        K2_KERNELS, "K2", launches, card)
    return dict(launches=launches, ms_per_launch=ms, event_ms_per_launch=k2_ms / launches)


def stream_dense_phase(streaming, apriori, ops, store, dense_cfg, dense_res, dev, card):
    """``[stream-dense]``: ``mine_streamed`` at the default dense bf16
    config through K3 at 6,000-row chunks (17 a pass), dict-identical to
    the in-memory dense mine, K3 launched passes x 17 times."""
    n = store.num_transactions
    chunks = -(-n // DENSE_CHUNK_ROWS)
    passes = expected_passes(dense_res, store.num_items, dense_cfg)
    obs = PhaseTimes()
    ops.reset_launch_counts()
    with KernelEvents(ops, "support_count") as k3_events, \
            KernelEvents(apriori, "place_words") as unpack_events:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = streaming.mine_streamed(store, dense_cfg, device=dev, chunk_rows=DENSE_CHUNK_ROWS, obs=obs)
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()["support_count"]
    k3_ms = k3_events.ms()
    log(f"[stream-dense] dense bf16 mine_streamed {wall:.3f} s: {passes} passes x {chunks} chunks of "
        f"{DENSE_CHUNK_ROWS} rows (the last {n - (chunks - 1) * DENSE_CHUNK_ROWS} real, zero-padded); "
        f"launches {ops.launch_counts()} [{card}]")
    if launches != passes * chunks:
        raise AssertionError(f"[stream-dense] K3 launched {launches} times for {passes} passes x {chunks} chunks")
    if got.as_dict() != dense_res.as_dict():
        raise AssertionError("[stream-dense] mine_streamed differs from the in-memory dense mine")
    stream_breakdown("stream-dense", obs, wall, "K3", k3_ms, launches,
                     f"; unpacking the chunks on the card {unpack_events.ms():.2f} ms over "
                     f"{len(unpack_events.events)} chunks [{card}]")
    log(f"[stream-dense] dict-identical to the in-memory dense mine ({len(got.as_dict())} itemsets)")
    ms = profiled_breakdown(
        "stream-dense", lambda: streaming.mine_streamed(store, dense_cfg, device=dev, chunk_rows=DENSE_CHUNK_ROWS),
        K3_KERNELS, "K3", launches, card)
    return dict(launches=launches, ms_per_launch=ms, event_ms_per_launch=k3_ms / launches)


def stream_son_phase(streaming, ops, store, dense_cfg, dense_res, son_phase1, son_union, dev, card):
    """``[stream-son]``: ``mine_son_streamed`` over the 8 shards, dense,
    through the retrying executor without speculation: dict-identical, the
    phase-1 union and launches the in-memory SON's, phase 2 one K3 launch
    per (chunk, union pass), every partition completed once."""
    from repro_torch.distributed.fault_tolerance import FaultConfig

    seen = {}
    union_fn = streaming.count_union_streamed

    def union_counted(store_, per_level, *args, **kwargs):
        seen["phase1"] = ops.launch_counts()["support_count"]
        seen["per_level"] = per_level
        return union_fn(store_, per_level, *args, **kwargs)

    ops.reset_launch_counts()
    streaming.count_union_streamed = union_counted
    try:
        t0 = time.perf_counter()
        got = streaming.mine_son_streamed(store, dense_cfg, device=dev, fault=FaultConfig(speculative=False))
        wall = time.perf_counter() - t0
    finally:
        streaming.count_union_streamed = union_fn
    launches = ops.launch_counts()["support_count"]
    phase1, per_level = seen["phase1"], seen["per_level"]
    chunks = -(-store.num_transactions // STREAM_CHUNK_ROWS)
    units = sum(math.ceil(c.shape[0] / dense_cfg.max_candidates_per_pass) for c in per_level.values())
    report = got.fault_report
    log(f"[stream-son] mine_son_streamed over {store.num_partitions} shards {wall:.3f} s, 2 mapper threads; "
        f"K3 launched {launches} times ({phase1} in phase 1, the in-memory SON's {son_phase1}; "
        f"{launches - phase1} in phase 2 = {units} union passes x {chunks} chunks); fault report "
        f"{json.dumps(report.to_json())} [{card}]")
    if phase1 != son_phase1 or launches - phase1 != units * chunks:
        raise AssertionError("[stream-son] K3 launches per phase differ from the expected")
    if list(per_level) != list(son_union) or any(
            not np.array_equal(per_level[k], son_union[k]) for k in per_level):
        raise AssertionError("[stream-son] the phase-1 union differs from the in-memory SON's")
    if report.completed != store.num_partitions or report.retries or report.skipped:
        raise AssertionError(f"[stream-son] fault report {report.to_json()}")
    if got.as_dict() != dense_res.as_dict():
        raise AssertionError("[stream-son] mine_son_streamed differs from the level-wise mine")
    log(f"[stream-son] dict-identical to the level-wise mine; phase-1 union equal to the in-memory SON's")


class _Stopped(Exception):
    """The deliberate stop of ``[stream-resume]``'s first run."""


def stream_resume_phase(streaming, ops, store, cfg, res, dev, card):
    """``[stream-resume]``: a packed ``mine_streamed`` saving every 4
    chunks stops right after its third save (mid-level), then
    ``resume=True`` finishes it: dict-identical, K1 launched once per chunk
    left."""
    from repro_torch.distributed.checkpoint import MiningCheckpoint

    class StopAtThirdSave(MiningCheckpoint):
        saves = 0

        def save(self, state, store_fp, mine_fp):
            seq = super().save(state, store_fp, mine_fp)
            self.saves += 1
            if self.saves == 3:
                self.wait()   # the snapshot is committed; now the run stops
                raise _Stopped()
            return seq

    ck = store.checkpoint_path
    try:
        streaming.mine_streamed(store, cfg, device=dev, chunk_rows=STREAM_CHUNK_ROWS,
                                checkpoint=StopAtThirdSave(ck), checkpoint_every_chunks=4)
    except _Stopped:
        pass
    else:
        raise AssertionError("[stream-resume] the checkpoint's third save did not stop the mine")
    state, _ = MiningCheckpoint(ck).load_latest()
    if not state.mid_level:
        raise AssertionError("[stream-resume] the third save is not mid-level")
    chunks = -(-store.num_transactions // STREAM_CHUNK_ROWS)
    per_level = level_passes(res, store.num_items, cfg)
    done = chunks * (sum(p for k, p in per_level.items() if k < state.next_k)
                     + state.pass_start // cfg.max_candidates_per_pass) + state.chunks_done
    left = chunks * sum(per_level.values()) - done
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = streaming.mine_streamed(store, cfg, device=dev, chunk_rows=STREAM_CHUNK_ROWS,
                                  checkpoint=MiningCheckpoint(ck), checkpoint_every_chunks=4, resume=True)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()["support_count_packed"]
    log(f"[stream-resume] stopped after the third save (level {state.next_k}, chunk {state.chunks_done} of "
        f"pass at candidate {state.pass_start}); resumed mine {wall:.3f} s, K1 launched {launches} times for "
        f"the {left} chunks left of {chunks * sum(per_level.values())} [{card}]")
    if launches != left:
        raise AssertionError(f"[stream-resume] K1 launched {launches} times for {left} chunks left")
    if got.as_dict() != res.as_dict():
        raise AssertionError("[stream-resume] the resumed mine differs from the in-memory packed mine")
    log("[stream-resume] dict-identical to the in-memory packed mine")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.core import apriori, streaming
    from repro_torch.core import son as son_mod
    from repro_torch.core.apriori import AprioriConfig, mine, place_db
    from repro_torch.core.candidates import generate_candidates
    from repro_torch.core.itemsets import pack_bits
    from repro_torch.data.synthetic import QuestConfig, gen_transactions
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops
    from repro_torch.serving.recommend import recommend, recommend_python
    from repro_torch.serving.rulebook import compile_rulebook, place_rulebook

    # The plain K2 and K3 matmuls in full fp32.  TF32 would round no {0,1}
    # operand of K3's plain version, but it would round K2's scores.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")

    # ---- kernel phases: sweeps
    k1_sweep(ops, dev)
    k2_sweep(ops, dev)
    k2_wide(ops, dev, card)
    k3_sweep(ops, dev)

    # ---- the main path's data: FIMI T10I4D100K shape from the Quest generator
    qcfg = QuestConfig(num_transactions=100_000, num_items=1_000, avg_len=10.0, seed=0)
    t0 = time.perf_counter()
    db = gen_transactions(qcfg)
    log(f"[data] T10I4D100K shape {db.shape} generated on the host in {time.perf_counter() - t0:.1f} s")
    cfg = AprioriConfig(min_support=0.002, max_k=4, representation="packed", packed_mode="and_cmp")
    min_count = max(1, math.ceil(cfg.min_support * db.shape[0]))

    # K1 and K3 at the level-2 shape the main path gives them
    t_dev = place_db(db, cfg, dev)
    freq1 = np.flatnonzero(db.sum(0, dtype=np.int64) >= min_count).astype(np.int32)[:, None]
    cands2 = generate_candidates(freq1)
    k1, k1_counts = k1_main_shape(ops, t_dev, cands2, qcfg.num_items, dev, card)
    del t_dev
    k3 = k3_main_shape(ops, db, cands2, k1_counts, dev, card)

    # ---- main path, through the kernels; launch counts read around it
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = mine(db, cfg, device=dev)
    mine_s = time.perf_counter() - t0
    k1_launches = ops.launch_counts()["support_count_packed"]
    t0 = time.perf_counter()
    rb_host = compile_rulebook(res, min_confidence=0.4, score="confidence", num_items=qcfg.num_items)
    compile_s = time.perf_counter() - t0
    rb = place_rulebook(rb_host, dev)
    baskets = db[:4096]
    before = ops.launch_counts()["rule_match"]
    t0 = time.perf_counter()
    rec = recommend(rb, baskets, top_k=10, batch_size=1024, device=dev)
    rec_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    k2_launches = launches["rule_match"] - before

    passes = expected_passes(res, qcfg.num_items, cfg)
    log(f"[main] mine {mine_s:.3f} s ({res.total_frequent} frequent, levels "
        f"{ {k: int(v[0].shape[0]) for k, v in res.levels.items()} }, {passes} candidate passes); "
        f"compile {compile_s:.3f} s ({rb.num_rules} rules, {rb.num_rows} rows); "
        f"recommend {rec_s:.3f} s for {len(baskets)} baskets = {len(baskets) / rec_s:.0f} queries/s "
        f"[{card}]")
    log(f"[main] launches: {launches}")
    if k1_launches != passes or k1_launches == 0:
        raise AssertionError(f"K1 launched {k1_launches} times for {passes} candidate passes")
    batches = -(-len(baskets) // 1024)
    if k2_launches != batches:
        raise AssertionError(f"K2 launched {k2_launches} times for {batches} batches")

    # ---- the main path's results against the plain path and the oracle
    ref_res = mine(db, AprioriConfig(min_support=0.002, max_k=4, representation="packed",
                                     count_impl="ref"), device=dev)
    if ref_res.as_dict() != res.as_dict():
        raise AssertionError("mine through K1 differs from the plain mine on the card")
    plain = recommend(rb, baskets, top_k=10, batch_size=1024, impl="ref", device=dev)
    np.testing.assert_allclose(rec.scores, plain.scores, rtol=RTOL, atol=ATOL)
    s = plain.scores
    gaps = np.abs(np.diff(s, axis=1)) <= ATOL + RTOL * np.abs(s[:, 1:])
    close = np.zeros_like(s, dtype=bool)
    close[:, 1:] |= gaps
    close[:, :-1] |= gaps
    if not np.array_equal(rec.items[~close], plain.items[~close]):
        raise AssertionError("recommend through K2 picks other items than the plain recommend")
    if not (np.isfinite(rec.scores) | (rec.scores == -np.inf)).all():
        raise AssertionError("recommend returned NaN scores")
    py = recommend_python(rb_host, baskets[:64], top_k=10)
    np.testing.assert_allclose(rec.scores[:64], py.scores, rtol=1e-4, atol=1e-5)
    log(f"[main] mine dict-identical to the plain mine ({len(res.as_dict())} itemsets); recommend "
        f"matches the plain recommend ({int(close.sum())} slots within tolerance of a tie) and "
        "recommend_python on 64 baskets")

    mine_breakdown(db, cfg, dev, card, "K1")
    recommend_breakdown(rb, baskets, card)

    # ---- the dense path at the default config (bf16, K3); counts read around it
    dense_cfg = AprioriConfig(min_support=0.002, max_k=4)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dense_res = mine(db, dense_cfg, device=dev)
    dense_s = time.perf_counter() - t0
    dense_launches = ops.launch_counts()
    k3_launches = dense_launches["support_count"]
    dense_passes = expected_passes(dense_res, qcfg.num_items, dense_cfg)
    log(f"[main-dense] mine {dense_s:.3f} s ({dense_res.total_frequent} frequent, {dense_passes} "
        f"candidate passes); launches: {dense_launches} [{card}]")
    if k3_launches != dense_passes or k3_launches == 0:
        raise AssertionError(f"K3 launched {k3_launches} times for {dense_passes} candidate passes")
    if dense_res.as_dict() != res.as_dict():
        raise AssertionError("the dense mine through K3 differs from the packed mine")
    dense_ref = mine(db, AprioriConfig(min_support=0.002, max_k=4, count_impl="ref"), device=dev)
    if dense_ref.as_dict() != dense_res.as_dict():
        raise AssertionError("the dense mine through K3 differs from the plain dense mine on the card")
    log("[main-dense] dict-identical to the packed mine and to the plain dense mine on the card")
    mine_breakdown(db, dense_cfg, dev, card, "K3")

    # ---- SON over 8 partitions, dense: K3 in both phases; counts read around
    # the run, and at the end of its phase 1 through a wrapper of the phase
    son_seen = {}
    phase1_fn = son_mod.union_local_winners

    def phase1_counted(*args):
        union = phase1_fn(*args)
        son_seen["phase1"] = ops.launch_counts()["support_count"]
        son_seen["union"] = union
        return union

    # K3's device time in the run, by CUDA events around each wrapper call
    ops.reset_launch_counts()
    son_mod.union_local_winners = phase1_counted
    try:
        with KernelEvents(ops, "support_count") as k3_events:
            t0 = time.perf_counter()
            son_res = son_mod.mine_son(db, dense_cfg, device=dev, num_partitions=8)
            son_s = time.perf_counter() - t0
    finally:
        son_mod.union_local_winners = phase1_fn
    son_launches = ops.launch_counts()["support_count"]
    son_k3_ms = k3_events.ms()
    son_events = k3_events.events
    phase1 = son_seen["phase1"]
    union_levels = son_mod.winners_to_arrays(son_seen["union"])
    phase2_passes = sum(math.ceil(c.shape[0] / dense_cfg.max_candidates_per_pass) for c in union_levels.values())
    log(f"[son] mine_son over 8 partitions {son_s:.3f} s wall; K3 launched {son_launches} times "
        f"({phase1} in phase 1; {son_launches - phase1} in phase 2 for {phase2_passes} passes over the "
        f"union's levels { {k: int(c.shape[0]) for k, c in union_levels.items()} }); K3 device time "
        f"{son_k3_ms:.2f} ms over {len(son_events)} launches = {son_k3_ms / 1e3 / son_s:.4f} of the wall "
        f"[{card}]")
    if phase1 < 8 or son_launches - phase1 != phase2_passes or phase2_passes == 0 \
            or len(son_events) != son_launches:
        raise AssertionError("mine_son did not launch K3 once per pass in both phases")
    if son_res.as_dict() != dense_res.as_dict():
        raise AssertionError("mine_son differs from the level-wise mine")
    log(f"[son] dict-identical to the level-wise mine ({len(son_res.as_dict())} itemsets)")

    # ---- out of core: the store, the streamed mines, the serve chain from
    # the store's rows, streamed SON and a stopped-and-resumed mine; each
    # phase sets the launch counts to 0 just before its run and reads them
    # just after
    with tempfile.TemporaryDirectory() as root:
        store = store_phase(qcfg, db, root)
        stream_res, k1_stream = stream_phase(streaming, ops, store, cfg, res, mine_s, dev, card)
        k2_stream = serve_chain_phase(ops, store, stream_res, rb_host, rec, dev, card)
        k3_stream = stream_dense_phase(streaming, apriori, ops, store, dense_cfg, dense_res, dev, card)
        stream_son_phase(streaming, ops, store, dense_cfg, dense_res, phase1, union_levels, dev, card)
        stream_resume_phase(streaming, ops, store, cfg, res, dev, card)

    # ---- K2 at the main path's batch shape
    k2 = k2_main_shape(ops, rb, pack_bits(db[:1024]), dev, card)

    kernels = [
        dict(name="support_count_packed", route="cuda",
             source="src/repro_torch/kernels/csrc/support_count_packed.cu",
             replaces="src/repro/kernels/support_count_packed.py:106", launches=k1_launches,
             max_abs_err=k1["and_cmp"]["max_abs_err"], ms=k1["and_cmp"]["ms"],
             plain_ms=k1["and_cmp"]["plain_ms"], bound_ms=k1["and_cmp"]["bound_ms"],
             bound_by=k1["and_cmp"]["bound_by"], library_ms=None,
             stream_launches=k1_stream["launches"], stream_ms_per_launch=k1_stream["ms_per_launch"],
             stream_event_ms_per_launch=k1_stream["event_ms_per_launch"]),
        dict(name="rule_match", route="cuda", source="src/repro_torch/kernels/csrc/rule_match.cu",
             replaces="src/repro/kernels/rule_match.py:86", launches=k2_launches,
             max_abs_err=k2["max_abs_err"], ms=k2["ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by=k2["bound_by"], library_ms=None,
             all_match_ms=k2["all_match_ms"],
             stream_launches=k2_stream["launches"], stream_ms_per_launch=k2_stream["ms_per_launch"],
             stream_event_ms_per_launch=k2_stream["event_ms_per_launch"]),
        dict(name="support_count", route="cuda", source="src/repro_torch/kernels/csrc/support_count.cu",
             replaces="src/repro/kernels/support_count.py:69", launches=k3_launches,
             max_abs_err=k3["bf16"]["max_abs_err"], ms=k3["bf16"]["ms"], plain_ms=k3["bf16"]["plain_ms"],
             bound_ms=k3["bf16"]["bound_ms"], bound_by=k3["bf16"]["bound_by"], library_ms=None,
             gemm_ms=k3["bf16"]["gemm_ms"],
             stream_launches=k3_stream["launches"], stream_ms_per_launch=k3_stream["ms_per_launch"],
             stream_event_ms_per_launch=k3_stream["event_ms_per_launch"]),
    ]
    log(f"[k1] popcount mode at the same shape: {json.dumps(k1['popcount'])} [{card}]")
    log(f"[k3] int8 operands at the same shape: {json.dumps(k3['int8'])} [{card}]")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
