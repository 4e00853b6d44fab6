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
  its third save, mid-level, then resumed;

then the serving tier over the store (``[gateway]``, ``[gateway-swap]``,
``[delta]``, ``[refresh]``, ``[router]``, ``[serve-cli]``), and the paper's
Map/Reduce across ranks: 4 or 6 ranks spawned on the one card over gloo,
each with its own CUDA context, every rank's result checked:

* ``[mesh]``: on a 2 x 2 data x model mesh, the packed ``mine`` through K1
  (each rank 50,000 rows and half of each candidate bucket; K1 once a pass a
  rank) and ``mine_son`` over 8 partitions dealt over the ranks, both
  dict-identical to ``[main]``; each rank's K1 at its level-2 blocks
  against its plain version and timed; the all-reduce a pass timed; the
  setup (spawn, CUDA contexts, rendezvous) apart from the mine walls;
* ``[mesh-dense]``: the bf16 mine through K3 on that mesh and in the paper's
  1-D layout (4, 1), each dict-identical to ``[main-dense]``;
* ``[mesh-stream]``: from ``[store]``'s store, ``mine_streamed`` packed and
  dense at 8,191-row chunks (rounded up to 8,192), ``mine_son_streamed``,
  ``mine_delta`` of ``[delta]``'s appended shard, each dict-identical to
  its single-device phase, and a mine stopped on the mesh at its second
  save resumed here without a mesh;
* ``[mesh-recommend]``: the 43,518-rule rulebook over 3 uneven rule shards
  of a (2, 3) mesh, ``recommend`` of the first 4,096 rows through K2 within
  rtol 1e-5, atol 1e-6 of ``[main]``'s, items equal except at ties;
* ``[mesh-gateway]`` and ``[mesh-refresh]`` (module 7b), one spawn of the
  2 x 2 mesh: ``Gateway(mesh=)`` on the 43,518-rule rulebook, rank 0
  serving the store's first 4,096 rows from 16 clients with a hot swap to
  the 21,334-rule rulebook at half load, then 5,000 rows appended and
  ``RefreshController(mesh=).refresh_now()`` on every rank (a delta mine,
  dict-identical to ``[delta]``'s) while the 16 clients go on sending the
  rows in passes of 4,096, until a pass starts after the refresh has
  ended: zero drops, generations [0, 1, 2], requests answered inside the
  refresh's window (its qps and p99 printed), every response bit for bit
  its generation's mesh ``recommend`` and within rtol 1e-5, atol 1e-6 of
  its single-device one; K2 at each rank's blocks of a full bucket bit for
  bit ``rule_match_ordered``;
* ``[mesh-faults]``: one more spawn of the 2 x 2 mesh, on groups that time
  out after 15 s: the mesh gateway on the 43,518-rule rulebook, 16 clients
  sending the store's first 4,096 rows in loads, a follower's batch and
  then the leader's raising once (injected here, in the rank function):
  exactly those batches' requests fail, naming the rank, and every other
  response is bit for bit its generation's mesh ``recommend``; then a
  follower's refresh mine raising inside level 2 (the cycle fails on every
  rank, the generation stays, the mine mesh is rebuilt), then a clean
  refresh on every rank, dict-identical to ``[delta]``'s ``mine_delta``,
  whose ``refresh_now`` returns the generation that serves on every rank;
  qps and p99 of each load and of the passes sent while each refresh runs;
* ``[mesh-router]`` and ``[mesh-refresh-router]`` (the replicated tier on
  the mesh), one more spawn of the 2 x 2 mesh, each stage on its own copy
  of the refresh store and under ``[gateway]``'s load: ``Router(rb, 2,
  mesh=mesh)`` on every rank, replica 0's dispatch worker killed and a
  coordinated swap to the 21,334-rule rulebook at half load, then
  ``[delta]``'s 5,000 rows appended and ``RefreshController(router,
  mesh=mesh).refresh_now()`` on every rank while the clients send passes;
  then ``Router(rb, 3)`` of single-device gateways on rank 0, refreshed by
  the same kind of controller on every rank (the others pass None) under
  the same rows and load: zero drops, every response bit for bit its
  generation's mesh (or single-device) ``recommend``, every replica healthy
  on one generation after the refresh, each rank's refresh dict-identical
  to ``[delta]``'s ``mine_delta``, K1 on every rank, K2 on every rank that
  serves, and K2 at each rank's blocks bit for bit ``rule_match_ordered``;
  then, in the same spawn, ``[mesh-refresh-reshaped]``: ``Gateway(rb,
  mesh=mesh)`` on the 2 x 2 mesh refreshed by ``RefreshController(gateway,
  mesh=mine)`` whose ``mine`` is a (4, 1) mesh of the same ranks, under the
  same rows and load on a copy of the store of its own: zero drops, every
  response bit for bit its generation's mesh ``recommend``, each rank's
  mine dict-identical to ``[delta]``'s, K1 on every rank and K2 = two warm
  ladders + one a batch on every rank;
* ``[mesh-cli]``: the mine CLI under ``torchrun`` on a 2 x 2 mesh prints the
  single-device CLI's last line;
* ``[mesh-nccl]``: ``[mesh]`` over NCCL, one rank a card, only where the
  machine has two cards or more (a line says so otherwise).

Module 6 adds ``[roofline]`` (first: the part ``launch.roofline.detect_chip``
reads off the card, whose data-sheet rates every bound below is computed
from), ``[static-cost]`` (after ``[stream-resume]``: the mine CLI with
``--store --metrics-out`` at 8,192-row chunks; its ``static_cost`` block has
the JAX CLI's keys and the flops 2·8,192·1,000·Kp), ``[dryrun]`` (the three
production variants of ``launch.mine_dryrun`` on meta tensors) and
``[examples]`` (the nine ``examples/torch`` scripts as subprocesses on the
card at their defaults, each exiting 0, with its wall and its launches).

Any failed check raises, and the script exits non-zero.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launches, errors and times.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")

# The card's rates: ``repro_torch.launch.roofline``'s data-sheet part for the
# card ``detect_chip`` reads (HBM, fp32 outside the tensor cores, int32 lanes,
# the bf16 / int8 tensor-core rates), set by main() before any phase runs.
CHIP = None

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
    bytes_ms = byte_count / CHIP.hbm_bytes_per_s * 1e3
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
    k1 = importlib.import_module("repro_torch.kernels.support_count_packed")

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
        bound_ms, bound_by = bound(byte_count, bitmap_ops / CHIP.int32_op_per_s * 1e3)
        out[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         max_abs_err=float((got - want).abs().max().item()))
        lo, hi = ROW_LAYOUT_K1_MS[mode]
        log(f"[k1] {mode} N={n} Kp={kp} W={w}: exact; kernel {ms:.3f} ms (the row-layout design {lo}-{hi} ms in "
            f"PERF.md: {lo / ms:.1f}x), plain {plain_ms:.1f} ms; bitmap bound {bound_ms:.4f} ms ({bound_by}: "
            f"{items * nb:.3e} item-word ANDs and {int(live.sum().item()) * nb:.3e} popc, 4 op each, over {nb} "
            f"bitmap words at {CHIP.int32_op_per_s:.3e} int32 op/s, {byte_count:.3e} B); word-test bound "
            f"{needed_tests / CHIP.int32_op_per_s * 1e3:.4f} ms ({needed_tests:.3e} word tests on candidate words "
            f"that hold a bit); dense-count bound {dense_tests / CHIP.int32_op_per_s * 1e3:.3f} ms "
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
    bound_ms, bound_by, per_basket, needed_tests, needed_flops, byte_count = k2_bound(rb, b)
    valid = rb.ante_len >= 0
    err = float((got - want).abs().max().item())
    log(f"[k2] B={nb} R={r} W={w}: max |kernel - plain| {err:.3e}, bit-identical across runs and to "
        f"rule_match_ordered on all {nb} baskets (checks took {check_s:.1f} s); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms; matched rules per basket mean {per_basket.mean().item():.1f}, max "
        f"{int(per_basket.max().item())}; bound {bound_ms:.4f} ms ({bound_by}: "
        f"{byte_count:.3e} B, {needed_tests:.3e} antecedent word tests, {needed_flops:.3e} fan-out "
        f"flop of matched rules = {needed_flops / dense_flops:.2e} of the dense count); dense-count bound "
        f"{dense_flops / CHIP.fp32_flop_per_s * 1e3:.4f} ms ({dense_flops:.3e} = 2*B*R*32W fp32 flop at "
        f"{CHIP.fp32_flop_per_s:.2e}/s) [{card}]")

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
    k3 = importlib.import_module("repro_torch.kernels.support_count")

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
    k3 = importlib.import_module("repro_torch.kernels.support_count")

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
        bound_ms, bound_by = bound(byte_count, op_count / CHIP.peak(operand_dtype) * 1e3)
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
            f"{CHIP.peak(operand_dtype):.3e}/s, {byte_count:.3e} B) = {op_count / (ms * 1e-3) / 1e12:.1f} "
            f"T op/s achieved; dense-count bound {dense_ops / CHIP.peak(operand_dtype) * 1e3:.3f} ms "
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

    # the package re-exports a function named ``recommend``, which shadows the module
    rec_mod = importlib.import_module("repro_torch.serving.recommend")

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


# ------------------------------------------------------------ serving -------
REQUESTS = 4_096          # the store's first 4,096 rows, one basket a request
CLIENTS = 16              # closed-loop client threads
LADDER = (1, 2, 4, 8, 16, 32, 64)   # Gateway(max_batch=64, warmup="ladder")
APPEND_FRACTION = 0.05    # 5% of the store's rows, as the serve CLI appends


def drive_clients(submit, n, mid=None, done=None, errors=None):
    """``n`` single-basket requests from ``CLIENTS`` closed-loop threads
    (client c sends requests c, c + 16, ...); ``mid()`` runs between the
    first and the second half; ``done[i]``, if given, gets the host time
    request i was answered.  Returns (responses by request, counts of each
    typed failure, wall s).  ``errors``, if given, gets the text of any
    other error by request (its response stays None) instead of raising."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.serving import AdmissionRejected, DeadlineExceeded, WorkerCrashed

    out = [None] * n
    failed = {"rejected": 0, "crashed": 0, "expired": 0}
    kinds = {AdmissionRejected: "rejected", WorkerCrashed: "crashed", DeadlineExceeded: "expired"}
    lock = threading.Lock()

    def client(indices):
        for i in indices:
            try:
                out[i] = submit(i).result(timeout=120)
                if done is not None:
                    done[i] = time.perf_counter()
            except tuple(kinds) as e:
                with lock:
                    failed[kinds[type(e)]] += 1
            except Exception as e:  # noqa: BLE001 — the caller reads it
                if errors is None:
                    raise
                errors[i] = f"{type(e).__name__}: {e}"

    def fire(lo, hi, pool):
        for f in [pool.submit(client, range(lo + c, hi, CLIENTS)) for c in range(CLIENTS)]:
            f.result()

    half = n // 2 if mid is not None else n
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=CLIENTS) as pool:
        fire(0, half, pool)
        if mid is not None:
            mid()
            fire(half, n, pool)
    return out, failed, time.perf_counter() - t0


def check_responses(tag, out, want_by_gen):
    """Every response bit for bit its generation's ``recommend`` of the
    same basket; returns the generations seen."""
    gens = set()
    for i, r in enumerate(out):
        if r is None:
            continue
        want = want_by_gen[r.generation]
        if not (np.array_equal(r.items, want.items[i])
                and np.array_equal(r.scores.view(np.uint32), want.scores[i].view(np.uint32))):
            raise AssertionError(f"[{tag}] request {i} (generation {r.generation}, bucket {r.bucket}) "
                                 "differs from its generation's recommend")
        gens.add(r.generation)
    return sorted(gens)


class WarmCalls:
    """Within ``with``: counts ``Gateway._warm`` calls (one bucket ladder of
    K2 launches each)."""

    def __enter__(self):
        from repro_torch.serving.gateway import Gateway

        self.cls, self.fn, self.calls = Gateway, Gateway._warm, 0

        def counted(gw, gen):
            self.calls += 1
            return self.fn(gw, gen)

        Gateway._warm = counted
        return self

    def __exit__(self, *exc):
        self.cls._warm = self.fn


def k2_bound(rb, b):
    """(bound_ms, bound_by, matched rules per basket) of one K2 launch on
    baskets ``b`` (B, W) int32 against the placed rulebook ``rb``: the
    bytes read once and written once, or the work these inputs need (a
    word test per antecedent word holding a bit, two flops per matched
    (rule, consequent item)), whichever takes longer."""
    from repro_torch.kernels import ref

    nb, w = b.shape
    r = rb.ante_packed.shape[0]
    valid = rb.ante_len >= 0
    needed_tests = nb * int(((rb.ante_packed != 0).sum(1) * valid).sum().item())
    cons_items = ref.popcount32(rb.cons_packed).sum(1).to(torch.float32)
    matched_items, per_basket = 0.0, []
    for b0 in range(0, nb, 64):
        blk = b[b0 : b0 + 64]
        hit = ((blk[:, None, :] & rb.ante_packed[None]) == rb.ante_packed[None]).all(-1) & valid
        matched_items += float((hit.to(torch.float32) @ cons_items).sum().item())
        per_basket.append(hit.sum(1))
    byte_count = 4 * (nb * w + 2 * r * w + 2 * r + nb * 32 * w)
    ops_ms = max(needed_tests / CHIP.int32_op_per_s, 2 * matched_items / CHIP.fp32_flop_per_s) * 1e3
    bound_ms, bound_by = bound(byte_count, ops_ms)
    return bound_ms, bound_by, torch.cat(per_basket).to(torch.float64), needed_tests, 2 * matched_items, byte_count


def k2_buckets(ops_, gw, packed, card):
    """K2 at buckets 1, 8 and 64 of the gateway's generation: the launch's
    time by CUDA events, its two CUDA kernels (rule compaction over every
    rulebook row, then match and fan-out) by the profiler, and its bound."""
    gen = gw._generation
    rb = gen.rulebook
    out = {}
    for bucket in (1, 8, 64):
        b = words(packed[:bucket], rb.device)
        args = (b, rb.ante_packed, rb.ante_len, rb.cons_packed, rb.scores)
        reps = 50
        ops_.rule_match(*args, impl="kernel")
        ms = cuda_ms(lambda: ops_.rule_match(*args, impl="kernel"), reps)
        _, times = device_profile(lambda: [ops_.rule_match(*args, impl="kernel") for _ in range(reps)])
        split = {name: sum(t for key, (t, _) in times.items() if kernel_name(key) == name) / reps
                 for name in K2_KERNELS}
        bound_ms, bound_by, per_basket, tests, flops, byte_count = k2_bound(rb, b)
        match_ms = cuda_ms(lambda: gw._match(packed[:bucket], gen, 10), 20)
        out[bucket] = dict(ms=ms, compact_ms=split["compact_rules_kernel"], match_ms=split["rule_match_kernel"],
                           bound_ms=bound_ms, bound_by=bound_by, gateway_match_ms=match_ms)
        log(f"[gateway] K2 at bucket {bucket}: {ms:.4f} ms a launch (CUDA events, 50 launches); profiler "
            f"{split['compact_rules_kernel']:.4f} ms rule compaction over all {rb.num_rows} rows + "
            f"{split['rule_match_kernel']:.4f} ms match and fan-out; bound {bound_ms:.5f} ms ({bound_by}: "
            f"{byte_count:.3e} B, {tests:.3e} word tests, {flops:.3e} flop; matched rules per basket mean "
            f"{per_basket.mean().item():.1f}); the gateway's whole match step (H2D, K2, top-k, D2H) "
            f"{match_ms:.4f} ms [{card}]")
    return out


def gateway_phase(ops_, rb, packed, want, dev, card):
    """``[gateway]``: ``Gateway(rb, device="cuda", warmup="ladder",
    max_batch=64, top_k=10)`` answering the store's first 4,096 rows, one
    a request, from 16 closed-loop clients; every response bit for bit the
    port's ``recommend`` of its basket, K2 launched the ladder's 7 warm
    launches plus once per batch."""
    from repro_torch.core.itemsets import unpack_bits
    from repro_torch.serving import Gateway

    ops_.reset_launch_counts()
    t0 = time.perf_counter()
    gw = Gateway(rb, device=dev, warmup="ladder", max_batch=64, top_k=10)
    warm_s = time.perf_counter() - t0
    warm = ops_.launch_counts()["rule_match"]
    try:
        out, failed, wall = drive_clients(lambda i: gw.submit(packed[i]), REQUESTS)
        launches = ops_.launch_counts()["rule_match"]
        stats = gw.stats()
        responses = sum(r is not None for r in out)
        log(f"[gateway] {responses} responses ({failed}) in {wall:.3f} s = {responses / wall:.0f} qps from "
            f"{CLIENTS} clients; registry p50 {stats['latency']['p50_ms']:.3f} ms, p99 "
            f"{stats['latency']['p99_ms']:.3f} ms; {stats['batches']} batches, occupancy "
            f"{stats['batch_occupancy']:.3f} ({stats['batch_rows_real']} real of {stats['batch_rows_padded']} "
            f"padded rows), cache hits {stats['cache_hits']}; warm ladder {warm_s:.3f} s; K2 launched "
            f"{launches} times ({warm} warm) [{card}]")
        if responses + sum(failed.values()) != REQUESTS or failed["rejected"] or responses != REQUESTS:
            raise AssertionError(f"[gateway] {responses} responses and {failed} for {REQUESTS} requests")
        if warm != len(LADDER) or launches != warm + stats["batches"]:
            raise AssertionError(f"[gateway] K2 launched {launches} times: {warm} warm + {stats['batches']} batches")
        buckets = sorted({r.bucket for r in out})
        if check_responses("gateway", out, {0: want}) != [0]:
            raise AssertionError("[gateway] generations other than 0 answered")
        log(f"[gateway] every response bit for bit the port's recommend of its basket, at buckets {buckets}")
        # the same load again, warm, under the profiler: the device's busy share
        # (the repeats would be cache hits, so the cache is emptied first)
        gw.cache.evict_generation(0)
        prof_wall, times = device_profile(lambda: drive_clients(lambda i: gw.submit(packed[i]), REQUESTS))
        busy = sum(ms for ms, _ in times.values())
        k2_dev = sum(ms for key, (ms, _) in times.items() if kernel_name(key) in K2_KERNELS)
        log(f"[gateway] profiled warm load {prof_wall:.3f} s: device busy {busy:.2f} ms = "
            f"{busy / 1e3 / prof_wall:.4f} of the wall, of which K2 {k2_dev:.2f} ms [{card}]")
        # host packing of an item-id basket, the gateway's _pack_one (item c)
        ids = [np.flatnonzero(row).tolist() for row in unpack_bits(packed[:1024], rb.num_items)]
        t0 = time.perf_counter()
        for basket in ids:
            gw._pack_one(basket)
        pack_us = (time.perf_counter() - t0) / len(ids) * 1e6
        log(f"[gateway] host packing of an item-id basket (_pack_one): {pack_us:.1f} us a request; the "
            f"store's rows arrive packed [{card}]")
        bucket_ms = k2_buckets(ops_, gw, packed, card)
    finally:
        gw.close()
    return dict(launches=launches, warm=warm, batches=stats["batches"], qps=responses / wall,
                busy_share=busy / 1e3 / prof_wall,
                p50_ms=stats["latency"]["p50_ms"], p99_ms=stats["latency"]["p99_ms"],
                occupancy=stats["batch_occupancy"], bucket_ms=bucket_ms, pack_us=pack_us)


def gateway_swap_phase(streaming, ops_, store, rb, packed, want, dev, card):
    """``[gateway-swap]``: the store mined again at ``min_support=0.004``
    in a miner thread while the first half of the load runs, then
    hot-swapped in: zero drops, generations [0, 1], each response its own
    generation's ``recommend``."""
    from repro_torch.core.apriori import AprioriConfig
    from repro_torch.serving import Gateway
    from repro_torch.serving.recommend import recommend
    from repro_torch.serving.rulebook import compile_rulebook, place_rulebook

    cfg2 = AprioriConfig(min_support=0.004, max_k=4, representation="packed")
    box = {}

    def miner():
        t0 = time.perf_counter()
        res2 = streaming.mine_streamed(store, cfg2, device=dev, chunk_rows=STREAM_CHUNK_ROWS)
        box["rb"] = compile_rulebook(res2, min_confidence=0.4, score="confidence", num_items=store.num_items)
        box["res"], box["s"] = res2, time.perf_counter() - t0

    ops_.reset_launch_counts()
    with WarmCalls() as warms:
        gw = Gateway(rb, device=dev, warmup="ladder", max_batch=64, top_k=10)
        try:
            thread = threading.Thread(target=miner)

            def mid():
                thread.join(600)
                t0 = time.perf_counter()
                box["gen"] = gw.hot_swap(box["rb"])
                box["swap_s"] = time.perf_counter() - t0

            thread.start()
            out, failed, wall = drive_clients(lambda i: gw.submit(packed[i]), REQUESTS, mid)
            stats = gw.stats()
        finally:
            gw.close()
    counts = ops_.launch_counts()
    responses = sum(r is not None for r in out)
    k1_want = expected_passes(box["res"], store.num_items, cfg2) * -(-store.num_transactions // STREAM_CHUNK_ROWS)
    log(f"[gateway-swap] {responses} responses ({failed}) in {wall:.3f} s; mine at min_support 0.004 "
        f"{box['s']:.3f} s ({box['rb'].num_rules} rules), hot_swap {box['swap_s']:.3f} s to generation "
        f"{box['gen']}; launches {counts} ({warms.calls} warm ladders, {stats['batches']} batches) [{card}]")
    if responses + sum(failed.values()) != REQUESTS or responses != REQUESTS:
        raise AssertionError(f"[gateway-swap] dropped: {responses} responses, {failed}")
    if counts["rule_match"] != warms.calls * len(LADDER) + stats["batches"] or warms.calls != 2:
        raise AssertionError("[gateway-swap] K2 launches differ from the warm ladders plus the batches")
    if counts["support_count_packed"] != k1_want:
        raise AssertionError(f"[gateway-swap] K1 launched {counts['support_count_packed']} times, not {k1_want}")
    rb2 = place_rulebook(box["rb"], dev)
    want2 = recommend(rb2, packed[:REQUESTS], top_k=10, batch_size=1024, device=dev)
    gens = check_responses("gateway-swap", out, {0: want, 1: want2})
    if gens != [0, 1]:
        raise AssertionError(f"[gateway-swap] generations {gens}")
    log("[gateway-swap] zero drops; generations [0, 1]; every response its own generation's recommend")
    return rb2, want2, dict(k2=counts["rule_match"], k1=counts["support_count_packed"])


class DeltaLaunches:
    """Within ``with``: the K1 launches a delta mine should make, from what
    it ran — each phase-1 local mine's candidate passes, and each union
    count's passes times its chunks over its shard range."""

    def __init__(self, son_mod, streaming, store_path, cfg):
        self.son_mod, self.streaming, self.path, self.cfg = son_mod, streaming, store_path, cfg
        self.phase1 = self.union = 0
        self.phase1_s = self.union_s = 0.0   # host wall in each, counts synced back
        self.unions = []

    def __enter__(self):
        from repro_torch.core.apriori import AprioriResult
        from repro_torch.data.store import open_store

        mine_local, count_union = self.son_mod._mine_local, self.streaming.count_union_streamed
        self.saved = (mine_local, count_union)

        def local(t_np, min_count, cfg, device):
            t0 = time.perf_counter()
            levels = mine_local(t_np, min_count, cfg, device)
            self.phase1_s += time.perf_counter() - t0
            res = AprioriResult(levels=levels, num_transactions=t_np.shape[0], min_count=min_count)
            self.phase1 += expected_passes(res, t_np.shape[1], cfg)
            return levels

        def union(store, per_level, *args, **kwargs):
            s0, s1 = kwargs.get("shards") or (0, store.num_partitions)
            rows = sum(open_store(self.path).manifest.shard_rows[s0:s1])
            chunk_rows = kwargs.get("chunk_rows", 8192)
            units = sum(math.ceil(np.asarray(c).shape[0] / self.cfg.max_candidates_per_pass)
                        for c in per_level.values() if np.asarray(c).shape[0])
            self.union += units * -(-rows // chunk_rows)
            self.unions.append((s0, s1, {k: int(np.asarray(c).shape[0]) for k, c in per_level.items()}))
            t0 = time.perf_counter()
            out = count_union(store, per_level, *args, **kwargs)
            self.union_s += time.perf_counter() - t0
            return out

        self.son_mod._mine_local, self.streaming.count_union_streamed = local, union
        return self

    def __exit__(self, *exc):
        self.son_mod._mine_local, self.streaming.count_union_streamed = self.saved

    @property
    def expected(self):
        return self.phase1 + self.union


def append_rows(path, n, seed):
    """Append ``n`` Quest rows of the store's shape (the serve CLI's append)."""
    from repro_torch.data.store import append_chunks, open_store
    from repro_torch.data.synthetic import QuestConfig, gen_transactions_chunked

    aq = QuestConfig(num_transactions=n, num_items=open_store(path).num_items, avg_len=10.0, seed=seed)
    return append_chunks(gen_transactions_chunked(aq, STREAM_CHUNK_ROWS), path)


def delta_phase(streaming, son_mod, ops_, store, cfg, root, dev, card):
    """``[delta]``: ``build_count_cache`` on a copy of the store, 5,000 rows
    (5%, Quest seed 1) appended, then ``mine_delta``: mode ``delta``,
    dict-identical to ``mine_streamed`` over the grown store, K1 launched
    exactly as its phase-1 mines and union counts need."""
    from repro_torch.core import incremental as inc
    from repro_torch.data.store import open_store

    path = os.path.join(root, "delta")
    shutil.copytree(store.path, path)
    ops_.reset_launch_counts()
    t0 = time.perf_counter()
    _, cache = inc.build_count_cache(open_store(path), cfg, dev)
    build_s = time.perf_counter() - t0
    build_launches = ops_.launch_counts()["support_count_packed"]
    shutil.copytree(path, os.path.join(root, "refresh-mesh"))   # [mesh-refresh] appends to it
    append_n = int(APPEND_FRACTION * store.num_transactions)
    append_rows(path, append_n, seed=1)
    shutil.copytree(path, os.path.join(root, "delta-mesh"))   # [mesh-stream]'s mine_delta
    ops_.reset_launch_counts()
    with DeltaLaunches(son_mod, streaming, path, cfg) as want:
        t0 = time.perf_counter()
        res, rep = inc.mine_delta(open_store(path), cfg, dev)
        delta_s = time.perf_counter() - t0
    launches = ops_.launch_counts()["support_count_packed"]
    grown = open_store(path)
    ops_.reset_launch_counts()
    t0 = time.perf_counter()
    full = streaming.mine_streamed(grown, cfg, device=dev, chunk_rows=STREAM_CHUNK_ROWS)
    full_s = time.perf_counter() - t0
    full_launches = ops_.launch_counts()["support_count_packed"]
    log(f"[delta] build_count_cache {build_s:.3f} s ({cache.candidate_total()} cached candidates, K1 "
        f"{build_launches} launches); appended {append_n} rows; mine_delta {delta_s:.3f} s: mode {rep.mode} "
        f"({rep.reason}), {rep.delta_shards} new shard(s), {rep.cached_candidates} cached and "
        f"{rep.novel_candidates} novel candidates, K1 launched {launches} times ({want.phase1} in phase-1 "
        f"local mines, {want.union} in the union counts {want.unions}); phase-1 local mines "
        f"{want.phase1_s:.3f} s, union counts {want.union_s:.3f} s, the rest (split, fold, cache write) "
        f"{delta_s - want.phase1_s - want.union_s:.3f} s; full mine_streamed of the grown "
        f"store {full_s:.3f} s ({full_launches} launches): delta / full = {delta_s / full_s:.3f} [{card}]")
    if rep.mode != "delta":
        raise AssertionError(f"[delta] mode {rep.mode} ({rep.reason})")
    if launches != want.expected or launches == 0:
        raise AssertionError(f"[delta] K1 launched {launches} times, expected {want.expected}")
    if res.as_dict() != full.as_dict():
        raise AssertionError("[delta] mine_delta differs from mine_streamed over the grown store")
    log(f"[delta] dict-identical to mine_streamed over the grown store ({len(res.as_dict())} itemsets)")
    return path, res, dict(launches=launches, build_launches=build_launches, delta_s=delta_s, full_s=full_s,
                           build_s=build_s, phase1_s=want.phase1_s, union_s=want.union_s)


def refresh_phase(streaming, son_mod, ops_, path, res0, cfg, packed, dev, card):
    """``[refresh]``: a ``RefreshController`` in delta mode behind a live
    gateway; 5% rows appended mid-load, the controller delta-mines and
    swaps: zero drops, generations [0, 1], each response its generation's
    ``recommend``, and the served rulebook the one compiled from a full
    re-mine of the grown store."""
    from repro_torch.data.store import open_store
    from repro_torch.serving import Gateway, RefreshController
    from repro_torch.serving.recommend import recommend
    from repro_torch.serving.rulebook import compile_rulebook, place_rulebook

    num_items = open_store(path).num_items
    rb0 = place_rulebook(compile_rulebook(res0, min_confidence=0.4, num_items=num_items), dev)
    want0 = recommend(rb0, packed[:REQUESTS], top_k=10, batch_size=1024, device=dev)
    append_n = int(APPEND_FRACTION * open_store(path).num_transactions)
    box = {}
    ops_.reset_launch_counts()
    with DeltaLaunches(son_mod, streaming, path, cfg) as want_k1, WarmCalls() as warms:
        gw = Gateway(rb0, device=dev, warmup="ladder", max_batch=64, top_k=10)
        ctl = RefreshController(path, gw, cfg, device=dev, chunk_rows=STREAM_CHUNK_ROWS, min_confidence=0.4,
                                mode="delta", poll_interval_s=0.05).start()
        try:
            def mid():
                age = gw.metrics.generation_age.value
                append_rows(path, append_n, seed=2)
                deadline = time.perf_counter() + 600
                while not ctl.history and time.perf_counter() < deadline:
                    time.sleep(0.02)
                if not ctl.history:
                    raise AssertionError(f"[refresh] no refresh in 600 s: {ctl.last_error!r}")
                box["age_before"], box["age_after"] = age, gw.metrics.generation_age.value

            out, failed, wall = drive_clients(lambda i: gw.submit(packed[i]), REQUESTS, mid)
        finally:
            ctl.stop()
            gw.close()
        served = gw._generation.rulebook
        stats = gw.stats()
    counts = ops_.launch_counts()
    last = ctl.history[-1]
    responses = sum(r is not None for r in out)
    log(f"[refresh] {responses} responses ({failed}) in {wall:.3f} s; appended {append_n} rows mid-load; "
        f"refresh {last['mode']} ({last['reason']}) {last['seconds']:.3f} s to generation {last['generation']} "
        f"({last['rules']} rules, {last['novel_candidates']} novel candidates); generation age "
        f"{box['age_before']:.3f} s -> {box['age_after']:.3f} s; launches {counts} (K1 expected "
        f"{want_k1.expected}: {want_k1.phase1} phase 1 + {want_k1.union} union; K2 {warms.calls} warm "
        f"ladders + {stats['batches']} batches) [{card}]")
    if responses != REQUESTS or sum(failed.values()):
        raise AssertionError(f"[refresh] dropped: {responses} responses, {failed}")
    if last["mode"] != "delta" or len(ctl.history) != 1:
        raise AssertionError(f"[refresh] history {ctl.history}")
    if counts["support_count_packed"] != want_k1.expected:
        raise AssertionError(f"[refresh] K1 launched {counts['support_count_packed']}, expected {want_k1.expected}")
    if counts["rule_match"] != warms.calls * len(LADDER) + stats["batches"]:
        raise AssertionError("[refresh] K2 launches differ from the warm ladders plus the batches")
    full = streaming.mine_streamed(open_store(path), cfg, device=dev, chunk_rows=STREAM_CHUNK_ROWS)
    want_rb = compile_rulebook(full, min_confidence=0.4, num_items=num_items)
    got_rb = served.to_host()
    for col in ("ante_packed", "cons_packed", "ante_len", "scores"):
        if np.asarray(getattr(got_rb, col)).tobytes() != np.asarray(getattr(want_rb, col)).tobytes():
            raise AssertionError(f"[refresh] served rulebook column {col} differs from the full re-mine's")
    want1 = recommend(served, packed[:REQUESTS], top_k=10, batch_size=1024, device=dev)
    gens = check_responses("refresh", out, {0: want0, 1: want1})
    if gens != [0, 1]:
        raise AssertionError(f"[refresh] generations {gens}")
    log("[refresh] zero drops; generations [0, 1]; every response its generation's recommend; the served "
        "rulebook column for column the one compiled from a full re-mine of the grown store")
    return dict(seconds=last["seconds"], k1=counts["support_count_packed"], k2=counts["rule_match"])


def router_phase(ops_, rb, rb2, packed, want, want2, dev, card):
    """``[router]``: 3 replicas on the card behind the router; replica 0's
    dispatch worker killed and a coordinated hot swap at half load: zero
    drops, every replica healthy with equal generations at the end, each
    response its generation's ``recommend``."""
    from repro_torch.distributed import FaultConfig
    from repro_torch.serving import Router

    ops_.reset_launch_counts()
    box = {}
    with WarmCalls() as warms:
        router = Router(rb, 3, device=dev, warmup="ladder", max_batch=64, top_k=10,
                        fault=FaultConfig(max_retries=3, backoff_s=0.01), attempt_timeout_s=1.0)
        try:
            def mid():
                router.fault_injection.kill_replica(0)
                t0 = time.perf_counter()
                box["gen"] = router.hot_swap(rb2)
                box["swap_s"] = time.perf_counter() - t0

            out, failed, wall = drive_clients(lambda i: router.submit(packed[i]), REQUESTS, mid)
            deadline = time.perf_counter() + 30
            while time.perf_counter() < deadline and not all(
                    r["state"] == "healthy" for r in router.stats()["replicas"]):
                time.sleep(0.02)
            stats = router.stats()
        finally:
            router.close()
    launches = ops_.launch_counts()["rule_match"]
    batches = sum(r["gateway"]["batches"] for r in stats["replicas"])
    responses = sum(r is not None for r in out)
    states = [r["state"] for r in stats["replicas"]]
    gens_end = [r["generation"] for r in stats["replicas"]]
    log(f"[router] {responses} responses ({failed}) in {wall:.3f} s = {responses / wall:.0f} qps; kills fired "
        f"{router.fault_injection.kills_fired}, failovers {stats['failovers']}, coordinated swap to generation "
        f"{box['gen']} in {box['swap_s']:.3f} s; replica states {states}, generations {gens_end}; K2 launched "
        f"{launches} times ({warms.calls} warm ladders + {batches} batches); router p50 "
        f"{stats['latency']['p50_ms']:.3f} ms, p99 {stats['latency']['p99_ms']:.3f} ms [{card}]")
    if responses + sum(failed.values()) != REQUESTS:
        raise AssertionError(f"[router] dropped: {responses} responses, {failed}")
    if states != ["healthy"] * 3 or gens_end != [1, 1, 1] or router.fault_injection.kills_fired != 1:
        raise AssertionError(f"[router] replicas {states} at generations {gens_end}")
    if launches != warms.calls * len(LADDER) + batches:
        raise AssertionError("[router] K2 launches differ from the warm ladders plus the batches")
    gens = check_responses("router", out, {0: want, 1: want2})
    if gens != [0, 1]:
        raise AssertionError(f"[router] generations {gens}")
    log(f"[router] zero drops ({failed['crashed']} crashed in the killed batch); every replica healthy at "
        "generation 1; every response its generation's recommend")
    return dict(launches=launches, qps=responses / wall)


def serve_cli_phase(store, root, dev, card):
    """``[serve-cli]``: ``python -m repro_torch.launch.serve`` as a
    subprocess at this shape on copies of the store, once plain and once
    with 3 replicas, a replica kill, a delta refresh of 5% appended rows,
    SLOs, a trace and a metrics file; the summaries' invariants hold."""
    base = ["--transactions", str(store.num_transactions), "--items", str(store.num_items),
            "--avg-len", "10", "--seed", "0", "--device", dev.type,
            "--min-support", "0.002", "--max-k", "4", "--min-confidence", "0.4",
            "--shard-rows", str(STORE_SHARD_ROWS), "--stream-chunk-rows", str(STREAM_CHUNK_ROWS),
            "--requests", str(REQUESTS), "--concurrency", str(CLIENTS)]
    trace, metrics = os.path.join(root, "trace.json"), os.path.join(root, "metrics.json")
    runs = {
        "plain": [],
        "chaos": ["--replicas", "3", "--kill-replica-mid-load", "--refresh", "delta", "--append-mid-load",
                  str(APPEND_FRACTION), "--slo", "--trace-out", trace, "--trace-sample", "0.05",
                  "--metrics-out", metrics],
    }
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    summaries = {}
    for name, flags in runs.items():
        path = os.path.join(root, f"cli-{name}")
        shutil.copytree(store.path, path)
        out = os.path.join(root, f"cli-{name}.json")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *base, "--store", path,
                               *flags, "--json", out], capture_output=True, text=True, env=env, timeout=600)
        wall = time.perf_counter() - t0
        tail = [ln for ln in proc.stdout.splitlines() if ln.startswith("[serve]")][-4:]
        for ln in tail:
            log(f"[serve-cli] {name}: {ln}")
        if proc.returncode != 0:
            log(proc.stdout[-4000:])
            log(proc.stderr[-4000:])
            raise AssertionError(f"[serve-cli] {name} exited {proc.returncode}")
        s = json.load(open(out))
        summaries[name] = s
        log(f"[serve-cli] {name} in {wall:.1f} s: {s['responses']} responses, qps {s['qps']:.0f}, registry p50 "
            f"{s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms, occupancy {s['batch_occupancy']:.3f}, "
            f"generations {s['generations']} [{card}]")
    p, c = summaries["plain"], summaries["chaos"]
    if p["responses"] + p["rejected"] != REQUESTS or p["generations"] != [0] or p["responses"] == 0:
        raise AssertionError(f"[serve-cli] plain summary {p}")
    terminal = c["responses"] + c["rejected"] + c["crashed_requests"] + c["deadline_expired_requests"]
    if (terminal != REQUESTS or c["kills_fired"] != 1 or c["worker_restarts"] < 1 or c["availability"] < 0.99
            or c["replica_states"] != ["healthy"] * 3 or len(set(c["replica_generations"])) != 1
            or c["generations"] != [0, 1] or c["refresh"]["mode"] != "delta"
            or c["refresh"]["appended_rows"] != int(APPEND_FRACTION * store.num_transactions)):
        raise AssertionError(f"[serve-cli] chaos summary {({k: v for k, v in c.items() if k != 'alerts'})}")
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]}
    need = {"router.request", "router.attempt", "gateway.request", "queue.wait", "batch.assemble",
            "device.dispatch", "swap.prepare", "swap.commit"}
    if not need <= names:
        raise AssertionError(f"[serve-cli] trace lacks {need - names}")
    reg = json.load(open(metrics))
    if sorted(reg) != ["replicas", "router"] or len(reg["replicas"]) != 3:
        raise AssertionError("[serve-cli] metrics file")
    log(f"[serve-cli] chaos: refresh {c['refresh']['mode']} {c['refresh']['latency_s']:.3f} s, "
        f"{c['refresh']['delta_rows']} rows; kills {c['kills_fired']}, restarts {c['worker_restarts']}, "
        f"availability {c['availability']:.4f}, failovers {c['failovers']}, alerts fired {c['alerts_fired']} "
        f"cleared {c['alerts_cleared']}; replica states {c['replica_states']} at {c['replica_generations']}; "
        f"the trace holds the request chain and the swap spans [{card}]")
    log("[serve-cli] both summaries hold the verify recipe's invariants")
    return dict(plain_qps=p["qps"], plain_p50=p["p50_ms"], plain_p99=p["p99_ms"], chaos_qps=c["qps"],
                chaos_p50=c["p50_ms"], chaos_p99=c["p99_ms"], refresh_s=c["refresh"]["latency_s"])


# ------------------------------------------------------------------ mesh ---
# The paper's Map/Reduce across ranks: the mesh phases spawn 4 or 6 ranks on
# the one card (``launch.mesh.spawn``, gloo; NCCL refuses two ranks of one
# card), each a process with its own CUDA context and kernel libraries (built
# by this process before).  A rank function below runs in each; it resets
# its rank's launch counts just before each path and reads them just after,
# and returns digests and times for this process to check and log.
MESH = (2, 2)                  # data x model: 50,000 rows and half of each bucket a rank
MESH_CHUNK_ROWS = 8_191        # rounds up to 8,192 on 2 data shards
MESH_TIMEOUT_S = 600.0


def digest(res) -> str:
    """A fingerprint of ``as_dict()``: equal digests are equal dicts."""
    import hashlib

    return hashlib.sha256(repr(sorted(res.as_dict().items())).encode()).hexdigest()


class StopAfterSecondSave(Exception):
    pass


def _rank_setup(mesh):
    """This rank's device made ready (its CUDA context), the time it was."""
    torch.zeros(1, device=mesh.device)
    torch.cuda.synchronize(mesh.device)
    return time.time()


class CollectiveTimes:
    """Within ``with``: host time of every all-reduce and all-gather this
    rank sends (the device synchronised on both sides, so each is the
    collective alone)."""

    def __enter__(self):
        import torch.distributed as dist

        self.dist, self.saved, self.times = dist, (dist.all_reduce, dist.all_gather), []

        def timed(fn):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if out is not None:   # sent with async_op=True (every mesh collective): wait here
                    out.wait()
                torch.cuda.synchronize()
                self.times.append(time.perf_counter() - t0)
                return out

            return run

        dist.all_reduce, dist.all_gather = (timed(fn) for fn in self.saved)
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce, self.dist.all_gather = self.saved


def _one_rank_at_a_time(mesh, fn):
    """``fn()`` on each rank in turn, the others waiting: a kernel timed
    without the other ranks' work on the card."""
    out = None
    for r in range(mesh.size):
        if mesh.rank == r:
            out = fn()
        mesh.barrier()
    return out


def _alone_ms(mesh, collective, reps=20) -> float:
    """``collective()`` with every rank there at once (after a barrier,
    device synchronised): the collective without the wait for the slowest
    rank that a mine's collectives include."""
    mesh.barrier()
    collective()
    torch.cuda.synchronize(mesh.device)
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        collective()
    torch.cuda.synchronize(mesh.device)
    return (time.perf_counter() - t0) / reps * 1e3


def _allreduce_alone_ms(mesh, x, axes, reps=20) -> float:
    """One all-reduce of ``x`` over ``axes``, alone (:func:`_alone_ms`)."""
    import torch.distributed as dist

    group = mesh.group(axes)
    return _alone_ms(mesh, lambda: dist.all_reduce(x, group=group), reps)


def _timed_run(mesh, ops, run, kernel):
    """``run()`` from a barrier, with the launch counts reset just before
    and read just after: (result, wall s, launches, collective times)."""
    ops.reset_launch_counts()
    with CollectiveTimes() as ar:
        mesh.barrier()
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
    return res, wall, ops.launch_counts()[kernel], ar.times


def mesh_rank(mesh, paths):
    """One rank of the (2, 2) mesh: ``[mesh]``, ``[mesh-dense]`` and
    ``[mesh-stream]``, and K1 and K3 at this rank's level-2 blocks."""
    ready = _rank_setup(mesh)
    from repro_torch.core import incremental as inc
    from repro_torch.core import streaming
    from repro_torch.core.apriori import AprioriConfig, _candidate_quantum, _pad_bucket, _place_candidates
    from repro_torch.core.apriori import mine, place_db
    from repro_torch.core.candidates import generate_candidates
    from repro_torch.core.son import mine_son
    from repro_torch.data.store import open_store
    from repro_torch.distributed.checkpoint import MiningCheckpoint
    from repro_torch.kernels import ops

    dev = mesh.device
    db = np.load(paths["db"])
    axes = dict(data_axes=("data",), model_axis="model")
    cfg = AprioriConfig(min_support=0.002, max_k=4, representation="packed", packed_mode="and_cmp", **axes)
    dense_cfg = AprioriConfig(min_support=0.002, max_k=4, **axes)
    out = dict(rank=mesh.rank, ready=ready)

    def record(tag, run, kernel):
        res, wall, launches, times = _timed_run(mesh, ops, run, kernel)
        out[tag] = dict(wall=wall, launches=launches, digest=digest(res), allreduce_ms=[t * 1e3 for t in times])
        return res

    record("mine", lambda: mine(db, cfg, device=dev, mesh=mesh), "support_count_packed")
    record("son", lambda: mine_son(db, cfg, device=dev, mesh=mesh, num_partitions=8), "support_count_packed")
    record("dense", lambda: mine(db, dense_cfg, device=dev, mesh=mesh), "support_count")

    # K1 and K3 at this rank's blocks of the level-2 pass, each against its
    # plain version on the same blocks, then timed one rank at a time
    min_count = math.ceil(cfg.min_support * db.shape[0])
    cands = generate_candidates(np.flatnonzero(db.sum(0, dtype=np.int64) >= min_count).astype(np.int32)[:, None])
    kp = _pad_bucket(cands.shape[0], _candidate_quantum(cfg, mesh))
    shapes = {}
    for name, c_cfg, fn in (("k1", cfg, ops.support_count_packed), ("k3", dense_cfg, ops.support_count)):
        t = place_db(db, c_cfg, dev, mesh=mesh)
        c, ln = _place_candidates(cands, kp, db.shape[1], c_cfg, dev, mesh)
        got, plain = fn(t, c, ln, impl="kernel"), fn(t, c, ln, impl="ref")
        torch.cuda.synchronize()
        shapes[name] = (t, c, ln, fn)
        out[name] = dict(rows=int(t.shape[0]), cands=int(c.shape[0]),
                         max_abs_err=float((got - plain).abs().max().item()))
    for name, (t, c, ln, fn) in shapes.items():
        ms = _one_rank_at_a_time(mesh, lambda: (fn(t, c, ln), cuda_ms(lambda: fn(t, c, ln), 10))[1])
        out[name]["ms"] = ms
    del shapes
    # the step's one collective: its model block of the pass's counts over data
    out["allreduce_alone_ms"] = _allreduce_alone_ms(mesh, torch.zeros(kp // 2, dtype=torch.int32, device=dev),
                                                    ("data",))

    # [mesh-stream]: from [store]'s store
    store = open_store(paths["store"])
    record("stream", lambda: streaming.mine_streamed(store, cfg, device=dev, mesh=mesh,
                                                     chunk_rows=MESH_CHUNK_ROWS), "support_count_packed")
    record("stream_dense", lambda: streaming.mine_streamed(store, dense_cfg, device=dev, mesh=mesh,
                                                           chunk_rows=MESH_CHUNK_ROWS), "support_count")
    record("stream_son", lambda: streaming.mine_son_streamed(store, cfg, device=dev, mesh=mesh,
                                                             chunk_rows=MESH_CHUNK_ROWS), "support_count_packed")

    class StopAtSecondSave(MiningCheckpoint):
        saves = 0

        def save(self, state, store_fp, mine_fp):
            seq = super().save(state, store_fp, mine_fp)
            self.saves += 1
            if self.saves == 2:
                raise StopAfterSecondSave()
            return seq

    try:
        streaming.mine_streamed(store, cfg, device=dev, mesh=mesh, chunk_rows=MESH_CHUNK_ROWS,
                                checkpoint=StopAtSecondSave(paths["ckpt"]), checkpoint_every_chunks=4)
        out["stopped"] = False
    except StopAfterSecondSave:
        out["stopped"] = True
    ops.reset_launch_counts()
    mesh.barrier()
    t0 = time.perf_counter()
    res, rep = inc.mine_delta(open_store(paths["delta"]), cfg, dev, mesh=mesh)
    out["delta"] = dict(wall=time.perf_counter() - t0, launches=ops.launch_counts()["support_count_packed"],
                        digest=digest(res), mode=rep.mode)
    return out


def mesh_1d_rank(mesh, paths):
    """One rank of the paper's 1-D layout (4, 1): the dense mine with both
    axes splitting rows and no candidate split."""
    ready = _rank_setup(mesh)
    from repro_torch.core.apriori import AprioriConfig, mine
    from repro_torch.kernels import ops

    db = np.load(paths["db"])
    cfg = AprioriConfig(min_support=0.002, max_k=4, data_axes=("data", "model"), model_axis=None)
    res, wall, launches, times = _timed_run(mesh, ops, lambda: mine(db, cfg, device=mesh.device, mesh=mesh),
                                            "support_count")
    return dict(rank=mesh.rank, ready=ready, wall=wall, launches=launches, digest=digest(res),
                allreduce_ms=[t * 1e3 for t in times])


def mesh_recommend_rank(mesh, paths):
    """One rank of the (2, 3) mesh: the 43,518-rule rulebook split over 3
    rule shards (uneven: 43,520 rows pad to 43,521), the first 4,096 rows
    recommended at batch 1,024 (512 baskets a data shard), and K2 at this
    rank's blocks of the first batch against its plain version."""
    ready = _rank_setup(mesh)
    from repro_torch.core.itemsets import pack_bits
    from repro_torch.core.mapreduce import shard_rows
    from repro_torch.kernels import ops
    from repro_torch.serving.recommend import recommend
    from repro_torch.serving.rulebook import Rulebook, place_rulebook

    dev = mesh.device
    baskets = np.load(paths["db"], mmap_mode="r")[:4096]
    placed = place_rulebook(Rulebook.load(paths["rulebook"]), dev, mesh=mesh)
    rec, wall, launches, times = _timed_run(
        mesh, ops, lambda: recommend(placed, baskets, top_k=10, batch_size=1024, device=dev, mesh=mesh),
        "rule_match")
    b = torch.from_numpy(np.ascontiguousarray(shard_rows(pack_bits(baskets[:1024]).view(np.int32), mesh,
                                                         ("data",)))).to(dev)
    cols = (placed.ante_packed, placed.ante_len, placed.cons_packed, placed.scores)
    got, plain = ops.rule_match(b, *cols, impl="kernel"), ops.rule_match(b, *cols, impl="ref")
    torch.cuda.synchronize()
    ms = _one_rank_at_a_time(mesh, lambda: (ops.rule_match(b, *cols), cuda_ms(lambda: ops.rule_match(b, *cols), 20))[1])
    from repro_torch.core.mapreduce import ordered_sum

    alone = _alone_ms(mesh, lambda: ordered_sum(got, mesh, ("model",)))
    return dict(rank=mesh.rank, ready=ready, wall=wall, launches=launches, allreduce_ms=[t * 1e3 for t in times],
                allreduce_alone_ms=alone, score_bytes=got.numel() * 4,
                items=rec.items, scores=rec.scores, baskets=int(b.shape[0]), rules=int(cols[0].shape[0]),
                rows=placed.num_rows, num_rules=placed.num_rules, ms=ms,
                max_abs_err=float((got - plain).abs().max().item()))


def _setup_s(t_spawn, outs):
    return max(o["ready"] for o in outs) - t_spawn


def _spawn_mesh(fn, shape, paths, backend="gloo", device="cuda:0"):
    from repro_torch.launch.mesh import spawn

    t0 = time.time()
    outs = spawn(fn, shape, ("data", "model"), device=device, backend=backend, timeout_s=MESH_TIMEOUT_S,
                 args=(paths,))
    return outs, _setup_s(t0, outs), time.time() - t0


def _ar_line(times):
    return (f"{len(times)} collectives, {np.mean(times):.3f} ms each (max {max(times):.3f})" if times
            else "no collective")


def mesh_phase(streaming, ops, paths, want, passes, dev, card, backend="gloo", device="cuda:0", tag="mesh",
               shape=MESH):
    """``[mesh]``, ``[mesh-dense]`` and ``[mesh-stream]`` on a (2, 2) mesh
    of 4 ranks: every rank's dicts identical to the single-device phases',
    exact launch counts per rank; then the mine stopped on the mesh at its
    second save resumed here without a mesh."""
    from repro_torch.core.apriori import AprioriConfig
    from repro_torch.distributed.checkpoint import MiningCheckpoint

    from repro_torch.data.store import open_store

    outs, setup_s, total_s = _spawn_mesh(mesh_rank, shape, paths, backend, device)
    chunks = -(-open_store(paths["store"]).num_transactions // (MESH_CHUNK_ROWS + 1))
    checks = {
        "mine": ("main", passes["packed"]), "son": ("main", None), "dense": ("main", passes["dense"]),
        "stream": ("main", passes["packed"] * chunks), "stream_dense": ("main", passes["dense"] * chunks),
        "stream_son": ("main", None), "delta": ("delta", None),
    }
    for o in outs:
        for key, (ref, launches) in checks.items():
            if o[key]["digest"] != want[ref]:
                raise AssertionError(f"[{tag}] rank {o['rank']}: {key} differs from the single-device result")
            if o[key]["launches"] == 0 or (launches is not None and o[key]["launches"] != launches):
                raise AssertionError(f"[{tag}] rank {o['rank']}: {key} launched its kernel "
                                     f"{o[key]['launches']} times, expected {launches}")
        if o["delta"]["mode"] != "delta" or not o["stopped"]:
            raise AssertionError(f"[{tag}] rank {o['rank']}: delta mode {o['delta']['mode']}, stopped {o['stopped']}")
        if o["k1"]["max_abs_err"] or o["k3"]["max_abs_err"]:
            raise AssertionError(f"[{tag}] rank {o['rank']}: K1 or K3 differs from its plain version")
    log(f"[{tag}] {len(outs)} ranks ({backend}, {device}) of a {shape[0]} x {shape[1]} data x model mesh: setup "
        f"(spawn, imports, CUDA contexts, rendezvous, groups) {setup_s:.3f} s; whole spawn {total_s:.3f} s [{card}]")
    for o in outs:
        log(f"[{tag}] rank {o['rank']}: packed mine {o['mine']['wall']:.3f} s (K1 {o['mine']['launches']} launches, "
            f"{_ar_line(o['mine']['allreduce_ms'])}, which wait for the slowest rank; the step's all-reduce "
            f"of its 128 KB block of a pass alone {o['allreduce_alone_ms']:.3f} ms); mine_son over 8 partitions {o['son']['wall']:.3f} s "
            f"(K1 {o['son']['launches']}); K1 at its level-2 blocks N={o['k1']['rows']} x Kp={o['k1']['cands']}: "
            f"{o['k1']['ms']:.4f} ms, exact [{card}]")
        log(f"[{tag}-dense] rank {o['rank']}: bf16 mine {o['dense']['wall']:.3f} s (K3 {o['dense']['launches']} "
            f"launches, {_ar_line(o['dense']['allreduce_ms'])}); K3 at N={o['k3']['rows']} x "
            f"Kp={o['k3']['cands']}: {o['k3']['ms']:.4f} ms, exact [{card}]")
        log(f"[{tag}-stream] rank {o['rank']}: packed mine_streamed {o['stream']['wall']:.3f} s (K1 "
            f"{o['stream']['launches']} = passes x {chunks} chunks of {MESH_CHUNK_ROWS + 1} rows, "
            f"{_ar_line(o['stream']['allreduce_ms'])}); dense {o['stream_dense']['wall']:.3f} s (K3 "
            f"{o['stream_dense']['launches']}); mine_son_streamed {o['stream_son']['wall']:.3f} s (K1 "
            f"{o['stream_son']['launches']}); mine_delta {o['delta']['wall']:.3f} s (K1 {o['delta']['launches']}, "
            f"mode {o['delta']['mode']}) [{card}]")
    log(f"[{tag}] every rank dict-identical to [main] (mine, mine_son), [main-dense], [stream], [stream-dense], "
        f"[stream-son] and [delta]")
    if tag != "mesh":
        return outs
    # the checkpoint the mesh committed at its second save, resumed here
    cfg = AprioriConfig(min_support=0.002, max_k=4, representation="packed")
    state, _ = MiningCheckpoint(paths["ckpt"]).load_latest()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = streaming.mine_streamed(open_store(paths["store"]), cfg, device=dev, chunk_rows=MESH_CHUNK_ROWS + 1,
                                  checkpoint=MiningCheckpoint(paths["ckpt"]), checkpoint_every_chunks=4, resume=True)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()["support_count_packed"]
    if digest(got) != want["main"] or launches == 0 or launches >= passes["packed"] * chunks:
        raise AssertionError(f"[mesh-stream] the mesh's checkpoint resumed without a mesh: dicts equal "
                             f"{digest(got) == want['main']}, K1 {launches} launches")
    log(f"[mesh-stream] the checkpoint the mesh committed at its second save (level {state.next_k}, chunk "
        f"{state.chunks_done}, mid-level {state.mid_level}) resumed without a mesh: {wall:.3f} s, K1 {launches} "
        f"launches, dict-identical to [main] [{card}]")
    return outs


def mesh_1d_phase(paths, want, passes, card):
    """``[mesh-dense]`` in the paper's 1-D layout: (4, 1), rows over both axes."""
    outs, setup_s, total_s = _spawn_mesh(mesh_1d_rank, (4, 1), paths)
    for o in outs:
        if o["digest"] != want["main"] or o["launches"] != passes["dense"]:
            raise AssertionError(f"[mesh-dense] paper_1d rank {o['rank']}: dicts equal "
                                 f"{o['digest'] == want['main']}, K3 {o['launches']} launches")
        log(f"[mesh-dense] paper_1d (4, 1) rank {o['rank']}: bf16 mine {o['wall']:.3f} s, K3 {o['launches']} "
            f"launches at 25,000 rows, {_ar_line(o['allreduce_ms'])} [{card}]")
    log(f"[mesh-dense] paper_1d: setup {setup_s:.3f} s, whole spawn {total_s:.3f} s; every rank dict-identical "
        f"to [main-dense] [{card}]")
    return outs


def mesh_recommend_phase(paths, rec, card):
    """``[mesh-recommend]``: 6 ranks of a (2, 3) mesh; each rank's whole
    result within rtol 1e-5, atol 1e-6 of [main]'s recommend, items equal
    except within tolerance of a tie; K2 4 launches a rank."""
    outs, setup_s, total_s = _spawn_mesh(mesh_recommend_rank, (2, 3), paths)
    s = rec.scores
    tie = np.abs(np.diff(s, axis=1)) <= ATOL + RTOL * np.abs(s[:, 1:])
    close = np.zeros_like(s, dtype=bool)
    close[:, 1:] |= tie
    close[:, :-1] |= tie
    for o in outs:
        np.testing.assert_allclose(o["scores"], s, rtol=RTOL, atol=ATOL)
        if not np.array_equal(o["items"][~close], rec.items[~close]) or o["launches"] != 4 \
                or o["max_abs_err"] > ATOL + RTOL * float(np.abs(s[np.isfinite(s)]).max()):
            raise AssertionError(f"[mesh-recommend] rank {o['rank']}: items or K2 differ, {o['launches']} launches")
        log(f"[mesh-recommend] rank {o['rank']}: recommend of 4,096 baskets {o['wall']:.3f} s, K2 {o['launches']} "
            f"launches; K2 at {o['baskets']} baskets x {o['rules']} rules {o['ms']:.4f} ms (plain max abs err "
            f"{o['max_abs_err']:.2e}); {_ar_line(o['allreduce_ms'])}; the rule-axis ordered sum (an all-gather) "
            f"of a batch's {o['score_bytes']} B of scores alone {o['allreduce_alone_ms']:.3f} ms [{card}]")
    log(f"[mesh-recommend] (2, 3): {outs[0]['num_rules']} rules in {outs[0]['rows']} rows over 3 rule shards; setup "
        f"{setup_s:.3f} s, whole spawn {total_s:.3f} s; every rank within rtol {RTOL}, atol {ATOL} of [main]'s "
        f"recommend, items equal except at {int(close.sum())} slots within tolerance of a tie [{card}]")
    return outs


MESH_LADDER = (2, 4, 8, 16, 32, 64)   # Gateway(max_batch=64, warmup="ladder") over 2 data shards


def mesh_gateway_rank(mesh, paths):
    """One rank of the (2, 2) mesh serving tier, ``[mesh-gateway]`` then
    ``[mesh-refresh]``: every rank builds ``Gateway(mesh=)`` on the
    43,518-rule rulebook and ``RefreshController(mesh=)`` in delta mode on
    a copy of the store whose count cache covers its 100,000 rows.  Rank 0
    drives 16 clients over the store's first 4,096 rows with a hot swap to
    the 21,334-rule rulebook at half load, appends 5,000 rows, and
    refreshes in a thread while the clients send the rows again, pass after
    pass, until a pass starts after the refresh has ended; the others
    follow, and call ``refresh_now`` too.  Each rank times its delta mine
    and counts K1 and K2 across it (the mine runs in a thread of its own,
    beside serving).  The launch counts are set to 0 before the gateway is
    built and read after its close.  Then, as references: every rank's mesh ``recommend``
    of each generation, and K2 at this rank's blocks of a full bucket
    against its plain versions."""
    ready = _rank_setup(mesh)
    from repro_torch.core.apriori import AprioriConfig
    from repro_torch.data.store import open_store
    from repro_torch.kernels import ops
    from repro_torch.serving import refresh as refresh_mod
    from repro_torch.serving.gateway import Gateway
    from repro_torch.serving.recommend import recommend
    from repro_torch.serving.refresh import RefreshController
    from repro_torch.serving.rulebook import Rulebook, place_rulebook

    dev = mesh.device
    packed = np.load(paths["requests"])
    rbs = [Rulebook.load(paths["rulebook"]), Rulebook.load(paths["rulebook_swap"])]
    made = []
    compile_rulebook = refresh_mod.compile_rulebook

    def captured(res, **kw):   # the refresh's result and rulebook, as references
        rb = compile_rulebook(res, **kw)
        made.append((res, rb))
        out["compiled_at"] = time.perf_counter()
        return rb

    mine_delta = refresh_mod.inc.mine_delta

    def timed_mine(*args, **kwargs):   # the refresh's mine, with the launches across it
        before, t = ops.launch_counts(), time.perf_counter()
        res = mine_delta(*args, **kwargs)
        after, t1 = ops.launch_counts(), time.perf_counter()
        out["mine"] = dict(s=t1 - t, span=(t, t1), k1=after["support_count_packed"] - before["support_count_packed"],
                           k2=after["rule_match"] - before["rule_match"])
        return res

    cfg = AprioriConfig(min_support=0.002, max_k=4, representation="packed", data_axes=("data",),
                        model_axis="model")
    out = dict(rank=mesh.rank, ready=ready)
    refresh_mod.compile_rulebook, refresh_mod.inc.mine_delta = captured, timed_mine
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        gw = Gateway(rbs[0], mesh=mesh, device=dev, warmup="ladder", max_batch=64, top_k=10)
        ctl = RefreshController(paths["refresh"], gw, cfg, mesh=mesh, device=dev, chunk_rows=STREAM_CHUNK_ROWS,
                                min_confidence=0.4, mode="delta")
        out["build_s"] = time.perf_counter() - t0
        try:
            if mesh.rank == 0:
                def swap():
                    t = time.perf_counter()
                    out["swapped"] = gw.hot_swap(rbs[1])
                    out["swap_s"] = time.perf_counter() - t

                loads = [drive_clients(lambda i: gw.submit(packed[i]), REQUESTS, swap)]
                t = time.perf_counter()
                out["appended"] = int(APPEND_FRACTION * open_store(paths["refresh"]).num_transactions)
                append_rows(paths["refresh"], out["appended"], seed=1)
                out["append_s"] = time.perf_counter() - t
                box = {}

                def refresh():
                    box["t0"] = time.perf_counter()
                    try:
                        box["generation"] = ctl.refresh_now()
                    except BaseException as e:  # noqa: BLE001 — raised below
                        box["error"] = e
                    box["t1"] = time.perf_counter()

                refresher = threading.Thread(target=refresh, name="mesh-refresh")
                refresher.start()
                dones = [None]
                while True:   # passes of the rows until one starts after the refresh has ended
                    ended = not refresher.is_alive()
                    gw.cache.evict_generation(gw.generation)   # each pass served by batches, not the cache
                    dones.append(np.zeros(REQUESTS))
                    loads.append(drive_clients(lambda i: gw.submit(packed[i]), REQUESTS, done=dones[-1]))
                    if ended:
                        break
                refresher.join()
                if "error" in box:
                    raise box["error"]
                out["refreshed"], out["refresh_s"] = box["generation"], box["t1"] - box["t0"]
                # the refresh's window in its stages, on this rank's clock: the start
                # (the command, the rows check), the mine, the compile, then the
                # outcomes' exchange, the place and the commit
                marks = [box["t0"], *out["mine"]["span"], out["compiled_at"], box["t1"]]
                out["stages"] = list(zip(("start", "mine", "compile", "exchange, place and commit"), marks, marks[1:]))
                stats = gw.stats()
                out["stats"] = {k: stats[k] for k in ("batches", "batch_occupancy", "latency", "cache_hits")}
                out["loads"] = [dict(items=np.stack([r.items for r in got]), scores=np.stack([r.scores for r in got]),
                                     gens=np.array([r.generation for r in got]),
                                     buckets=np.array([r.bucket for r in got]), failed=failed, wall=wall,
                                     latency=np.array([r.latency_s for r in got]), done=done)
                                for (got, failed, wall), done in zip(loads, dones)]
            else:
                t = time.perf_counter()
                out["refreshed"] = ctl.refresh_now()
                out["refresh_s"] = time.perf_counter() - t   # from the follower's call: load and refresh
        finally:
            gw.close()
    finally:
        refresh_mod.compile_rulebook, refresh_mod.inc.mine_delta = compile_rulebook, mine_delta
    counts = ops.launch_counts()
    out.update(k2=counts["rule_match"], k1=counts["support_count_packed"], k3=counts["support_count"],
               timing=dict(gw.mesh_timing), history=ctl.history, ladder=gw.ladder())
    res2, rb2 = made[-1]
    out["digest2"] = digest(res2)
    rbs.append(rb2)
    # references: each generation's mesh recommend (every rank), and on rank
    # 0 its single-device recommend
    refs = [recommend(rb, packed, top_k=10, batch_size=1024, device=dev, mesh=mesh) for rb in rbs]
    if mesh.rank == 0:
        out["refs"] = [(r.items, r.scores) for r in refs]
        single = recommend(place_rulebook(rb2, dev), packed, top_k=10, batch_size=1024, device=dev)
        out["single2"] = (single.items, single.scores)
    out["k2_block"] = _k2_at_blocks(mesh, rbs[0], packed, dev)
    return out


def _k2_at_blocks(mesh, rb, packed, dev):
    """K2 on ``dev`` at this rank's blocks of a full bucket (its share of 64
    baskets, its rule block of ``rb``; with ``mesh`` None, the whole of
    both) against its plain versions, then timed one rank at a time."""
    from repro_torch.core.mapreduce import shard_rows
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.rulebook import place_rulebook

    placed = place_rulebook(rb, dev, mesh=mesh)
    rows = packed[:64].view(np.int32)
    if mesh is not None:
        rows = shard_rows(rows, mesh, ("data",))
    b = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    cols = (placed.ante_packed, placed.ante_len, placed.cons_packed, placed.scores)
    got = ops.rule_match(b, *cols, impl="kernel")
    plain, ordered = ops.rule_match(b, *cols, impl="ref"), ref.rule_match_ordered(b, *cols)
    torch.cuda.synchronize()

    def alone(fn):
        return fn() if mesh is None else _one_rank_at_a_time(mesh, fn)

    return dict(baskets=int(b.shape[0]), rules=int(cols[0].shape[0]),
                max_abs_err=float((got - plain).abs().max().item()), ordered=bool(torch.equal(got, ordered)),
                ms=alone(lambda: (ops.rule_match(b, *cols), cuda_ms(lambda: ops.rule_match(b, *cols), 50))[1]),
                plain_ms=alone(lambda: cuda_ms(lambda: ops.rule_match(b, *cols, impl="ref"), 5)))


def mesh_gateway_phase(paths, want, want_by_gen, card, quiet_mine_s):
    """``[mesh-gateway]`` and ``[mesh-refresh]`` in one spawn of the (2, 2)
    mesh: zero drops, generations [0, 1, 2]; every response bit for bit its
    generation's mesh ``recommend`` and within rtol 1e-5, atol 1e-6 of its
    single-device ``recommend`` (items equal except at ties); the refresh
    on every rank delta mode, dict-identical to ``[delta]``'s mine_delta;
    K2 a rank = 3 warm ladders + every batch, K1 > 0 in the refresh; the
    passes during the refresh answered by generations 1 and 2 and the last
    by 2 alone, and some requests answered inside the refresh's window.
    ``quiet_mine_s``: each rank's ``[mesh-stream]`` mine_delta of the same
    rows, with nothing served beside it."""
    outs, setup_s, total_s = _spawn_mesh(mesh_gateway_rank, MESH, paths)
    lead = outs[0]
    want_by_gen = dict(want_by_gen)
    want_by_gen[2] = lead["single2"]
    batches = lead["stats"]["batches"]
    for o in outs:
        if o["refreshed"] != 2 or [h["mode"] for h in o["history"]] != ["delta"] or o["digest2"] != want["delta"]:
            raise AssertionError(f"[mesh-refresh] rank {o['rank']}: generation {o['refreshed']}, history "
                                 f"{o['history']}, result equal to [delta]'s {o['digest2'] == want['delta']}")
        if o["timing"]["batches"] != batches or o["k2"] != 3 * len(MESH_LADDER) + batches or o["k1"] == 0 \
                or o["k3"] or tuple(o["ladder"]) != MESH_LADDER:
            raise AssertionError(f"[mesh-gateway] rank {o['rank']}: {o['timing']['batches']} batches of {batches}, "
                                 f"K2 {o['k2']}, K1 {o['k1']}, K3 {o['k3']}, ladder {o['ladder']}")
        blk = o["k2_block"]
        if not blk["ordered"] or blk["max_abs_err"] > ATOL + RTOL * 100:
            raise AssertionError(f"[mesh-gateway] rank {o['rank']}: K2 at its blocks differs from its plain versions")
    gens = set()
    for n, load in enumerate(lead["loads"]):
        responses = len(load["gens"])
        if responses != REQUESTS or sum(load["failed"].values()):
            raise AssertionError(f"[mesh-gateway] load {n}: {responses} responses, {load['failed']}")
        for g in sorted(set(load["gens"].tolist())):
            rows = load["gens"] == g
            items, scores = lead["refs"][g]
            if not (np.array_equal(load["items"][rows], items[rows])
                    and np.array_equal(load["scores"][rows].view(np.uint32), scores[rows].view(np.uint32))):
                raise AssertionError(f"[mesh-gateway] load {n}: generation {g}'s responses differ from its mesh "
                                     "recommend")
            w_items, w_scores = want_by_gen[g]
            w_items, w_scores = np.asarray(w_items)[rows], np.asarray(w_scores)[rows]
            np.testing.assert_allclose(load["scores"][rows], w_scores, rtol=RTOL, atol=ATOL)
            tie = np.abs(np.diff(w_scores, axis=1)) <= ATOL + RTOL * np.abs(w_scores[:, 1:])
            close = np.zeros_like(w_scores, dtype=bool)
            close[:, 1:] |= tie
            close[:, :-1] |= tie
            if not np.array_equal(load["items"][rows][~close], w_items[~close]):
                raise AssertionError(f"[mesh-gateway] load {n}: generation {g}'s items differ from its "
                                     "single-device recommend")
            gens.add(g)
    passes = lead["loads"][1:]
    if sorted(gens) != [0, 1, 2] or set(lead["loads"][0]["gens"].tolist()) != {0, 1} \
            or any(not set(p["gens"].tolist()) <= {1, 2} for p in passes) or set(passes[-1]["gens"].tolist()) != {2}:
        raise AssertionError(f"[mesh-gateway] generations {sorted(gens)}, by load "
                             f"{[sorted(set(load['gens'].tolist())) for load in lead['loads']]}")
    # [mesh-refresh]: the requests answered inside the refresh's window, and in each of its stages
    done = np.concatenate([p["done"] for p in passes])
    in_window = (done >= lead["stages"][0][1]) & (done <= lead["stages"][-1][2])
    answered = int(in_window.sum())
    if answered == 0:
        raise AssertionError(f"[mesh-refresh] no request was answered inside the refresh's "
                             f"{lead['refresh_s']:.3f} s window")
    latency_ms = np.concatenate([p["latency"] for p in passes]) * 1e3
    window_lat, window_gens = latency_ms[in_window], np.concatenate([p["gens"] for p in passes])[in_window]
    stages = []
    for name, a, z in lead["stages"]:
        lat_s = latency_ms[(done >= a) & (done < z)]
        stages.append(f"{name} {z - a:.3f} s: {lat_s.size} answered, {lat_s.size / (z - a):.0f} qps"
                      + (f", p99 {np.percentile(lat_s, 99):.3f} ms" if lat_s.size else ""))
    lat = lead["stats"]["latency"]
    walls = [load["wall"] for load in lead["loads"]]
    t_spawn = max(o["ready"] for o in outs) - setup_s
    log(f"[mesh-gateway] (2, 2) over gloo on the one card: setup (spawn, CUDA contexts, rendezvous, groups) "
        f"{setup_s:.3f} s, whole spawn {total_s:.3f} s; {len(walls) * REQUESTS} requests from {CLIENTS} clients: "
        f"the first load {walls[0]:.3f} s = {REQUESTS / walls[0]:.0f} qps, then {len(passes)} passes during and "
        f"after the refresh of {' / '.join(f'{w:.3f}' for w in walls[1:])} s = "
        f"{' / '.join(f'{REQUESTS / w:.0f}' for w in walls[1:])} qps; registry "
        f"p50 {lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms; {batches} batches, occupancy "
        f"{lead['stats']['batch_occupancy']:.3f}, cache hits {lead['stats']['cache_hits']}; hot swap "
        f"{lead['swap_s']:.3f} s to generation {lead['swapped']} [{card}]")
    for o in outs:
        t, blk = o["timing"], o["k2_block"]
        per = {k: t[k] / max(t["batches"], 1) * 1e3 for k in ("broadcast_s", "match_s", "reduce_s", "gather_s")}
        log(f"[mesh-gateway] rank {o['rank']}: set-up {o['ready'] - t_spawn:.3f} s, gateway and "
            f"controller built in {o['build_s']:.3f} s; a batch's broadcast {per['broadcast_s']:.3f} ms, match "
            f"(H2D, K2) {per['match_s']:.3f} ms, rule-axis sum and top-k {per['reduce_s']:.3f} ms, data-axis "
            f"gather {per['gather_s']:.3f} ms; K2 {o['k2']} launches (3 warm ladders of {len(MESH_LADDER)} + "
            f"{t['batches']} batches); K2 at its blocks of a full bucket ({blk['baskets']} baskets x "
            f"{blk['rules']} rules) {blk['ms']:.4f} ms, plain {blk['plain_ms']:.3f} ms, bit for bit "
            f"rule_match_ordered [{card}]")
        log(f"[mesh-refresh] rank {o['rank']}: refresh_now {o['refresh_s']:.3f} s, "
            f"mode {o['history'][0]['mode']} ({o['history'][0]['reason']}), cycle {o['history'][0]['seconds']:.3f} s, "
            f"{o['history'][0]['rules']} rules; K1 {o['k1']} launches; its mine_delta {o['mine']['s']:.3f} s beside "
            f"serving ([mesh-stream]'s of the same rows, nothing served: {quiet_mine_s[o['rank']]:.3f} s), K1 "
            f"{o['mine']['k1']} and K2 {o['mine']['k2']} launches across it [{card}]")
    log(f"[mesh-refresh] appended {lead['appended']} rows in {lead['append_s']:.3f} s; the leader's "
        f"refresh_now {lead['refresh_s']:.3f} s, inside which {answered} requests were answered "
        f"({answered / lead['refresh_s']:.0f} qps; latency p50 {np.percentile(window_lat, 50):.3f} ms, p99 "
        f"{np.percentile(window_lat, 99):.3f} ms; generation 1: {int((window_gens == 1).sum())}, generation 2: "
        f"{int((window_gens == 2).sum())}); by stage on the leader: {'; '.join(stages)}; every rank's result "
        f"dict-identical to [delta]'s mine_delta [{card}]")
    log("[mesh-gateway] zero drops; generations [0, 1, 2]; every response bit for bit its generation's mesh "
        f"recommend and within rtol {RTOL}, atol {ATOL} of its single-device recommend [{card}]")
    return outs


FAULTS_TIMEOUT_S = 15.0   # the groups' timeout of the [mesh-faults] spawn (the other spawns': MESH_TIMEOUT_S)
FAULTS_FOLLOWER = 3       # the follower whose batch and whose refresh mine fail in [mesh-faults]


def _load(submit, mid=None):
    """One load of ``REQUESTS`` from the clients (:func:`drive_clients`) as
    arrays: the responses' items, scores, generations and latencies (zero
    rows where a request failed), which were answered, the errors' texts,
    the typed failures, the end times and the wall."""
    done, errors = np.zeros(REQUESTS), {}
    out, failed, wall = drive_clients(submit, REQUESTS, mid, done=done, errors=errors)
    ok = np.array([r is not None for r in out])
    first = next(r for r in out if r is not None)

    def col(name, fill):
        return np.stack([getattr(r, name) if r is not None else fill for r in out])

    return dict(ok=ok, errors=list(errors.values()), failed=failed, done=done, wall=wall,
                items=col("items", np.zeros_like(first.items)), scores=col("scores", np.zeros_like(first.scores)),
                gens=col("generation", -1), latency=col("latency_s", 0.0))


def mesh_faults_rank(mesh, paths):
    """One rank of ``[mesh-faults]``, on a mesh of ``mesh``'s ranks whose
    groups time out after ``FAULTS_TIMEOUT_S``: the mesh gateway on the
    43,518-rule rulebook and a delta ``RefreshController`` on a copy of the
    store with its 100,000-row count cache.  Rank 0 sends 4 loads of the
    store's first 4,096 rows from 16 clients: clean; with the follower's
    ``Gateway._match`` raising once from half way (a file tells it);
    with its own raising once from half way; clean.  Then it appends
    [delta]'s 5,000 rows, and every rank calls ``refresh_now`` twice: the
    follower's first mine raises at its second ``streaming._reduced`` (the
    union count's level 2, between two of the mine's collectives), the
    second is clean; rank 0 runs each in a thread while its clients send
    the rows in passes until one starts after the refresh has ended.  Each
    rank times its mine mesh's rebuild (``Mesh.twin``) and counts its
    launches over the whole phase; then every rank's mesh ``recommend`` of
    each generation, as references."""
    ready = _rank_setup(mesh)
    from repro_torch.core import streaming
    from repro_torch.core.apriori import AprioriConfig
    from repro_torch.data.store import open_store
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serving import refresh as refresh_mod
    from repro_torch.serving.gateway import Gateway
    from repro_torch.serving.recommend import recommend
    from repro_torch.serving.refresh import RefreshController
    from repro_torch.serving.rulebook import Rulebook

    dev = mesh.device
    short = Mesh(tuple(mesh.shape.values()), mesh.axes, dev, timeout_s=FAULTS_TIMEOUT_S)
    packed = np.load(paths["requests"])
    rb0 = Rulebook.load(paths["rulebook"])
    arm = os.path.join(paths["faults_dir"], "arm-batch")
    out = dict(rank=short.rank, ready=ready, rebuild_s=[])
    failing = dict(batch=0, leader=False, mine_delta=0, reduced=0)
    saved = (Gateway._match, refresh_mod.inc.mine_delta, streaming._reduced, Mesh.twin, refresh_mod.compile_rulebook)
    made = []

    def match(gw, *args, **kwargs):   # F9: one batch raises: the follower's once the file is there,
        if short.rank == FAULTS_FOLLOWER:   # the leader's once its load armed it
            armed = not failing["batch"] and os.path.exists(arm)
        else:
            armed = short.rank == 0 and failing["leader"]
        if armed:
            failing["batch"] += 1
            failing["leader"] = False
            raise RuntimeError(f"[mesh-faults] a batch fails on rank {short.rank} on purpose")
        return saved[0](gw, *args, **kwargs)

    def mine_delta(*args, **kwargs):   # F10: the follower's first mine fails inside level 2
        failing["mine_delta"] += 1
        failing["reduced"] = 0
        return saved[1](*args, **kwargs)

    def reduced(*args, **kwargs):
        failing["reduced"] += 1
        if short.rank == FAULTS_FOLLOWER and failing["mine_delta"] == 1 and failing["reduced"] == 2:
            out["raised_at"] = time.time()   # the host's clock, which every rank shares
            raise RuntimeError(f"[mesh-faults] the refresh's mine fails on rank {short.rank} inside level 2")
        return saved[2](*args, **kwargs)

    def twin(m):   # the mine mesh's rebuild after a failed cycle (and its first build)
        t = time.perf_counter()
        new = saved[3](m)
        out["rebuild_s"].append(time.perf_counter() - t)
        return new

    def captured(res, **kw):
        made.append((res, saved[4](res, **kw)))
        return made[-1][1]

    Gateway._match, refresh_mod.inc.mine_delta, streaming._reduced, Mesh.twin = match, mine_delta, reduced, twin
    refresh_mod.compile_rulebook = captured
    ops.reset_launch_counts()
    try:
        gw = Gateway(rb0, mesh=short, device=dev, warmup="ladder", max_batch=64, top_k=10)
        cfg = AprioriConfig(min_support=0.002, max_k=4, representation="packed", data_axes=("data",),
                            model_axis="model")
        ctl = RefreshController(paths["faults"], gw, cfg, mesh=short, device=dev, chunk_rows=STREAM_CHUNK_ROWS,
                                min_confidence=0.4, mode="delta")
        out["rebuild_s"] = []   # the controller's first mine mesh is not a rebuild
        refreshes = []
        try:
            if short.rank == 0:
                def submit(i):
                    return gw.submit(packed[i])

                def arm_leader():
                    failing["leader"] = True

                loads = {}
                for name, mid in (("before", None), ("follower's batch", lambda: open(arm, "w").close()),
                                  ("leader's batch", arm_leader), ("after", None)):
                    gw.cache.evict_generation(gw.generation)
                    loads[name] = _load(submit, mid)
                out["failed_metric"] = gw.metrics.failed
                rows = int(APPEND_FRACTION * open_store(paths["faults"]).num_transactions)
                append_rows(paths["faults"], rows, seed=1)
                for name in ("failing refresh", "clean refresh"):
                    box = {}

                    def refresh():
                        box["t0"] = time.perf_counter()
                        try:
                            box["generation"] = ctl.refresh_now()
                        except RuntimeError as e:
                            box["error"] = str(e)
                        box["t1"], box["ended_at"], box["serving"] = time.perf_counter(), time.time(), gw.generation

                    refresher = threading.Thread(target=refresh, name="mesh-faults-refresh")
                    refresher.start()
                    passes = 0
                    while True:   # passes of the rows until one starts after the refresh has ended
                        ended = not refresher.is_alive()
                        gw.cache.evict_generation(gw.generation)
                        loads[f"{name} pass {passes}"] = _load(submit)
                        passes += 1
                        if ended:
                            break
                    refresher.join()
                    refreshes.append(box)
                out["loads"] = loads
            else:
                for _ in range(2):
                    box = dict(t0=time.perf_counter())
                    try:
                        box["generation"] = ctl.refresh_now()
                    except RuntimeError as e:
                        box["error"] = str(e)
                    box["t1"], box["ended_at"], box["serving"] = time.perf_counter(), time.time(), gw.generation
                    refreshes.append(box)
        finally:
            gw.close()
    finally:
        Gateway._match, refresh_mod.inc.mine_delta, streaming._reduced, Mesh.twin = saved[:4]
        refresh_mod.compile_rulebook = saved[4]
    counts = ops.launch_counts()
    out.update(k1=counts["support_count_packed"], k2=counts["rule_match"], k3=counts["support_count"],
               refreshes=refreshes, batches=gw._batch_seq, history=ctl.history)
    out["digest"] = digest(made[-1][0])
    refs = [recommend(rb, packed, top_k=10, batch_size=1024, device=dev, mesh=short) for rb in (rb0, made[-1][1])]
    if short.rank == 0:
        out["refs"] = [(r.items, r.scores) for r in refs]
    return out


def mesh_faults_phase(paths, want, card):
    """``[mesh-faults]``: F9, a failed batch on a follower and then on the
    leader fails exactly its own requests (each naming the rank), counted
    once in ``failed``, and every rank stays in step; F10, a refresh whose
    mine fails inside level 2 on a follower fails on every rank within the
    groups' timeout + 5 s with the generation kept, and the next is
    dict-identical to ``[delta]``'s ``mine_delta`` on every rank; F11, a
    follower's ``refresh_now`` returns the generation serving there; every
    response bit for bit its generation's mesh ``recommend``."""
    os.makedirs(paths["faults_dir"], exist_ok=True)
    outs, setup_s, total_s = _spawn_mesh(mesh_faults_rank, MESH, paths)
    lead = outs[0]
    loads = lead["loads"]
    for name, load in loads.items():
        for g in sorted(set(load["gens"][load["ok"]].tolist())):
            rows = load["ok"] & (load["gens"] == g)
            items, scores = lead["refs"][g]
            if not (np.array_equal(load["items"][rows], items[rows])
                    and np.array_equal(load["scores"][rows].view(np.uint32), scores[rows].view(np.uint32))):
                raise AssertionError(f"[mesh-faults] {name}: generation {g}'s responses differ from its mesh recommend")
        injected = {"follower's batch": FAULTS_FOLLOWER, "leader's batch": 0}.get(name)
        if sum(load["failed"].values()) or load["ok"].sum() + len(load["errors"]) != REQUESTS:
            raise AssertionError(f"[mesh-faults] {name}: {load['failed']}, {load['ok'].sum()} answered, "
                                 f"{len(load['errors'])} failed of {REQUESTS}")
        if injected is None:
            if load["errors"]:
                raise AssertionError(f"[mesh-faults] {name}: {len(load['errors'])} requests failed: "
                                     f"{load['errors'][0][:2000]}")
        elif not load["errors"] or any(f"rank {injected}: " not in e or "fails on rank" not in e
                                       for e in load["errors"]):
            raise AssertionError(f"[mesh-faults] {name}: {len(load['errors'])} failed requests "
                                 f"{load['errors'][:1]}; want one batch's, naming rank {injected}")
    failed = sum(len(load["errors"]) for load in loads.values())
    if lead["failed_metric"] != failed or any(o["batches"] != lead["batches"] for o in outs):
        raise AssertionError(f"[mesh-faults] failed metric {lead['failed_metric']} for {failed} failed requests; "
                             f"batches a rank {[o['batches'] for o in outs]}")
    for o in outs:
        (bad, good) = o["refreshes"]
        if "error" not in bad or f"rank {FAULTS_FOLLOWER}" not in bad["error"] or bad["serving"] != 0 \
                or good.get("generation") != 1 or good["serving"] != 1 or o["digest"] != want["delta"] \
                or len(o["rebuild_s"]) != 1 or o["k1"] == 0 or o["k2"] == 0 or o["k3"]:
            seen = [(b.get("generation"), b.get("error", "")[:300], b["serving"]) for b in o["refreshes"]]
            raise AssertionError(f"[mesh-faults] rank {o['rank']}: refreshes {seen}, "
                                 f"result equal to [delta]'s {o['digest'] == want['delta']}, rebuilds "
                                 f"{o['rebuild_s']}, K1 {o['k1']}, K2 {o['k2']}, K3 {o['k3']}")
    bad, good = lead["refreshes"]
    fail_s = bad["t1"] - bad["t0"]
    # from the follower's raise to the end of the failed cycle on each rank (the exchange and the rebuild in it)
    let_go = [o["refreshes"][0]["ended_at"] - outs[FAULTS_FOLLOWER]["raised_at"] for o in outs]
    if max(let_go) > FAULTS_TIMEOUT_S + 5:
        raise AssertionError(f"[mesh-faults] the failed cycle ended {let_go} s after the raise")
    passes = {name: set(load["gens"][load["ok"]].tolist()) for name, load in loads.items() if " pass " in name}
    last = [g for name, g in passes.items() if name.startswith("clean")][-1]
    if any(g != {0} for name, g in passes.items() if name.startswith("failing")) or last != {1} \
            or any(not g <= {0, 1} for g in passes.values()):
        raise AssertionError(f"[mesh-faults] generations by pass {passes}")

    def line(load):
        lat = load["latency"][load["ok"]] * 1e3
        return (f"{load['ok'].sum()} answered, {len(load['errors'])} failed, {load['ok'].sum() / load['wall']:.0f} "
                f"qps, p99 {np.percentile(lat, 99):.3f} ms")

    log(f"[mesh-faults] (2, 2) over gloo on the one card, groups' timeout {FAULTS_TIMEOUT_S} s: setup "
        f"{setup_s:.3f} s, whole spawn {total_s:.3f} s [{card}]")
    for name, load in loads.items():
        named = f"; errors name rank {FAULTS_FOLLOWER if 'follower' in name else 0}" if load["errors"] else ""
        log(f"[mesh-faults] {name}: {line(load)}{named} [{card}]")
    followers = " / ".join(f"{o['refreshes'][0]['t1'] - o['refreshes'][0]['t0']:.3f}" for o in outs[1:])
    rebuilds = " / ".join(f"{o['rebuild_s'][0]:.3f}" for o in outs)
    log(f"[mesh-faults] the failed refresh failed on every rank in {fail_s:.3f} s (the leader's refresh_now; "
        f"the followers' {followers} s from their call); it ended on each rank "
        f"{' / '.join(f'{t:.3f}' for t in let_go)} s after the follower's raise, generation 0 kept; the mine mesh "
        f"rebuilt in {rebuilds} s a rank; the clean refresh {good['t1'] - good['t0']:.3f} s, generation 1 serving on "
        "every rank when "
        f"refresh_now returned, dict-identical to [delta]'s mine_delta; K1 "
        f"{' / '.join(str(o['k1']) for o in outs)}, K2 {' / '.join(str(o['k2']) for o in outs)} a rank [{card}]")
    return outs


# The replicated tier on the mesh (F12, F13): one more spawn of the 2 x 2
# mesh, two stages, each on its own copy of the store [delta] built its count
# cache in, with [delta]'s 5,000 rows appended under load.
ROUTER_MESH_REPLICAS = 2     # [mesh-router]: Router(rb, 2, mesh=mesh)
ROUTER_SINGLE_REPLICAS = 3   # [mesh-refresh-router]: Router(rb, 3) on rank 0, as [router]


def _router_healthy(router, generation, timeout=60.0):
    """Leader: wait until every replica is healthy at ``generation``; the
    router's stats then (or at the timeout: the caller checks them)."""
    deadline = time.perf_counter() + timeout
    while True:
        stats = router.stats()
        if all(r["state"] == "healthy" and r["generation"] == generation for r in stats["replicas"]) \
                or time.perf_counter() > deadline:
            return stats
        time.sleep(0.02)


def _passes_during_refresh(ctl, submit, evict):
    """Leader: ``ctl.refresh_now()`` in a thread while the clients send the
    rows in passes (:func:`_load`, each after ``evict()`` empties the
    caches, so batches answer it) until a pass starts after the refresh has
    ended.  Returns (its generation, its (start, end) on this rank's clock,
    the passes)."""
    box = {}

    def refresh():
        box["t0"] = time.perf_counter()
        try:
            box["generation"] = ctl.refresh_now()
        except BaseException as e:  # noqa: BLE001 — raised below
            box["error"] = e
        box["t1"] = time.perf_counter()

    refresher = threading.Thread(target=refresh, name="mesh-router-refresh")
    refresher.start()
    passes = []
    while True:
        ended = not refresher.is_alive()
        evict()
        passes.append(_load(submit))
        if ended:
            break
    refresher.join()
    if "error" in box:
        raise box["error"]
    return box["generation"], (box["t0"], box["t1"]), passes


def _router_stage(mesh, paths, rbs, cfg, out_made, replicas, on_mesh):
    """One stage of :func:`mesh_router_rank`: build the router (on every
    rank, or on rank 0 alone) and its mesh ``RefreshController`` in delta
    mode, the launch counts set to 0 just before and read after both are
    closed.  Rank 0 sends the store's first 4,096 rows from 16 clients
    (``on_mesh``: with replica 0's dispatch worker killed and a coordinated
    swap to ``rbs[1]`` at half load), waits until every replica is healthy,
    appends [delta]'s 5,000 rows and refreshes while the clients send the
    rows in passes; every other rank calls ``refresh_now``."""
    from repro_torch.data.store import open_store
    from repro_torch.distributed import FaultConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.refresh import RefreshController
    from repro_torch.serving.router import Router

    dev, lead = mesh.device, mesh.rank == 0
    path = paths["router_mesh" if on_mesh else "router_single"]
    packed = np.load(paths["requests"])
    st = {}
    ops.reset_launch_counts()
    with WarmCalls() as warms:
        t = time.perf_counter()
        router = None
        if on_mesh or lead:
            router = Router(rbs[0], replicas, mesh=mesh if on_mesh else None, device=dev, warmup="ladder",
                            max_batch=64, top_k=10, fault=FaultConfig(max_retries=3, backoff_s=0.01),
                            attempt_timeout_s=5.0)
        ctl = RefreshController(path, router, cfg, mesh=mesh, device=dev, chunk_rows=STREAM_CHUNK_ROWS,
                                min_confidence=0.4, mode="delta")
        st["build_s"] = time.perf_counter() - t
        try:
            if lead:
                def submit(i):
                    return router.submit(packed[i])

                def mid():
                    router.fault_injection.kill_replica(0)
                    t = time.perf_counter()
                    st["swapped"] = router.hot_swap(rbs[1])
                    st["swap_s"] = time.perf_counter() - t

                loads = [_load(submit, mid if on_mesh else None)]
                st["before"] = _router_healthy(router, 1 if on_mesh else 0)
                t = time.perf_counter()
                st["appended"] = int(APPEND_FRACTION * open_store(path).num_transactions)
                append_rows(path, st["appended"], seed=1)
                st["append_s"] = time.perf_counter() - t

                def evict():
                    for rep in router.replicas:
                        rep.gateway.cache.evict_generation(rep.gateway.generation)

                st["refreshed"], st["window"], passes = _passes_during_refresh(ctl, submit, evict)
                st["refresh_s"] = st["window"][1] - st["window"][0]
                st["loads"] = loads + passes
                st["stats"] = _router_healthy(router, st["refreshed"])
                st["kills_fired"] = router.fault_injection.kills_fired
            else:
                t = time.perf_counter()
                st["refreshed"] = ctl.refresh_now()
                st["refresh_s"] = time.perf_counter() - t
            if router is not None:   # as refresh_now returned
                st["generations"] = [rep.gateway.generation for rep in router.replicas]
        finally:
            if router is not None:
                router.close()
            ctl.close()
    if router is not None:   # every batch served, the leader's last pass included
        st["batches"] = sum(rep.gateway.mesh_timing["batches"] if on_mesh else rep.gateway.metrics.batches
                            for rep in router.replicas)
    counts = ops.launch_counts()
    st.update(k1=counts["support_count_packed"], k2=counts["rule_match"], k3=counts["support_count"],
              warms=warms.calls, history=ctl.history, threads=sorted(
                  t.name for t in threading.enumerate() if t.name.startswith(("gateway-", "refresh-", "router-"))))
    (mine_t0, mine_t1), (res, rb, compiled) = out_made[-2:]
    st["digest"], st["marks"] = digest(res), (mine_t0, mine_t1, compiled)
    return st, rb


def _reshaped_stage(mesh, paths, rb0, cfg, out_made):
    """``[mesh-refresh-reshaped]`` (F14), the last stage of
    :func:`mesh_router_rank`: ``Gateway(rb0, mesh=mesh)`` serving on the
    (2, 2) mesh on every rank, refreshed by ``RefreshController(gateway,
    mesh=mine)`` in delta mode, ``mine`` a (4, 1) mesh of the same ranks
    built here, on its own copy of the refresh store; the launch counts set
    to 0 just before the gateway is built and read after both are closed.
    Rank 0 sends the store's first 4,096 rows from 16 clients, appends
    [delta]'s 5,000 rows and refreshes while the clients send the rows in
    passes; every other rank calls ``refresh_now``."""
    from repro_torch.data.store import open_store
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serving.gateway import Gateway
    from repro_torch.serving.refresh import RefreshController

    dev, lead, path = mesh.device, mesh.rank == 0, paths["reshaped"]
    packed = np.load(paths["requests"])
    mine = Mesh((mesh.size, 1), ("data", "model"), dev, timeout_s=mesh.timeout_s)
    st = dict(mine_shape=list(mine.shape.values()))
    ops.reset_launch_counts()
    with WarmCalls() as warms:
        t = time.perf_counter()
        gw = Gateway(rb0, mesh=mesh, device=dev, warmup="ladder", max_batch=64, top_k=10)
        ctl = RefreshController(path, gw, cfg, mesh=mine, device=dev, chunk_rows=STREAM_CHUNK_ROWS,
                                min_confidence=0.4, mode="delta")
        st["build_s"] = time.perf_counter() - t
        try:
            if lead:
                def submit(i):
                    return gw.submit(packed[i])

                loads = [_load(submit)]
                t = time.perf_counter()
                st["appended"] = int(APPEND_FRACTION * open_store(path).num_transactions)
                append_rows(path, st["appended"], seed=1)
                st["append_s"] = time.perf_counter() - t
                st["refreshed"], st["window"], passes = _passes_during_refresh(
                    ctl, submit, lambda: gw.cache.evict_generation(gw.generation))
                st["refresh_s"] = st["window"][1] - st["window"][0]
                st["loads"] = loads + passes
                st["latency"] = gw.stats()["latency"]
            else:
                t = time.perf_counter()
                st["refreshed"] = ctl.refresh_now()
                st["refresh_s"] = time.perf_counter() - t
            st["generation"] = gw.generation   # as refresh_now returned
        finally:
            gw.close()
            ctl.close()
    counts = ops.launch_counts()
    st.update(k1=counts["support_count_packed"], k2=counts["rule_match"], k3=counts["support_count"],
              warms=warms.calls, batches=gw.mesh_timing["batches"], history=ctl.history, threads=sorted(
                  t.name for t in threading.enumerate() if t.name.startswith(("gateway-", "refresh-", "router-"))))
    (mine_t0, mine_t1), (res, rb, compiled) = out_made[-2:]
    st["digest"], st["marks"] = digest(res), (mine_t0, mine_t1, compiled)
    return st, rb


def mesh_router_rank(mesh, paths):
    """One rank of the replicated tier on the (2, 2) mesh:
    ``[mesh-router]`` (F13), ``Router(rb, 2, mesh=mesh)`` on every rank with
    ``RefreshController(router, mesh=mesh)``, then ``[mesh-refresh-router]``
    (F12), ``Router(rb, 3)`` of single-device gateways on rank 0 (the other
    ranks pass None) with ``RefreshController(router, mesh=mesh)`` on every
    rank (:func:`_router_stage`), then ``[mesh-refresh-reshaped]`` (F14), a
    mesh gateway refreshed by a mine on a (4, 1) mesh (:func:`_reshaped_stage`).
    Then, as references, every rank's mesh ``recommend`` of each of
    ``[mesh-router]``'s and ``[mesh-refresh-reshaped]``'s generations and rank 0's
    single-device ``recommend`` of each of ``[mesh-refresh-router]``'s, and
    K2 at this rank's blocks of a full bucket of the refreshed rulebook
    (rank 0: the whole bucket and rulebook, on its one device) against its
    plain versions."""
    ready = _rank_setup(mesh)
    from repro_torch.core.apriori import AprioriConfig
    from repro_torch.serving import refresh as refresh_mod
    from repro_torch.serving.recommend import recommend
    from repro_torch.serving.rulebook import Rulebook, place_rulebook

    dev = mesh.device
    packed = np.load(paths["requests"])
    rbs = [Rulebook.load(paths["rulebook"]), Rulebook.load(paths["rulebook_swap"])]
    cfg = AprioriConfig(min_support=0.002, max_k=4, representation="packed", data_axes=("data",),
                        model_axis="model")
    made = []
    compile_rulebook = refresh_mod.compile_rulebook

    def captured(res, **kw):   # each refresh's result and rulebook, as references
        rb = compile_rulebook(res, **kw)
        made.append((res, rb, time.perf_counter()))
        return rb

    mine_delta = refresh_mod.inc.mine_delta

    def timed_mine(*args, **kwargs):   # each refresh's mine, its span on this rank's clock
        t = time.perf_counter()
        res = mine_delta(*args, **kwargs)
        made.append((t, time.perf_counter()))
        return res

    refresh_mod.compile_rulebook, refresh_mod.inc.mine_delta = captured, timed_mine
    try:
        router, rb_mesh = _router_stage(mesh, paths, rbs, cfg, made, ROUTER_MESH_REPLICAS, on_mesh=True)
        single, rb_single = _router_stage(mesh, paths, rbs, cfg, made, ROUTER_SINGLE_REPLICAS, on_mesh=False)
        reshaped, rb_reshaped = _reshaped_stage(mesh, paths, rbs[0], cfg, made)
    finally:
        refresh_mod.compile_rulebook, refresh_mod.inc.mine_delta = compile_rulebook, mine_delta
    out = dict(rank=mesh.rank, ready=ready, router=router, single=single, reshaped=reshaped)
    refs = [recommend(rb, packed, top_k=10, batch_size=1024, device=dev, mesh=mesh)
            for rb in (rbs[0], rbs[1], rb_mesh, rb_reshaped)]
    router["k2_block"] = _k2_at_blocks(mesh, rb_mesh, packed, dev)
    if mesh.rank == 0:
        router["refs"] = [(r.items, r.scores) for r in refs[:3]]
        reshaped["refs"] = [router["refs"][0], (refs[3].items, refs[3].scores)]
        singles = [recommend(place_rulebook(rb, dev), packed, top_k=10, batch_size=1024, device=dev)
                   for rb in (rbs[0], rb_single)]
        single["refs"] = [(r.items, r.scores) for r in singles]
        single["k2_block"] = _k2_at_blocks(None, rb_single, packed, dev)
    return out


def _check_loads(tag, loads, refs, singles=None):
    """Zero drops in every load; every response bit for bit ``refs`` of its
    generation (by basket), and, where ``singles`` is given, within rtol
    1e-5, atol 1e-6 of those (items equal except at ties).  Returns the
    generations of each load."""
    seen = []
    for n, load in enumerate(loads):
        if not load["ok"].all() or load["errors"] or sum(load["failed"].values()):
            raise AssertionError(f"[{tag}] load {n}: {int(load['ok'].sum())} answered of {REQUESTS}, "
                                 f"{load['failed']}, {load['errors'][:1]}")
        gens = sorted(set(load["gens"].tolist()))
        for g in gens:
            rows = load["gens"] == g
            items, scores = refs[g]
            if not (np.array_equal(load["items"][rows], items[rows])
                    and np.array_equal(load["scores"][rows].view(np.uint32), scores[rows].view(np.uint32))):
                raise AssertionError(f"[{tag}] load {n}: generation {g}'s responses differ from its recommend")
            if singles is not None:
                w_items, w_scores = (np.asarray(x)[rows] for x in singles[g])
                np.testing.assert_allclose(load["scores"][rows], w_scores, rtol=RTOL, atol=ATOL)
                tie = np.abs(np.diff(w_scores, axis=1)) <= ATOL + RTOL * np.abs(w_scores[:, 1:])
                close = np.zeros_like(w_scores, dtype=bool)
                close[:, 1:] |= tie
                close[:, :-1] |= tie
                if not np.array_equal(load["items"][rows][~close], w_items[~close]):
                    raise AssertionError(f"[{tag}] load {n}: generation {g}'s items differ from its single-device "
                                         "recommend")
        seen.append(gens)
    return seen


def _window_line(st, last="exchange, swap and hand-over"):
    """The requests answered inside the leader's ``refresh_now`` (count,
    qps, p50 / p99, from the passes sent during it), and in each of its
    stages on the leader: the start (the key or the command, the rows
    check), the mine, the compile, then ``last`` (the outcomes' exchange,
    the swap and the hand-over; or the exchange, the place and the
    commit)."""
    t0, t1 = st["window"]
    passes = st["loads"][1:]
    done = np.concatenate([p["done"] for p in passes])
    lat = np.concatenate([p["latency"] for p in passes]) * 1e3

    def inside(a, z):
        got = lat[(done >= a) & (done <= z)]
        return (f"{got.size} answered, {got.size / (z - a):.0f} qps"
                + (f", p50 {np.percentile(got, 50):.3f} ms, p99 {np.percentile(got, 99):.3f} ms" if got.size else ""))

    marks = [t0, *st["marks"], t1]
    stages = "; ".join(f"{name} {z - a:.3f} s: {inside(a, z)}" for name, a, z in
                       zip(("start", "mine", "compile", last), marks, marks[1:]))
    return f"inside it {inside(t0, t1)}; by stage on the leader: {stages}"


def mesh_router_phase(paths, want, want_by_gen, card):
    """``[mesh-router]`` (F13), ``[mesh-refresh-router]`` (F12) and
    ``[mesh-refresh-reshaped]`` (F14, a mesh gateway as the target, its
    mine on a (4, 1) mesh) in one spawn of the (2, 2) mesh
    (:func:`mesh_router_rank`).  Each stage: zero
    drops; every response bit for bit its generation's ``recommend`` (the
    mesh one for F13, the single-device one for F12; K2's ordered sum
    makes both independent of the batch) and, for F13 and F14, within rtol
    1e-5, atol 1e-6 of the single-device one; after the refresh every replica
    healthy on one generation on every rank, and the refresh dict-identical
    to ``[delta]``'s ``mine_delta`` on every rank; K1 launched on every
    rank, K2 on every rank that serves (every rank in F13, rank 0 in F12),
    K2 exactly one launch a warm ladder's bucket plus one a batch; K2 at
    each rank's blocks bit for bit ``rule_match_ordered``."""
    outs, setup_s, total_s = _spawn_mesh(mesh_router_rank, MESH, paths)
    lead = outs[0]
    fr, fs = lead["router"], lead["single"]
    # F13
    gens = _check_loads("mesh-router", fr["loads"], fr["refs"],
                        {0: want_by_gen[0], 1: want_by_gen[1], 2: fs["refs"][1]})
    if gens[0] != [0, 1] or any(not set(g) <= {1, 2} for g in gens[1:]) or gens[-1] != [2] \
            or fr["kills_fired"] != 1 or fr["swapped"] != 1:
        raise AssertionError(f"[mesh-router] generations by load {gens}, kills {fr['kills_fired']}")
    # F12
    gens_single = _check_loads("mesh-refresh-router", fs["loads"], {0: fs["refs"][0], 1: fs["refs"][1]})
    if gens_single[0] != [0] or any(not set(g) <= {0, 1} for g in gens_single[1:]) or gens_single[-1] != [1]:
        raise AssertionError(f"[mesh-refresh-router] generations by load {gens_single}")
    for o in outs:
        for tag, st, gen, ladder, serves in (("mesh-router", o["router"], 2, MESH_LADDER, True),
                                             ("mesh-refresh-router", o["single"], 1, LADDER, o["rank"] == 0)):
            history = [(h["generation"], h["mode"]) for h in st["history"]]
            if st["refreshed"] != gen or history != [(gen, "delta")] or st["digest"] != want["delta"] \
                    or st["k1"] == 0 or st["k3"] or st["threads"]:
                raise AssertionError(f"[{tag}] rank {o['rank']}: generation {st['refreshed']}, history {history}, "
                                     f"result equal to [delta]'s {st['digest'] == want['delta']}, K1 {st['k1']}, "
                                     f"K3 {st['k3']}, threads left {st['threads']}")
            k2_want = st["warms"] * len(ladder) + st.get("batches", 0)
            if (st["k2"] == 0) == serves or st["k2"] != k2_want \
                    or (serves and st["generations"] != [gen] * len(st["generations"])):
                raise AssertionError(f"[{tag}] rank {o['rank']}: K2 {st['k2']} for {st['warms']} warm ladders and "
                                     f"{st.get('batches')} batches; replica generations {st.get('generations')}")
            blk = st.get("k2_block")
            if blk is not None and (not blk["ordered"] or blk["max_abs_err"] > ATOL + RTOL * 100):
                raise AssertionError(f"[{tag}] rank {o['rank']}: K2 at its blocks differs from its plain versions")
    for tag, st in (("mesh-router", fr), ("mesh-refresh-router", fs)):
        states = [(r["state"], r["generation"]) for r in st["stats"]["replicas"]]
        if len(set(states)) != 1 or states[0] != ("healthy", st["refreshed"]):
            raise AssertionError(f"[{tag}] replicas after the refresh: {states}")
    # F14
    rs = lead["reshaped"]
    gens_reshaped = _check_loads("mesh-refresh-reshaped", rs["loads"], rs["refs"],
                                 {0: want_by_gen[0], 1: fs["refs"][1]})
    if gens_reshaped[0] != [0] or any(not set(g) <= {0, 1} for g in gens_reshaped[1:]) or gens_reshaped[-1] != [1]:
        raise AssertionError(f"[mesh-refresh-reshaped] generations by load {gens_reshaped}")
    for o in outs:
        st = o["reshaped"]
        history = [(h["generation"], h["mode"]) for h in st["history"]]
        if (st["refreshed"], st["generation"], history) != (1, 1, [(1, "delta")]) or st["digest"] != want["delta"] \
                or st["k1"] == 0 or st["k3"] or st["threads"] or st["mine_shape"] != [4, 1]:
            raise AssertionError(f"[mesh-refresh-reshaped] rank {o['rank']}: generation {st['refreshed']} "
                                 f"({st['generation']} serving), history {history}, result equal to [delta]'s "
                                 f"{st['digest'] == want['delta']}, K1 {st['k1']}, K3 {st['k3']}, threads left "
                                 f"{st['threads']}")
        if st["warms"] != 2 or st["k2"] != st["warms"] * len(MESH_LADDER) + st["batches"]:
            raise AssertionError(f"[mesh-refresh-reshaped] rank {o['rank']}: K2 {st['k2']} for {st['warms']} warm "
                                 f"ladders and {st['batches']} batches")
    log(f"[mesh-router] (2, 2) over gloo on the one card, both stages in one spawn: setup {setup_s:.3f} s, whole "
        f"spawn {total_s:.3f} s [{card}]")
    for tag, key, what in (("mesh-router", "router", f"Router(rb, {ROUTER_MESH_REPLICAS}, mesh=mesh)"),
                           ("mesh-refresh-router", "single", f"Router(rb, {ROUTER_SINGLE_REPLICAS}) on rank 0")):
        st = lead[key]
        walls = [load["wall"] for load in st["loads"]]
        lat, before = st["stats"]["latency"], st["before"]
        window = _window_line(st)
        followers = " / ".join(f"{o[key]['refresh_s']:.3f}" for o in outs[1:])
        swap = (f"; replica 0's worker killed ({st['kills_fired']} kill) and a coordinated swap to generation "
                f"{st['swapped']} in {st['swap_s']:.3f} s at half load" if "swapped" in st else "")
        per_batch = REQUESTS * len(walls) / st["batches"]
        log(f"[{tag}] {what}, built with its controller in {st['build_s']:.3f} s; the first load {walls[0]:.3f} s = "
            f"{REQUESTS / walls[0]:.0f} qps{swap}; {st['batches']} batches on rank 0 over its replicas, "
            f"{per_batch:.2f} requests a batch; failovers {before['failovers']}, worker restarts "
            f"{before['supervisor']['restarts']}; then {len(walls) - 1} passes during and after the refresh of "
            f"{' / '.join(f'{w:.3f}' for w in walls[1:])} s = {' / '.join(f'{REQUESTS / w:.0f}' for w in walls[1:])} "
            f"qps; router p50 {lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms [{card}]")
        log(f"[{tag}] appended {st['appended']} rows in {st['append_s']:.3f} s; the leader's refresh_now "
            f"{st['refresh_s']:.3f} s to generation {st['refreshed']}, {window}; the followers' refresh_now "
            f"{followers} s from their call [{card}]")
    for o in outs:
        r, s1 = o["router"], o["single"]
        blk = r["k2_block"]
        log(f"[mesh-router] rank {o['rank']}: K1 {r['k1']} / {s1['k1']}, K2 {r['k2']} / {s1['k2']} launches in "
            f"[mesh-router] / [mesh-refresh-router] ({r['warms']} / {s1['warms']} warm ladders, {r['batches']} / "
            f"{s1.get('batches', 0)} batches); K2 at its blocks of a full bucket of the refreshed rulebook "
            f"({blk['baskets']} baskets x {blk['rules']} rules) {blk['ms']:.4f} ms, plain {blk['plain_ms']:.3f} ms, "
            f"bit for bit rule_match_ordered [{card}]")
    blk = fs["k2_block"]
    log(f"[mesh-refresh-router] rank 0: K2 at a full bucket of the refreshed rulebook on its one device "
        f"({blk['baskets']} baskets x {blk['rules']} rules) {blk['ms']:.4f} ms, plain {blk['plain_ms']:.3f} ms, bit "
        f"for bit rule_match_ordered [{card}]")
    log(f"[mesh-router] zero drops in both stages; every response bit for bit its generation's recommend (mesh / "
        f"single device); every replica healthy on generation {fr['refreshed']} / {fs['refreshed']} after the "
        f"refresh; every rank's refresh dict-identical to [delta]'s mine_delta")
    walls, lat = [load["wall"] for load in rs["loads"]], rs["latency"]
    followers = " / ".join(f"{o['reshaped']['refresh_s']:.3f}" for o in outs[1:])
    log(f"[mesh-refresh-reshaped] Gateway(rb, mesh=(2, 2)) refreshed by RefreshController(gateway, "
        f"mesh={tuple(rs['mine_shape'])}), built with its controller in {rs['build_s']:.3f} s; the first load "
        f"{walls[0]:.3f} s = {REQUESTS / walls[0]:.0f} qps; {rs['batches']} batches, "
        f"{REQUESTS * len(walls) / rs['batches']:.2f} requests a batch; then {len(walls) - 1} passes during and "
        f"after the refresh of {' / '.join(f'{w:.3f}' for w in walls[1:])} s = "
        f"{' / '.join(f'{REQUESTS / w:.0f}' for w in walls[1:])} qps; gateway p50 {lat['p50_ms']:.3f} ms, p99 "
        f"{lat['p99_ms']:.3f} ms [{card}]")
    log(f"[mesh-refresh-reshaped] appended {rs['appended']} rows in {rs['append_s']:.3f} s; the leader's "
        f"refresh_now {rs['refresh_s']:.3f} s to generation {rs['refreshed']}, "
        f"{_window_line(rs, 'exchange, place and commit')}; the followers' refresh_now {followers} s from their "
        f"call [{card}]")
    for o in outs:
        st = o["reshaped"]
        log(f"[mesh-refresh-reshaped] rank {o['rank']}: K1 {st['k1']}, K2 {st['k2']} launches ({st['warms']} warm "
            f"ladders of {len(MESH_LADDER)}, {st['batches']} batches); generation {st['generation']} serving when "
            f"refresh_now returned [{card}]")
    log("[mesh-refresh-reshaped] zero drops; every response bit for bit its generation's mesh recommend on the "
        "(2, 2) mesh and within tolerance of the single-device one; every rank's mine on the (4, 1) mesh "
        "dict-identical to [delta]'s mine_delta")
    return outs



def mesh_cli_phase(card):
    """``[mesh-cli]``: the mine CLI under ``torchrun`` on a 2 x 2 mesh (4
    ranks on the card, gloo) prints the single-device CLI's last line,
    timings aside."""
    flags = ["--transactions", "100000", "--items", "1000", "--avg-len", "10", "--seed", "0",
             "--min-support", "0.002", "--max-k", "4", "--representation", "packed"]
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    lines = {}
    for name, cmd in {
        "single": [sys.executable, "-m", "repro_torch.launch.mine", *flags],
        "mesh": [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
                 "-m", "repro_torch.launch.mine", *flags, "--mesh", "2x2", "--backend", "gloo"],
    }.items():
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"[mesh-cli] {name} exited {proc.returncode}: {proc.stderr[-3000:]}")
        last = json.loads(proc.stdout.strip().splitlines()[-1])
        lines[name] = (last.pop("seconds"), last, time.perf_counter() - t0)
    if lines["single"][1] != lines["mesh"][1]:
        raise AssertionError(f"[mesh-cli] {lines['mesh'][1]} != {lines['single'][1]}")
    log(f"[mesh-cli] torchrun --nproc-per-node 4 ... --mesh 2x2: {json.dumps(lines['mesh'][1])}, the single-device "
        f"CLI's line; mine {lines['mesh'][0]:.3f} s vs {lines['single'][0]:.3f} s, process wall "
        f"{lines['mesh'][2]:.3f} s vs {lines['single'][2]:.3f} s [{card}]")


# ------------------------------------------------------------- module 6 ---
def roofline_phase(roofline, dev, card):
    """``[roofline]``: the part ``detect_chip`` reads off the card, beside
    ``nvidia-smi``'s name and power limit."""
    chip = roofline.detect_chip(dev)
    log(f"[roofline] {torch.cuda.get_device_name(dev)} -> part {chip.part} ({chip.label}, data sheet at "
        f"{chip.power_w:.0f} W): bf16 {chip.bf16_flop_per_s:.3e} flop/s, int8 {chip.int8_op_per_s:.3e} op/s, "
        f"fp32 {chip.fp32_flop_per_s:.3e} flop/s, int32 {chip.int32_op_per_s:.3e} op/s, HBM "
        f"{chip.hbm_bytes_per_s:.3e} B/s, NVLink {chip.nvlink_bytes_per_s:.3e} B/s a direction [{card}]")
    return chip


def static_cost_phase(store, root, card):
    """``[static-cost]``: the mine CLI with ``--store --metrics-out`` on the
    store at 8,192-row chunks (the default dense representation, K3): the
    ``static_cost`` block carries the JAX CLI's keys, no ``error``, and
    the flops of one dispatch of 8,192 rows against the largest bucket."""
    metrics = os.path.join(root, "static-metrics.json")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.mine", "--store", store.path,
           "--stream-chunk-rows", str(STREAM_CHUNK_ROWS), "--min-support", "0.002", "--max-k", "4",
           "--metrics-out", metrics]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[static-cost] the mine CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
    static = json.load(open(metrics))["static_cost"]
    keys = {"rows_per_dispatch", "candidate_rows", "flops_per_dispatch", "hbm_bytes_per_dispatch",
            "roofline_s_per_dispatch", "roofline_dominant", "useful_flops_per_dispatch", "useful_flops_ratio",
            "count_dispatches", "measured_count_kernel_s", "measured_vs_roofline"}
    if set(static) != keys:
        raise AssertionError(f"[static-cost] the block's keys {sorted(static)} are not the JAX CLI's")
    kp = static["candidate_rows"]
    if static["flops_per_dispatch"] != 2 * STREAM_CHUNK_ROWS * store.num_items * kp or \
            static["rows_per_dispatch"] != STREAM_CHUNK_ROWS:
        raise AssertionError(f"[static-cost] {static}")
    log(f"[static-cost] mine CLI --store --metrics-out in {wall:.1f} s: {json.dumps(static)}")
    log(f"[static-cost] {static['count_dispatches']} dispatches of {STREAM_CHUNK_ROWS} rows x {kp} candidates: "
        f"roofline {static['roofline_s_per_dispatch'] * 1e3:.4f} ms a dispatch ({static['roofline_dominant']}), "
        f"measured count_kernel phase {static['measured_count_kernel_s']:.4f} s = "
        f"{static['measured_vs_roofline']:.2f} x the roofline [{card}]")
    return static


def dryrun_phase():
    """``[dryrun]``: the three production variants at the JAX defaults,
    walked on meta tensors (no device)."""
    from repro_torch.launch import mine_dryrun

    t0 = time.perf_counter()
    recs = [mine_dryrun.run(v) for v in mine_dryrun.VARIANTS]
    wall = time.perf_counter() - t0
    flops = 2.0 * 4096 * 2048 * 65536
    if any(r["flops_per_dev"] != flops for r in recs):
        raise AssertionError(f"[dryrun] per-rank flops {[r['flops_per_dev'] for r in recs]} != {flops:.4e}")
    # one all-reduce a rank: the whole (K,) counts on paper_1d, the rank's
    # K/16 block over the data axes on the 2-D layouts (the JAX dry run's)
    if [r["coll_per_dev"] for r in recs] != [65536 * 4, 65536 // 16 * 4, 65536 // 16 * 4]:
        raise AssertionError(f"[dryrun] collective bytes a rank {[r['coll_per_dev'] for r in recs]}")
    log(f"[dryrun] {wall:.2f} s, N = 2^20 x I = 2,048 x K = 2^16 on 16 x 16, one rank on the H100 SXM "
        f"data sheet: {json.dumps(recs)}")
    return recs


EXAMPLES = ["quickstart", "mine_corpus", "serve_rules", "mine_out_of_core", "serve_gateway",
            "serve_refresh", "serve_replicated", "serve_slo", "distributed_mining"]
# run an example as ``__main__`` (so spawned ranks find its functions), then
# print the launch counts of this process
_RUN_EXAMPLE = ("import json, runpy, sys; path = sys.argv[1]; sys.argv = sys.argv[1:]; "
                "runpy.run_path(path, run_name='__main__'); "
                "from repro_torch.kernels import ops; print(json.dumps(ops.launch_counts()))")


EXAMPLE_LANES = 4   # single-process examples run this many at a time; distributed_mining alone


def run_example(name, env):
    """One example as a subprocess: (argv extras, wall s, stdout lines)."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "examples", "torch", f"{name}.py")
    extra = ["--kill-resume"] if name == "mine_out_of_core" else []
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _RUN_EXAMPLE, path, *extra], capture_output=True,
                          text=True, env=env, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        raise AssertionError(f"[examples] {name} exited {proc.returncode}: {proc.stderr[-4000:]}")
    return extra, wall, proc.stdout.strip().splitlines()


def examples_phase(card):
    """``[examples]``: each of the nine examples in ``examples/torch`` as a
    subprocess on the card at its defaults (``mine_out_of_core`` with
    ``--kill-resume``): each exits 0; its wall and the launches of its own
    process (not of its spawned ranks or its killed child) are logged.  The
    eight single-process examples share the card :data:`EXAMPLE_LANES` at a
    time, so their walls include each other's host work;
    ``distributed_mining`` (8 ranks) runs alone after them."""
    from concurrent.futures import ThreadPoolExecutor

    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    singles = [n for n in EXAMPLES if n != "distributed_mining"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=EXAMPLE_LANES) as pool:
        runs = dict(zip(singles, pool.map(lambda n: run_example(n, env), singles)))
    singles_s = time.perf_counter() - t0
    runs["distributed_mining"] = run_example("distributed_mining", env)
    out = {}
    for name in EXAMPLES:
        extra, wall, lines = runs[name]
        launches = json.loads(lines[-1])
        out[name] = dict(wall_s=wall, launches=launches)
        shown = lines[-6:-1] if name == "distributed_mining" else lines[-2:-1]
        log(f"[examples] {name} {' '.join(extra)} exited 0 in {wall:.2f} s; launches {launches} [{card}]")
        for line in shown:
            log(f"[examples]   {name}: {line[:200]}")
    log(f"[examples] the eight single-process examples, {EXAMPLE_LANES} at a time: {singles_s:.2f} s; "
        f"distributed_mining alone: {out['distributed_mining']['wall_s']:.2f} s [{card}]")
    return out


def mesh_nccl_phase(streaming, ops, paths, want, passes, dev, card):
    """``[mesh-nccl]``: ``[mesh]`` with NCCL, one rank a card, where the
    machine has at least 2 cards."""
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"[mesh-nccl] not run: {cards} card here, and NCCL takes one rank a card (two ranks of one "
            f"communicator on one card are refused)")
        return
    mesh_phase(streaming, ops, paths, want, passes, dev, card, backend="nccl", device="cuda", tag="mesh-nccl",
               shape=(2, 1) if cards < 4 else MESH)


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
    from repro_torch.launch import roofline
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
    global CHIP
    CHIP = roofline_phase(roofline, dev, card)

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
        static_cost_phase(store, root, card)

        # ---- the serving tier over the store: gateway, hot swap, delta
        # mining, refresh, router and the serve CLI; each phase sets the
        # launch counts to 0 just before its run and reads them just after
        packed = np.array(next(store.iter_chunks(REQUESTS))[0][:REQUESTS])
        serving = dict(gateway=gateway_phase(ops, rb, packed, rec, dev, card))
        rb2, want2, serving["swap"] = gateway_swap_phase(streaming, ops, store, rb, packed, rec, dev, card)
        delta_path, delta_res, serving["delta"] = delta_phase(streaming, son_mod, ops, store, cfg, root, dev, card)
        serving["refresh"] = refresh_phase(streaming, son_mod, ops, delta_path, delta_res, cfg, packed, dev, card)
        serving["router"] = router_phase(ops, rb, rb2, packed, rec, want2, dev, card)
        serving["cli"] = serve_cli_phase(store, root, dev, card)
        log(f"[serving] {json.dumps(serving)}")

        # ---- the mesh: 4-6 ranks on the card over gloo, each rank's launch
        # counts set to 0 just before each of its paths and read just after
        paths = dict(db=os.path.join(root, "db.npy"), store=store.path, delta=os.path.join(root, "delta-mesh"),
                     ckpt=os.path.join(root, "mesh-ckpt"), rulebook=os.path.join(root, "rulebook.npz"))
        np.save(paths["db"], db)
        rb_host.save(paths["rulebook"])
        want = dict(main=digest(res), delta=digest(delta_res))
        mesh_passes = dict(packed=passes, dense=dense_passes)
        mesh_outs = mesh_phase(streaming, ops, paths, want, mesh_passes, dev, card)
        mesh_1d_phase(paths, want, mesh_passes, card)
        rec_outs = mesh_recommend_phase(paths, rec, card)
        paths.update(requests=os.path.join(root, "requests.npy"), refresh=os.path.join(root, "refresh-mesh"),
                     rulebook_swap=os.path.join(root, "rulebook-swap.npz"), faults=os.path.join(root, "faults-mesh"),
                     faults_dir=os.path.join(root, "faults"), router_mesh=os.path.join(root, "router-mesh"),
                     router_single=os.path.join(root, "router-single"), reshaped=os.path.join(root, "refresh-reshaped"))
        for copy in ("faults", "router_mesh", "router_single", "reshaped"):   # each appends [delta]'s rows to its own
            shutil.copytree(paths["refresh"], paths[copy])
        np.save(paths["requests"], packed)
        rb2.to_host().save(paths["rulebook_swap"])
        gw_outs = mesh_gateway_phase(paths, want, {0: (rec.items, rec.scores), 1: (want2.items, want2.scores)}, card,
                                     [o["delta"]["wall"] for o in mesh_outs])
        mesh_faults_phase(paths, want, card)
        router_outs = mesh_router_phase(paths, want, {0: (rec.items, rec.scores), 1: (want2.items, want2.scores)},
                                        card)
        mesh_cli_phase(card)
        mesh_nccl_phase(streaming, ops, paths, want, mesh_passes, dev, card)

    # ---- module 6: the dry run (no device) and the nine examples on the card
    dryrun_phase()
    examples = examples_phase(card)

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
             stream_event_ms_per_launch=k1_stream["event_ms_per_launch"],
             swap_mine_launches=serving["swap"]["k1"], build_cache_launches=serving["delta"]["build_launches"],
             delta_launches=serving["delta"]["launches"], refresh_launches=serving["refresh"]["k1"],
             mesh_launches_per_rank=[o["mine"]["launches"] for o in mesh_outs],
             mesh_ms_per_rank=[o["k1"]["ms"] for o in mesh_outs],
             mesh_shape_per_rank=[mesh_outs[0]["k1"]["rows"], mesh_outs[0]["k1"]["cands"]],
             mesh_refresh_launches_per_rank=[o["k1"] for o in gw_outs],
             mesh_router_launches_per_rank=[o["router"]["k1"] for o in router_outs],
             mesh_refresh_router_launches_per_rank=[o["single"]["k1"] for o in router_outs],
             mesh_refresh_reshaped_launches_per_rank=[o["reshaped"]["k1"] for o in router_outs],
             examples_launches={n: e["launches"]["support_count_packed"] for n, e in examples.items()}),
        dict(name="rule_match", route="cuda", source="src/repro_torch/kernels/csrc/rule_match.cu",
             replaces="src/repro/kernels/rule_match.py:86", launches=k2_launches,
             max_abs_err=k2["max_abs_err"], ms=k2["ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by=k2["bound_by"], library_ms=None,
             all_match_ms=k2["all_match_ms"],
             stream_launches=k2_stream["launches"], stream_ms_per_launch=k2_stream["ms_per_launch"],
             stream_event_ms_per_launch=k2_stream["event_ms_per_launch"],
             gateway_launches=serving["gateway"]["launches"], gateway_bucket_ms=serving["gateway"]["bucket_ms"],
             swap_launches=serving["swap"]["k2"], refresh_launches=serving["refresh"]["k2"],
             router_launches=serving["router"]["launches"],
             mesh_launches_per_rank=[o["launches"] for o in rec_outs],
             mesh_ms_per_rank=[o["ms"] for o in rec_outs],
             mesh_shape_per_rank=[rec_outs[0]["baskets"], rec_outs[0]["rules"]],
             mesh_gateway_launches_per_rank=[o["k2"] for o in gw_outs],
             mesh_gateway_launches_during_the_refresh_mine_per_rank=[o["mine"]["k2"] for o in gw_outs],
             mesh_gateway_ms_per_rank=[o["k2_block"]["ms"] for o in gw_outs],
             mesh_gateway_shape_per_rank=[gw_outs[0]["k2_block"]["baskets"], gw_outs[0]["k2_block"]["rules"]],
             mesh_router_launches_per_rank=[o["router"]["k2"] for o in router_outs],
             mesh_router_ms_per_rank=[o["router"]["k2_block"]["ms"] for o in router_outs],
             mesh_refresh_router_launches_per_rank=[o["single"]["k2"] for o in router_outs],
             mesh_refresh_router_ms=router_outs[0]["single"]["k2_block"]["ms"],
             mesh_refresh_reshaped_launches_per_rank=[o["reshaped"]["k2"] for o in router_outs],
             examples_launches={n: e["launches"]["rule_match"] for n, e in examples.items()}),
        dict(name="support_count", route="cuda", source="src/repro_torch/kernels/csrc/support_count.cu",
             replaces="src/repro/kernels/support_count.py:69", launches=k3_launches,
             max_abs_err=k3["bf16"]["max_abs_err"], ms=k3["bf16"]["ms"], plain_ms=k3["bf16"]["plain_ms"],
             bound_ms=k3["bf16"]["bound_ms"], bound_by=k3["bf16"]["bound_by"], library_ms=None,
             gemm_ms=k3["bf16"]["gemm_ms"],
             stream_launches=k3_stream["launches"], stream_ms_per_launch=k3_stream["ms_per_launch"],
             stream_event_ms_per_launch=k3_stream["event_ms_per_launch"],
             mesh_launches_per_rank=[o["dense"]["launches"] for o in mesh_outs],
             mesh_ms_per_rank=[o["k3"]["ms"] for o in mesh_outs],
             mesh_shape_per_rank=[mesh_outs[0]["k3"]["rows"], mesh_outs[0]["k3"]["cands"]],
             examples_launches={n: e["launches"]["support_count"] for n, e in examples.items()}),
    ]
    log(f"[k1] popcount mode at the same shape: {json.dumps(k1['popcount'])} [{card}]")
    log(f"[k3] int8 operands at the same shape: {json.dumps(k3['int8'])} [{card}]")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
