"""Batched basket -> recommendation query engine (DESIGN.md §8).

The serving loop over a compiled rulebook: baskets are packed to the uint32
bitset word layout, streamed through the K2 rule-match kernel in fixed-size
batches, and each basket's per-item evidence scores are reduced to top-k
item recommendations — items already in the basket are masked to ``-inf``
first unless ``exclude_basket=False``.  Ties go to the lowest item id, as
in the JAX package (a stable descending sort; ``torch.topk`` does not
promise that order).

On a mesh (``launch.mesh``) the match step is the same Map/Reduce shape as
mining, flipped: baskets split by rows over the data axes (the query "HDFS
blocks") while the rulebook splits by rows over ``rule_axis``; each rank
runs K2 on its rule block and its basket block, the rule axis sums the
blocks' partial (B, I) scores (``core.mapreduce``, a reduce over the
*model* axis where mining reduces over *data*), each rank takes the top-k
of its baskets, and every rank assembles the whole result
(:func:`match_batch`, which the mesh gateway runs too).  The blocks are
added in rule-block order (``mapreduce.ordered_sum``), so a basket's
scores are the same bits whatever batch it rides in.  They are not bit for
bit the single device's: K2 sums each rule block in ascending rule order
from zero, where one device carries one sum through all the rules.

``recommend_python`` is the per-basket pure-Python engine — the oracle for
tests and the baseline for the batched engine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import itemsets as enc
from repro_torch.core.mapreduce import MapReduceJob, gather_blocks, mapreduce, shard_rows
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import mesh_device
from repro_torch.kernels import ref as kref
from repro_torch.serving.rulebook import Rulebook, place_rulebook


@dataclasses.dataclass
class RecommendResult:
    """Top-k recommendations per basket.  ``scores == -inf`` marks slots
    beyond the basket's candidate items (k larger than what's scoreable)."""

    items: np.ndarray    # (B, top_k) int32 item ids
    scores: np.ndarray   # (B, top_k) float32 aggregated rule evidence


def pack_baskets(baskets, num_items: int) -> np.ndarray:
    """Item-id lists or a dense {0,1} matrix -> packed uint32 (B, W) bitsets.

    A 2-D ndarray is always the dense form and must be exactly ``num_items``
    wide — a mismatched matrix is an error, never reinterpreted as id lists."""
    if isinstance(baskets, np.ndarray) and baskets.ndim == 2:
        if baskets.shape[1] != num_items:
            raise ValueError(
                f"dense baskets are {baskets.shape[1]} items wide but the "
                f"rulebook vocabulary is {num_items}"
            )
        return enc.pack_bits(baskets)
    return enc.pack_bits(enc.dense_from_lists(list(baskets), num_items))


def make_match_step(*, impl: str = "auto", mesh=None, rule_axis: str = "model", on_map=None):
    """The batched match step
    ``fn(b_packed (B, W), ante, lens, cons, scores) -> (B, 32·W) float32``
    on the operands' device (``kernels.ops.rule_match``).  On a mesh the
    operands are this rank's basket and rule blocks, and the step sums the
    rule blocks' scores over ``rule_axis`` in block order; ``on_map()``, if
    given, runs between K2 and that sum (a timer's lap)."""

    def match_step(b, a, ln, c, s):
        return kops.rule_match(b, a, ln, c, s, impl=impl)

    if mesh is None:
        return match_step
    job = MapReduceJob(map_fn=match_step, reduce_axes=(rule_axis,), reduce_op="ordered_sum")
    return mapreduce(job, mesh, on_map=on_map)


def _to_device(blk: np.ndarray, device) -> torch.Tensor:
    """One batch of int32 basket words onto the rulebook's device (H2D)."""
    blk = np.ascontiguousarray(blk)
    if not blk.flags.writeable:   # e.g. rows of a store shard's read-only mmap
        blk = blk.copy()
    return torch.from_numpy(blk).to(device)


def _to_host(idx: torch.Tensor, vals: torch.Tensor, m: int):
    """The first ``m`` rows of a batch's top-k back to numpy (D2H)."""
    return idx.cpu().numpy()[:m], vals.cpu().numpy()[:m]


def batch_gathers(mesh, rows: int, words: int, top_k: int, data_axes: tuple = ("data",),
                  rule_axis: str = "model") -> list:
    """The all-gathers :func:`match_batch` sends on a mesh for a batch of
    ``rows`` baskets of ``words`` words, each ``(axes, bytes a rank
    sends)``: the rule axis's partial scores (``ordered_sum``), then the
    data axes' top-k ids and scores.  A ``StepFaults`` plan."""
    local = rows // mesh.shard(tuple(data_axes))[1]
    return [((rule_axis,), local * 32 * words * 4), (tuple(data_axes), local * 2 * top_k * 4)]


def match_batch(step, blk: np.ndarray, rb: Rulebook, *, top_k: int, exclude_basket: bool, mesh=None,
                data_axes: tuple = ("data",), lap=None, faults=None):
    """One padded batch of int32 basket words (host, (B, W)) through match
    and top-k: ``(idx int32, vals float32)`` numpy arrays of all B rows.

    On a mesh every rank calls it with the same batch: it takes its row
    block over ``data_axes``, ``step`` (:func:`make_match_step` on the mesh)
    matches it against its rule block and sums the rule blocks, it takes
    the top-k of its rows, and one all-gather over the data axes hands
    every rank the whole batch's.  ``lap(name)``, if given, is called at
    each stage's end: on one card after the copy to the device ("h2d"),
    the match's launch ("match"), the top-k ("topk") and the copy back
    ("d2h"); on a mesh after the top-k ("topk") and after that gather
    ("gather").  ``faults`` (a ``mapreduce.StepFaults`` of
    :func:`batch_gathers`) rides both all-gathers: the caller reads
    ``faults.ranks`` after."""
    one = lap if mesh is None else None   # the stages only one card laps
    if mesh is not None:
        blk = shard_rows(blk, mesh, data_axes)
    blk_dev = _to_device(blk, rb.device)
    if one is not None:
        one("h2d")
    cols = (rb.ante_packed, rb.ante_len, rb.cons_packed, rb.scores)
    item_scores = step(blk_dev, *cols) if faults is None else step(blk_dev, *cols, faults=faults)
    if one is not None:
        one("match")
    idx, vals = _topk_items(item_scores, blk_dev, top_k=top_k, exclude_basket=exclude_basket,
                            num_items=rb.num_items)
    if lap is not None:
        lap("topk")
    if mesh is None:
        out = _to_host(idx, vals, blk.shape[0])
        if lap is not None:
            lap("d2h")
        return out
    # ids and the float bits of the scores travel as one int32 block
    both = gather_blocks(torch.cat([idx, vals.view(torch.int32)], dim=1).cpu(), mesh, data_axes, faults)
    if lap is not None:
        lap("gather")
    both = both.numpy()
    return both[:, :top_k].copy(), both[:, top_k:].view(np.float32).copy()


def _topk_items(item_scores, b_packed, *, top_k: int, exclude_basket: bool, num_items: int):
    """Mask basket items, then the top_k scores per row with ties broken by
    lowest item id.  Returns (idx int32, vals float32) tensors."""
    item_scores = item_scores[:, :num_items]
    if exclude_basket:
        in_basket = kref.unpack_bits_ref(b_packed, num_items) > 0
        item_scores = item_scores.masked_fill(in_basket, float("-inf"))
    vals, idx = torch.sort(item_scores, dim=1, descending=True, stable=True)
    return idx[:, :top_k].to(torch.int32), vals[:, :top_k]


def recommend(
    rb: Rulebook,
    baskets,
    *,
    top_k: int = 10,
    batch_size: int = 1024,
    impl: str = "auto",
    exclude_basket: bool = True,
    device="cuda",
    mesh=None,
    data_axes: tuple = ("data",),
    rule_axis: str = "model",
    match_step=None,
) -> RecommendResult:
    """Batched end-to-end query loop: pack -> match -> mask -> top-k.

    ``baskets``: item-id lists, a dense {0,1} matrix, or pre-packed uint32
    bitsets.  Every batch is padded to ``batch_size`` (zero baskets are
    inert), so every match runs at one shape.  A host rulebook is placed on
    ``device`` once per call; pass a placed one (``place_rulebook``) to
    reuse it across calls.

    On a ``mesh`` (every rank calls with the same baskets) ``batch_size`` is
    rounded up to the data-shard count, the rulebook is (or was) placed on
    the mesh over ``rule_axis``, and every rank returns the whole result.
    """
    dev = mesh_device(device, mesh)
    w = enc.packed_words(rb.num_items)
    b_np = np.asarray(baskets) if not isinstance(baskets, (list, tuple)) else None
    if b_np is not None and b_np.dtype == np.uint32 and b_np.ndim == 2 and b_np.shape[1] == w:
        b_packed = b_np
    else:
        b_packed = pack_baskets(baskets, rb.num_items)
    n = b_packed.shape[0]
    top_k = min(top_k, rb.num_items)

    if mesh is not None:
        data_axes = tuple(data_axes)
        if rule_axis in data_axes or set(data_axes + (rule_axis,)) - set(mesh.axes):
            raise ValueError(f"data_axes {data_axes} and rule_axis {rule_axis!r} must be distinct "
                             f"axes of the mesh {tuple(mesh.axes)}")
        shards = mesh.shard(data_axes)[1]
        batch_size = -(-batch_size // shards) * shards
    if rb.device is None:
        # commit the columns to the device ONCE — not re-uploaded per batch
        rb = place_rulebook(rb, dev, mesh=mesh, rule_axis=rule_axis)
    elif rb.device.type != dev.type:
        raise ValueError(f"rulebook is placed on {rb.device} but device={dev}")
    placed_on = (rb.shard.mesh, rb.shard.rule_axis) if rb.shard is not None else (None, rule_axis)
    if placed_on != (mesh, rule_axis):
        raise ValueError("the rulebook was placed for another mesh or rule axis than this call's; "
                         "place it with place_rulebook(rb, mesh=mesh, rule_axis=rule_axis)")
    step = match_step or make_match_step(impl=impl, mesh=mesh, rule_axis=rule_axis)

    b_words = np.ascontiguousarray(b_packed, dtype=np.uint32).view(np.int32)
    items_out = np.zeros((n, top_k), np.int32)
    scores_out = np.zeros((n, top_k), np.float32)
    for start in range(0, n, batch_size):
        blk = b_words[start : start + batch_size]
        m = blk.shape[0]
        if m < batch_size:
            blk = np.pad(blk, ((0, batch_size - m), (0, 0)))
        idx, vals = match_batch(step, blk, rb, top_k=top_k, exclude_basket=exclude_basket, mesh=mesh,
                                data_axes=data_axes)
        items_out[start : start + m], scores_out[start : start + m] = idx[:m], vals[:m]
    return RecommendResult(items=items_out, scores=scores_out)


def rulebook_as_python(rb: Rulebook) -> list[tuple[frozenset, np.ndarray, float]]:
    """Decode a rulebook into (antecedent set, consequent item ids, score)
    triples — the working set of :func:`recommend_python`."""
    h = rb.to_host()
    keep = h.ante_len >= 0
    ante = enc.unpack_bits(h.ante_packed[keep], rb.num_items)
    cons = enc.unpack_bits(h.cons_packed[keep], rb.num_items)
    scores = h.scores[keep]
    return [
        (frozenset(np.flatnonzero(a).tolist()), np.flatnonzero(c), float(s))
        for a, c, s in zip(ante, cons, scores)
    ]


def recommend_python(
    rb: Rulebook,
    baskets,
    *,
    top_k: int = 10,
    exclude_basket: bool = True,
    decoded=None,
) -> RecommendResult:
    """Naive per-basket rule matching — oracle and baseline.

    Same semantics as :func:`recommend`: summed score evidence per
    consequent item over matched rules, basket items masked to ``-inf``,
    ties broken by lowest item id.
    """
    rules = rulebook_as_python(rb) if decoded is None else decoded
    if isinstance(baskets, np.ndarray) and baskets.dtype == np.uint32:
        baskets = enc.unpack_bits(baskets, rb.num_items)
    if isinstance(baskets, np.ndarray) and baskets.ndim == 2:
        baskets = [np.flatnonzero(row).tolist() for row in np.asarray(baskets)]
    top_k = min(top_k, rb.num_items)

    items_out = np.zeros((len(baskets), top_k), np.int32)
    scores_out = np.zeros((len(baskets), top_k), np.float32)
    for b, basket in enumerate(baskets):
        bset = set(int(x) for x in basket)
        acc = np.zeros(rb.num_items, np.float64)
        for ante, cons, score in rules:
            if ante <= bset:
                acc[cons] += score
        if exclude_basket:
            acc[sorted(bset)] = -np.inf
        idx = np.lexsort((np.arange(rb.num_items), -acc))[:top_k]
        items_out[b] = idx
        scores_out[b] = acc[idx]
    return RecommendResult(items=items_out, scores=scores_out)
