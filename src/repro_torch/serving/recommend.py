"""Batched basket -> recommendation query engine (DESIGN.md §8).

The serving loop over a compiled rulebook: baskets are packed to the uint32
bitset word layout, streamed through the K2 rule-match kernel in fixed-size
batches, and each basket's per-item evidence scores are reduced to top-k
item recommendations — items already in the basket are masked to ``-inf``
first unless ``exclude_basket=False``.  Ties go to the lowest item id, as
in the JAX package (a stable descending sort; ``torch.topk`` does not
promise that order).

``recommend_python`` is the per-basket pure-Python engine — the oracle for
tests and the baseline for the batched engine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import itemsets as enc
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
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


def make_match_step(*, impl: str = "auto"):
    """The batched match step
    ``fn(b_packed (B, W), ante, lens, cons, scores) -> (B, 32·W) float32``
    on the operands' device (``kernels.ops.rule_match``)."""

    def match_step(b, a, ln, c, s):
        return kops.rule_match(b, a, ln, c, s, impl=impl)

    return match_step


def _to_device(blk: np.ndarray, device) -> torch.Tensor:
    """One batch of int32 basket words onto the rulebook's device (H2D)."""
    blk = np.ascontiguousarray(blk)
    if not blk.flags.writeable:   # e.g. rows of a store shard's read-only mmap
        blk = blk.copy()
    return torch.from_numpy(blk).to(device)


def _to_host(idx: torch.Tensor, vals: torch.Tensor, m: int):
    """The first ``m`` rows of a batch's top-k back to numpy (D2H)."""
    return idx.cpu().numpy()[:m], vals.cpu().numpy()[:m]


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
    match_step=None,
) -> RecommendResult:
    """Batched end-to-end query loop: pack -> match -> mask -> top-k.

    ``baskets``: item-id lists, a dense {0,1} matrix, or pre-packed uint32
    bitsets.  Every batch is padded to ``batch_size`` (zero baskets are
    inert), so every match runs at one shape.  A host rulebook is placed on
    ``device`` once per call; pass a placed one (``place_rulebook``) to
    reuse it across calls.
    """
    dev = resolve_device(device)
    w = enc.packed_words(rb.num_items)
    b_np = np.asarray(baskets) if not isinstance(baskets, (list, tuple)) else None
    if b_np is not None and b_np.dtype == np.uint32 and b_np.ndim == 2 and b_np.shape[1] == w:
        b_packed = b_np
    else:
        b_packed = pack_baskets(baskets, rb.num_items)
    n = b_packed.shape[0]
    top_k = min(top_k, rb.num_items)

    if rb.device is None:
        # commit the columns to the device ONCE — not re-uploaded per batch
        rb = place_rulebook(rb, dev)
    elif rb.device.type != dev.type:
        raise ValueError(f"rulebook is placed on {rb.device} but device={dev}")
    step = match_step or make_match_step(impl=impl)

    b_words = np.ascontiguousarray(b_packed, dtype=np.uint32).view(np.int32)
    items_out = np.zeros((n, top_k), np.int32)
    scores_out = np.zeros((n, top_k), np.float32)
    for start in range(0, n, batch_size):
        blk = b_words[start : start + batch_size]
        m = blk.shape[0]
        if m < batch_size:
            blk = np.pad(blk, ((0, batch_size - m), (0, 0)))
        blk_dev = _to_device(blk, rb.device)
        item_scores = step(blk_dev, rb.ante_packed, rb.ante_len, rb.cons_packed, rb.scores)
        idx, vals = _topk_items(
            item_scores, blk_dev,
            top_k=top_k, exclude_basket=exclude_basket, num_items=rb.num_items,
        )
        items_out[start : start + m], scores_out[start : start + m] = _to_host(idx, vals, m)
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
