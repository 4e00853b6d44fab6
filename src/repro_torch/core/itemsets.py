"""Itemset / transaction encodings (host-side NumPy).

The dense format is a {0,1} int8 matrix over the item vocabulary:
transactions (N, I) and candidate itemsets (K, I).  Containment ``c ⊆ t``
then becomes ``<t, c> == |c|`` (DESIGN.md §2).

The packed uint32 bitset format (N, ceil(I/32)) is the other device format
(DESIGN.md §4): containment ``c ⊆ t`` becomes per-word
``t & c == c``, at 1 bit per cell.  Device tensors hold these words as an
``int32`` view (torch has no uint32 right shift on the CPU); the view is
bit-identical, so ``pack_bits(x).view(np.int32)`` is what goes to the card.
Packed padding invariants: padded transaction rows are
all-zero words (inert), padded candidate rows are all-zero words with
``|c| = -1`` sentinels in the lengths vector (never match), and the word
axis pads with zero words on both operands (DESIGN.md §3).
"""

from __future__ import annotations

import numpy as np


def dense_from_lists(transactions, num_items: int) -> np.ndarray:
    """Lists of item ids -> dense {0,1} int8 matrix (N, num_items)."""
    out = np.zeros((len(transactions), num_items), dtype=np.int8)
    for row, items in enumerate(transactions):
        if len(items):
            idx = np.asarray(list(items), dtype=np.int64)
            if (idx < 0).any() or (idx >= num_items).any():
                raise ValueError(f"item id out of range in transaction {row}")
            out[row, idx] = 1
    return out


def itemsets_to_dense(itemsets: np.ndarray, num_items: int) -> np.ndarray:
    """(K, k) arrays of item ids -> dense {0,1} int8 matrix (K, num_items)."""
    itemsets = np.asarray(itemsets)
    if itemsets.ndim != 2:
        raise ValueError("itemsets must be (K, k)")
    k_count = itemsets.shape[0]
    out = np.zeros((k_count, num_items), dtype=np.int8)
    rows = np.repeat(np.arange(k_count), itemsets.shape[1])
    out[rows, itemsets.ravel()] = 1
    return out


def pack_bits(dense: np.ndarray) -> np.ndarray:
    """Dense {0,1} (N, I) -> packed uint32 (N, ceil(I/32)), little-endian bits."""
    dense = np.asarray(dense, dtype=np.uint8)
    n, i = dense.shape
    words = (i + 31) // 32
    padded = np.zeros((n, words * 32), dtype=np.uint8)
    padded[:, :i] = dense
    bits = padded.reshape(n, words, 32)
    shifts = np.arange(32, dtype=np.uint32)
    return (bits.astype(np.uint32) << shifts).sum(axis=2, dtype=np.uint32)


def unpack_bits(packed: np.ndarray, num_items: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`."""
    packed = np.asarray(packed, dtype=np.uint32)
    n, words = packed.shape
    shifts = np.arange(32, dtype=np.uint32)
    bits = (packed[:, :, None] >> shifts) & np.uint32(1)
    return bits.reshape(n, words * 32)[:, :num_items].astype(np.int8)


def packed_words(num_items: int) -> int:
    """Number of uint32 words holding ``num_items`` bits."""
    return (num_items + 31) // 32


def itemsets_to_packed(itemsets: np.ndarray, num_items: int) -> np.ndarray:
    """(K, k) arrays of item ids -> packed uint32 bitsets (K, ceil(I/32)).

    Direct scatter into words — never materialises the (K, I) dense matrix,
    so candidate packing stays O(K·k) on the driver regardless of vocabulary
    size.
    """
    itemsets = np.asarray(itemsets)
    if itemsets.ndim != 2:
        raise ValueError("itemsets must be (K, k)")
    if itemsets.size and (itemsets.min() < 0 or itemsets.max() >= num_items):
        raise ValueError("item id out of range")
    k_count = itemsets.shape[0]
    out = np.zeros((k_count, packed_words(num_items)), dtype=np.uint32)
    rows = np.repeat(np.arange(k_count), itemsets.shape[1])
    ids = itemsets.ravel().astype(np.int64)
    np.bitwise_or.at(out, (rows, ids >> 5), np.uint32(1) << (ids & 31).astype(np.uint32))
    return out


def singleton_itemsets(num_items: int) -> np.ndarray:
    """All 1-itemsets, (num_items, 1)."""
    return np.arange(num_items, dtype=np.int32)[:, None]
