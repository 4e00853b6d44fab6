"""Plain PyTorch versions of the kernels, on any device.

Packed words are ``int32`` views of the uint32 bitsets: ``&`` and ``==`` are
bit-identical on the view, and every right shift is followed by ``& 1``
because an int32 shift sign-extends.  The CPU tests hold these against the
JAX package's oracles; on the card they are what each CUDA kernel is
compared with.
"""

from __future__ import annotations

import torch

# elements of one (rows, candidates, words) intermediate in the blocked forms
_BLOCK_ELEMS = 1 << 25


def support_count_ref(t_dense, c_dense, lengths):
    """Exact support counts over dense {0,1} operands.

    t_dense: (N, I) {0,1}, c_dense: (K, I) {0,1}, of any dtype.
    lengths: (K,) int32 itemset sizes (``len = -1`` marks padding rows,
             which never match: an intersection is >= 0).
    returns: (K,) int32 — #transactions t with <t, c> == len.

    The JAX oracle multiplies in int32.  Torch on CUDA has no int32 matrix
    product, so the intersections are a float32 product on every device.
    That is exact while I < 2^24: every product is 0 or 1 and every partial
    sum an integer, whatever the order of the sum.  TF32 would round no
    {0,1} operand either, but callers on the card keep it off
    (``torch.backends.cuda.matmul.allow_tf32 = False``) so that this
    stays a full float32 product and makes no claim on TF32's rounding.
    Materialises the (N, K) intersections; see :func:`support_count_blocked`.
    """
    inter = t_dense.to(torch.float32) @ c_dense.to(torch.float32).T
    return (inter == lengths.to(torch.float32)[None, :]).sum(dim=0, dtype=torch.int32)


def support_count_blocked(t_dense, c_dense, lengths, block_k: int = 512):
    """:func:`support_count_ref` over candidate blocks, so the float32
    intersection never grows past (N, block_k).  Blocks are slices, so no
    padding row exists; the result equals the unblocked form exactly."""
    k = c_dense.shape[0]
    t32 = t_dense.to(torch.float32)
    counts = torch.empty(k, dtype=torch.int32, device=c_dense.device)
    for k0 in range(0, k, block_k):
        blk = slice(k0, k0 + block_k)
        counts[blk] = support_count_ref(t32, c_dense[blk], lengths[blk])
    return counts


def support_count_packed_ref(t_packed, c_packed, lengths=None, block_k: int = 256):
    """Exact support counts over packed bitsets.

    t_packed: (N, W) int32, c_packed: (K, W) int32 word views.
    lengths:  optional (K,) int32 itemset sizes; rows with ``len = -1`` are
              padding and never match.  Without lengths every row counts
              as a real candidate (the JAX oracle pads its last K block with
              all-ones rows that are sliced off; blocks here are slices, so
              no padding row exists).
    returns:  (K,) int32 — #{n : ∀w t[n,w] & c[k,w] == c[k,w]}.
    Blocked over K and N so the (bn, bk, W) intermediate stays bounded.
    """
    n, w = t_packed.shape
    k = c_packed.shape[0]
    counts = torch.zeros(k, dtype=torch.int32, device=c_packed.device)
    block_n = max(1, _BLOCK_ELEMS // max(1, block_k * w))
    for k0 in range(0, k, block_k):
        c_blk = c_packed[k0 : k0 + block_k]
        for n0 in range(0, n, block_n):
            t_blk = t_packed[n0 : n0 + block_n]
            inter = t_blk[:, None, :] & c_blk[None, :, :]
            contained = (inter == c_blk[None, :, :]).all(dim=-1)
            counts[k0 : k0 + block_k] += contained.sum(dim=0, dtype=torch.int32)
    if lengths is not None:
        counts = torch.where(lengths.to(torch.int32) >= 0, counts, torch.zeros_like(counts))
    return counts


def support_count_packed_popcount_ref(t_packed, c_packed, lengths, block_k: int = 256):
    """Popcount-mode twin: Σ_w popcount(t & c) == len (bit-for-bit the dense
    semantics).  Agrees with :func:`support_count_packed_ref` whenever
    ``lengths`` are the true popcounts or -1."""
    n, w = t_packed.shape
    k = c_packed.shape[0]
    counts = torch.zeros(k, dtype=torch.int32, device=c_packed.device)
    block_n = max(1, _BLOCK_ELEMS // max(1, block_k * w))
    for k0 in range(0, k, block_k):
        c_blk = c_packed[k0 : k0 + block_k]
        ln = lengths[k0 : k0 + block_k].to(torch.int32)
        for n0 in range(0, n, block_n):
            inter = t_packed[n0 : n0 + block_n][:, None, :] & c_blk[None, :, :]
            pop = popcount32(inter).sum(dim=-1, dtype=torch.int32)
            counts[k0 : k0 + block_k] += (pop == ln[None, :]).sum(dim=0, dtype=torch.int32)
    return counts


def item_bitmaps(t_packed):
    """Packed rows (N, W) int32 -> item bitmaps (32·W, ceil(N/32)) int32:
    bit r of word j of item i is bit i of row 32·j + r, zero past N.  The
    plain version of K1's transpose; bits are OR-ed into the int32 words (F3)."""
    n, w = t_packed.shape
    nb = -(-n // 32)
    shifts = torch.arange(32, dtype=torch.int32, device=t_packed.device)
    bits = ((t_packed[:, :, None] >> shifts) & 1).reshape(n, 32 * w)
    bits = torch.nn.functional.pad(bits, (0, 0, 0, 32 * nb - n)).reshape(nb, 32, 32 * w)
    out = torch.zeros((32 * w, nb), dtype=torch.int32, device=t_packed.device)
    for r in range(32):
        out |= bits[:, r, :].T << r
    return out


def support_count_bitmaps(bitmaps, c_packed, lengths, n: int, mode: str = "and_cmp", block_k: int = 256):
    """Support counts from item bitmaps (32·W, NB) int32 of ``n`` rows, the
    plain version of K1's count, exact in both modes for any lengths.

    Each candidate adds its items' bitmaps into a bit-sliced counter (one
    plane per bit of its item count m), so a row's plane bits spell how many
    of the candidate's items it holds; the count is the rows whose counter
    equals the target.  and_cmp: target m (every item held), 0 where
    ``len < 0``.  popcount: target ``len``, 0 where len < 0 or len > m.
    Bits of rows at or past ``n`` are masked: an empty candidate would
    count them.
    """
    items, nb = bitmaps.shape
    k, w = c_packed.shape
    dev = c_packed.device
    cbits = unpack_bits_ref(c_packed, 32 * w).to(torch.bool)[:, :items]
    m = cbits.sum(dim=1)
    ln = lengths.to(torch.int64)
    target = m if mode == "and_cmp" else ln
    live = (ln >= 0) & (target <= m)
    rows = torch.arange(32 * nb, device=dev).reshape(nb, 32) < n
    row_mask = torch.zeros(nb, dtype=torch.int32, device=dev)
    for r in range(32):
        row_mask |= rows[:, r].to(torch.int32) << r
    counts = torch.zeros(k, dtype=torch.int32, device=dev)
    for k0 in range(0, k, block_k):
        blk = slice(k0, k0 + block_k)
        sel_blk, tgt = cbits[blk], target[blk]
        planes = [torch.zeros((sel_blk.shape[0], nb), dtype=torch.int32, device=dev)
                  for _ in range(max(1, int(m[blk].max().item()).bit_length()))]
        for item in torch.nonzero(sel_blk.any(dim=0)).flatten().tolist():
            carry = bitmaps[item][None, :] * sel_blk[:, item, None].to(torch.int32)
            for p, plane in enumerate(planes):
                planes[p], carry = plane ^ carry, plane & carry
        eq = torch.full((sel_blk.shape[0], nb), -1, dtype=torch.int32, device=dev)
        for p, plane in enumerate(planes):
            eq &= torch.where(((tgt >> p) & 1).bool()[:, None], plane, ~plane)
        eq &= row_mask[None, :]
        counts[blk] = popcount32(eq).sum(dim=1, dtype=torch.int32)
    return torch.where(live, counts, torch.zeros_like(counts))


def popcount32(x):
    """Per-element popcount of int32 word views (SWAR; torch has no popcount
    op).  Each mask clears the bits an arithmetic shift drags in from the
    sign, so the result is the popcount of the uint32 word."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def unpack_bits_ref(packed, num_items: int):
    """Packed int32 word view (R, W) -> dense {0,1} float32 (R, num_items),
    little-endian bits per word (the torch twin of ``core.itemsets.unpack_bits``)."""
    r, w = packed.shape
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(r, w * 32)[:, :num_items].to(torch.float32)


def rule_match_ref(b_packed, a_packed, lengths, c_packed, scores):
    """Per-item rule-evidence scores.

    b_packed: (B, W) int32 basket words; a_packed / c_packed: (R, W) int32
    antecedent / consequent words; lengths: (R,) int32 (-1 = padding row);
    scores: (R,) float32.
    returns:  (B, 32·W) float32 — out[b, i] = Σ_r [a_r ⊆ b] · [len_r ≥ 0] · s_r · c_r[i]
    """
    contains = ((b_packed[:, None, :] & a_packed[None, :, :]) == a_packed[None, :, :]).all(dim=-1)
    matched = contains & (lengths.to(torch.int32) >= 0)[None, :]
    weights = matched.to(torch.float32) * scores.to(torch.float32)[None, :]
    cons_dense = unpack_bits_ref(c_packed, 32 * c_packed.shape[1])
    return weights @ cons_dense


def rule_match_ordered(b_packed, a_packed, lengths, c_packed, scores):
    """:func:`rule_match_ref` as K2 sums it, bit for bit: every out[b, i]
    starts at +0 and adds the matched rules' scores one fp32 add at a time,
    in ascending rule order.

    Builds the matched weights as :func:`rule_match_ref` does (containment
    over basket blocks, so the (bn, R, W) intermediate stays bounded), then
    adds ``w[:, r] * cons_r`` for r ascending over the rules that some
    basket of the batch matched.  Every product is s_r or 0 exactly, and a
    rule that no basket matched would add +0 everywhere, so skipping it
    changes no bit.  One elementwise add per matched rule: slow, a check
    only.
    """
    n, w = b_packed.shape
    r = a_packed.shape[0]
    matched = torch.empty((n, r), dtype=torch.bool, device=b_packed.device)
    block_n = max(1, _BLOCK_ELEMS // max(1, r * w))
    for n0 in range(0, n, block_n):
        blk = b_packed[n0 : n0 + block_n]
        matched[n0 : n0 + block_n] = ((blk[:, None, :] & a_packed[None]) == a_packed[None]).all(dim=-1)
    matched &= (lengths.to(torch.int32) >= 0)[None, :]
    weights = matched.to(torch.float32) * scores.to(torch.float32)[None, :]
    cons_dense = unpack_bits_ref(c_packed, 32 * w)
    out = torch.zeros((n, 32 * w), dtype=torch.float32, device=b_packed.device)
    for rule in torch.nonzero(matched.any(dim=0)).flatten().tolist():
        out += weights[:, rule, None] * cons_dense[rule]
    return out


def rule_match_blocked(b_packed, a_packed, lengths, c_packed, scores, block_n: int = 512):
    """:func:`rule_match_ref` over basket blocks, so the (bn, R, W)
    containment intermediate stays bounded for large batches.  Rows are
    independent, so the result equals the unblocked form."""
    n, w = b_packed.shape
    out = torch.empty((n, 32 * w), dtype=torch.float32, device=b_packed.device)
    for n0 in range(0, n, block_n):
        out[n0 : n0 + block_n] = rule_match_ref(
            b_packed[n0 : n0 + block_n], a_packed, lengths, c_packed, scores
        )
    return out
