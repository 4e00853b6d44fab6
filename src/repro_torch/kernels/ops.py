"""Public wrappers around the CUDA kernels.

Each wrapper checks its operands (device, dtype, shape, contiguity) and then
chooses by where the tensors live: CUDA tensors launch the kernel (or the
launch raises), CPU tensors take the plain version in ``kernels/ref.py``.
There is no fallback from one to the other.

``impl`` selects explicitly:
  * ``"auto"``   — by device (the default, and what the main path uses);
  * ``"kernel"`` — the CUDA kernel only; raises on CPU tensors;
  * ``"ref"``    — the plain version, on whatever device the tensors are.

Padding semantics (DESIGN.md §3) carry over unchanged: zero transaction
rows, candidate rows with ``len = -1``, zero words, and rule rows with
``len = -1`` and score 0 are all inert.  Packed words are ``int32`` views of
the uint32 bitsets.

Each wrapper adds one to its entry in :data:`LAUNCHES` where it launches its
kernel, and nowhere else.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import support_count as k3

IMPLS = ("auto", "kernel", "ref")
MODES = ("and_cmp", "popcount")

DENSE_DTYPES = tuple(dtype for _, dtype in k3.DTYPES.values())
MAX_DENSE_ITEMS = 1 << 24  # bf16 sums stay exact integers in float32 below this
PACK_ROWS = 1 << 16        # rows packed at once by pack_bits_device

LAUNCHES = {"support_count_packed": 0, "rule_match": 0, "support_count": 0}
_LAUNCHES_LOCK = threading.Lock()  # SON's phase-1 mappers launch from several threads


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> dict:
    with _LAUNCHES_LOCK:
        return dict(LAUNCHES)


def _count_launch(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def _use_kernel(impl: str, device: torch.device, name: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"{name}: impl must be one of {IMPLS}, got {impl!r}")
    if impl == "ref":
        return False
    if device.type == "cuda":
        return True
    if impl == "kernel":
        raise RuntimeError(f"{name}: impl='kernel' needs CUDA tensors, got {device}")
    return False


def _check(name: str, x: torch.Tensor, dtype, ndim: int, device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def support_count_packed(t_packed, c_packed, lengths, *, impl: str = "auto", mode: str = "and_cmp"):
    """Support counts over packed bitset operands (exact int32).

    t_packed: (N, W) int32, c_packed: (K, W) int32, lengths: (K,) int32 with
    ``len = -1`` marking padded candidate rows.  Any (N, W, K).
    Returns (K,) int32 on the operands' device.
    """
    dev = t_packed.device
    _check("t_packed", t_packed, torch.int32, 2, dev)
    _check("c_packed", c_packed, torch.int32, 2, dev)
    _check("lengths", lengths, torch.int32, 1, dev)
    if c_packed.shape[1] != t_packed.shape[1]:
        raise ValueError("transaction and candidate word counts must agree")
    if lengths.shape[0] != c_packed.shape[0]:
        raise ValueError("lengths must have one entry per candidate row")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not _use_kernel(impl, dev, "support_count_packed"):
        if mode == "popcount":
            return ref.support_count_packed_popcount_ref(t_packed, c_packed, lengths)
        return ref.support_count_packed_ref(t_packed, c_packed, lengths)
    from repro_torch.kernels import support_count_packed as k1

    out = k1.launch(t_packed, c_packed, lengths, mode)
    _count_launch("support_count_packed")
    return out


def _check_dense(name: str, x: torch.Tensor, device) -> None:
    _check(name, x, x.dtype if isinstance(x, torch.Tensor) else None, 2, device)
    if x.dtype not in DENSE_DTYPES:
        raise TypeError(f"{name} must be int8 or bfloat16 {{0,1}}, got {x.dtype}")


def pack_bits_device(dense: torch.Tensor, num_items: int | None = None) -> torch.Tensor:
    """Dense {0,1} (R, I) -> packed (R, ceil(I/32)) int32 word views on the
    operand's device, little-endian bits per word: the torch twin of
    ``core.itemsets.pack_bits``.

    The JAX package sums the shifted bits in uint32, which wraps at 32 bits;
    a torch sum would widen (F3).  Here the bits are OR-ed into int32 words,
    so a word with bit 31 set holds the same 32 bits (negative in the view).
    Rows go in blocks of :data:`PACK_ROWS`, so the int32 widening of the
    bits never holds more than a block (the whole DB's would take 8 bytes a
    cell on the device).
    """
    r, i = dense.shape
    if num_items is not None and num_items != i:
        raise ValueError(f"pack_bits_device: {i} item columns, expected {num_items}")
    words = (i + 31) // 32
    out = torch.zeros((r, words), dtype=torch.int32, device=dense.device)
    for start in range(0, r, PACK_ROWS):
        block = dense[start : start + PACK_ROWS]
        bits = torch.nn.functional.pad(block.to(torch.int32), (0, words * 32 - i))
        bits = bits.reshape(block.shape[0], words, 32)
        acc = out[start : start + PACK_ROWS]
        for b in range(32):
            acc |= bits[:, :, b] << b
    return out


def unpack_bits_device(words: torch.Tensor, num_items: int, width: int | None = None,
                       dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Packed (R, W) int32 word views -> dense {0,1} (R, width) in ``dtype``
    on the words' device: the torch twin of ``core.itemsets.unpack_bits``,
    and the inverse of :func:`pack_bits_device`.

    Columns ``[num_items, width)`` are zero whatever the words hold past
    ``num_items``; ``width`` defaults to ``num_items`` and may be below or
    above ``32·W`` (the dense count step takes ``support_count.item_width``).
    Each bit is ``(word >> b) & 1``: on an int32 view the shift is arithmetic,
    so the mask is what keeps a word with bit 31 set exact (F2).
    """
    r, w = words.shape
    width = num_items if width is None else width
    if not 0 <= num_items <= 32 * w or width < num_items:
        raise ValueError(f"unpack_bits_device: {num_items} items from {w} words into {width} columns")
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = ((words[:, :, None] >> shifts) & 1).reshape(r, 32 * w)[:, :num_items].to(dtype)
    return torch.nn.functional.pad(bits, (0, width - num_items))


def support_count(t_dense, c_dense, lengths, *, impl: str = "auto", operand_dtype: str = "bf16"):
    """Support counts over dense {0,1} operands (exact int32).

    t_dense: (N, I), c_dense: (K, I), int8 or bfloat16 {0,1}; lengths: (K,)
    int32 with ``len = -1`` marking padded candidate rows.  Any (N, I, K) on
    the plain route.  The kernel route takes both operands already in the
    operand dtype with the item axis padded to
    ``kernels.support_count.item_width``, as ``place_db`` and the candidate
    placement hand them over, and raises otherwise: it copies nothing per
    pass.  operand_dtype: bf16 (float accumulation) | int8 (int
    accumulation); the counts are the same in both.
    Returns (K,) int32 on the operands' device.
    """
    dev = t_dense.device
    _check_dense("t_dense", t_dense, dev)
    _check_dense("c_dense", c_dense, dev)
    _check("lengths", lengths, torch.int32, 1, dev)
    n, i = t_dense.shape
    if c_dense.shape[1] != i:
        raise ValueError("transaction and candidate item counts must agree")
    if lengths.shape[0] != c_dense.shape[0]:
        raise ValueError("lengths must have one entry per candidate row")
    if operand_dtype not in k3.DTYPES:
        raise ValueError(f"operand_dtype must be one of {tuple(k3.DTYPES)}, got {operand_dtype!r}")
    if i >= MAX_DENSE_ITEMS:
        raise ValueError(f"{i} items: float32 intersection sums are exact only below 2^24")
    if not _use_kernel(impl, dev, "support_count"):
        return ref.support_count_blocked(t_dense, c_dense, lengths)
    _, dtype = k3.DTYPES[operand_dtype]
    if t_dense.dtype != dtype or c_dense.dtype != dtype:
        raise TypeError(f"support_count: the {operand_dtype} kernel takes {dtype} operands, "
                        f"got {t_dense.dtype} and {c_dense.dtype}")
    if i % k3.ITEM_MULTIPLE:
        raise ValueError(f"support_count: the kernel takes an item axis padded to a multiple of "
                         f"{k3.ITEM_MULTIPLE} (support_count.item_width), got {i}")
    out = k3.launch(t_dense, c_dense, lengths, operand_dtype)
    _count_launch("support_count")
    return out


def rule_match(b_packed, a_packed, lengths, c_packed, scores, *, num_items: int | None = None,
               impl: str = "auto", block_n: int = 512):
    """Per-item rule-evidence scores for a batch of basket bitsets.

    b_packed: (B, W) int32; a_packed / c_packed: (R, W) int32 rulebook
    columns; lengths: (R,) int32 antecedent sizes (-1 = padding row);
    scores: (R,) float32.  Returns (B, num_items or 32·W) float32 with
    ``out[b, i] = Σ_r [antecedent_r ⊆ basket_b] · scores[r] · consequent_r[i]``.
    ``block_n`` bounds the plain version's basket block.
    """
    dev = b_packed.device
    _check("b_packed", b_packed, torch.int32, 2, dev)
    _check("a_packed", a_packed, torch.int32, 2, dev)
    _check("c_packed", c_packed, torch.int32, 2, dev)
    _check("lengths", lengths, torch.int32, 1, dev)
    _check("scores", scores, torch.float32, 1, dev)
    n, w = b_packed.shape
    r = a_packed.shape[0]
    if a_packed.shape != (r, w) or c_packed.shape != (r, w):
        raise ValueError("basket and rulebook word counts must agree")
    if lengths.shape[0] != r or scores.shape[0] != r:
        raise ValueError("lengths and scores must have one entry per rule row")
    items = 32 * w if num_items is None else num_items
    if not _use_kernel(impl, dev, "rule_match"):
        out = ref.rule_match_blocked(b_packed, a_packed, lengths, c_packed, scores, block_n=block_n)
        return out[:, :items]
    from repro_torch.kernels import rule_match as k2

    out = k2.launch(b_packed, a_packed, lengths, c_packed, scores)
    _count_launch("rule_match")
    return out[:, :items]
