"""Public wrappers around the two CUDA kernels.

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

import torch

from repro_torch.kernels import ref

IMPLS = ("auto", "kernel", "ref")
MODES = ("and_cmp", "popcount")

LAUNCHES = {"support_count_packed": 0, "rule_match": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


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
    LAUNCHES["support_count_packed"] += 1
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
    LAUNCHES["rule_match"] += 1
    return out[:, :items]
