"""The compiled rulebook: device-servable association rules (DESIGN.md §8).

``compile_rulebook`` lowers a mined :class:`~repro_torch.core.apriori.AprioriResult`
into four column arrays — the operand format of the K2 rule-match kernel:

    ante_packed (R, W) uint32   antecedent bitsets (the K1 word layout, §4)
    cons_packed (R, W) uint32   consequent bitsets
    ante_len    (R,)   int32    antecedent popcounts; -1 = padding row
    scores      (R,)   float32  serving weight (confidence | lift); 0 on padding

Rules are sorted by descending score with a deterministic bitset tie-break,
optionally truncated to ``max_rules``, and padded to ``pad_multiple`` rows
with the standard inert padding (zero words, ``len = -1``, score 0).

A host rulebook holds numpy arrays; ``place_rulebook`` returns one whose
columns are tensors on a device (words as int32 views).  Placed on a mesh,
a rulebook's rows are padded (inertly) to the rule-shard count and each
rank keeps only its block of them (:class:`RuleShard`).  ``save``/``load``
write and read one ``.npz`` in the same format as the JAX package's
rulebook, so an artifact moves between the two packages in both directions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import rules as rules_mod
from repro_torch.launch.mesh import mesh_device
from repro_torch.obs.mining import phase

SCORE_KINDS = ("confidence", "lift")


def _host(x, dtype) -> np.ndarray:
    """A column as numpy in its host dtype (uint32 words come back from the
    int32 device view bit for bit)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if x.dtype == np.int32 and dtype == np.uint32:
        return x.view(np.uint32)
    return x.astype(dtype, copy=False)


@dataclasses.dataclass(frozen=True)
class RuleShard:
    """A rulebook placed on a mesh: this rank holds row block
    ``mesh.shard(rule_axis)`` of ``num_rows`` padded rows, which hold
    ``num_rules`` real rules in all."""

    mesh: object
    rule_axis: str
    num_rows: int
    num_rules: int


@dataclasses.dataclass
class Rulebook:
    ante_packed: np.ndarray | torch.Tensor   # (R, W) uint32 (int32 view when placed)
    cons_packed: np.ndarray | torch.Tensor   # (R, W) uint32 (int32 view when placed)
    ante_len: np.ndarray | torch.Tensor      # (R,)   int32, -1 = padding
    scores: np.ndarray | torch.Tensor        # (R,)   float32, 0 on padding
    num_items: int
    score_kind: str = "confidence"
    min_confidence: float = 0.0
    shard: RuleShard | None = None           # set when placed on a mesh

    @property
    def num_rules(self) -> int:
        """Real (non-padding) rules (of the whole rulebook, on a mesh)."""
        if self.shard is not None:
            return self.shard.num_rules
        return int((_host(self.ante_len, np.int32) >= 0).sum())

    @property
    def num_rows(self) -> int:
        """Padded row count (of the whole rulebook, on a mesh)."""
        if self.shard is not None:
            return self.shard.num_rows
        return self.ante_packed.shape[0]

    @property
    def device(self) -> torch.device | None:
        """The device the columns live on, or None for a host rulebook."""
        return self.ante_packed.device if isinstance(self.ante_packed, torch.Tensor) else None

    def to_host(self) -> "Rulebook":
        """The same rulebook with numpy columns in their host dtypes."""
        if self.shard is not None:
            raise ValueError("a rulebook placed on a mesh holds one block of its rules on each rank")
        return Rulebook(
            _host(self.ante_packed, np.uint32), _host(self.cons_packed, np.uint32),
            _host(self.ante_len, np.int32), _host(self.scores, np.float32),
            self.num_items, self.score_kind, self.min_confidence,
        )

    def save(self, path: str) -> None:
        h = self.to_host()
        np.savez(
            path,
            ante_packed=h.ante_packed,
            cons_packed=h.cons_packed,
            ante_len=h.ante_len,
            scores=h.scores,
            num_items=np.int64(self.num_items),
            score_kind=np.bytes_(self.score_kind.encode()),
            min_confidence=np.float64(self.min_confidence),
        )

    @classmethod
    def load(cls, path: str) -> "Rulebook":
        with np.load(path) as z:
            return cls(
                ante_packed=z["ante_packed"],
                cons_packed=z["cons_packed"],
                ante_len=z["ante_len"],
                scores=z["scores"],
                num_items=int(z["num_items"]),
                score_kind=bytes(z["score_kind"]).decode(),
                min_confidence=float(z["min_confidence"]),
            )


def rulebook_from_arrays(ante_packed, cons_packed, ante_len, scores, num_items: int,
                         score_kind: str = "confidence", min_confidence: float = 0.0) -> Rulebook:
    """A host :class:`Rulebook` from another rulebook's columns as numpy
    arrays (e.g. the JAX package's ``Rulebook`` fields)."""
    ante = np.ascontiguousarray(ante_packed, dtype=np.uint32)
    cons = np.ascontiguousarray(cons_packed, dtype=np.uint32)
    lens = np.ascontiguousarray(ante_len, dtype=np.int32)
    sc = np.ascontiguousarray(scores, dtype=np.float32)
    r, w = ante.shape
    if cons.shape != (r, w) or lens.shape != (r,) or sc.shape != (r,):
        raise ValueError("rulebook columns disagree on the rule count or word count")
    if w != (num_items + 31) // 32:
        raise ValueError(f"{w} words cannot hold a vocabulary of {num_items} items")
    if score_kind not in SCORE_KINDS:
        raise ValueError(f"score must be one of {SCORE_KINDS}, got {score_kind!r}")
    return Rulebook(ante, cons, lens, sc, int(num_items), score_kind, float(min_confidence))


def compile_rulebook(
    result,
    *,
    min_confidence: float = 0.5,
    score: str = "confidence",
    max_rules: int | None = None,
    num_items: int | None = None,
    pad_multiple: int = 256,
    obs=None,
) -> Rulebook:
    """Vectorized extraction (``core.rules.extract_rule_arrays``) -> sorted,
    truncated, padded serving columns (a host rulebook).

    ``obs`` (optional mining observer) times the ``rules_extract``,
    ``rules_sort`` and ``rules_pad`` phases; observation only."""
    if score not in SCORE_KINDS:
        raise ValueError(f"score must be one of {SCORE_KINDS}, got {score!r}")
    with phase(obs, "rules_extract"):
        arr = rules_mod.extract_rule_arrays(result, min_confidence, num_items)
    with phase(obs, "rules_sort"):
        scores = np.asarray(arr.confidence if score == "confidence" else arr.lift, np.float32)
        # descending score, bitset tie-break (np.lexsort: last key is primary)
        keys = (
            [arr.cons_packed[:, w] for w in range(arr.cons_packed.shape[1] - 1, -1, -1)]
            + [arr.ante_packed[:, w] for w in range(arr.ante_packed.shape[1] - 1, -1, -1)]
            + [-scores.astype(np.float64)]
        )
        order = np.lexsort(keys)
        if max_rules is not None:
            order = order[:max_rules]

    with phase(obs, "rules_pad"):
        r = order.size
        rp = max(pad_multiple, ((r + pad_multiple - 1) // pad_multiple) * pad_multiple)
        w = arr.ante_packed.shape[1]
        ante = np.zeros((rp, w), np.uint32)
        cons = np.zeros((rp, w), np.uint32)
        lens = np.full(rp, -1, np.int32)
        sc = np.zeros(rp, np.float32)
        ante[:r] = arr.ante_packed[order]
        cons[:r] = arr.cons_packed[order]
        lens[:r] = arr.ante_len[order]
        sc[:r] = scores[order]
    return Rulebook(ante, cons, lens, sc, arr.num_items, score, min_confidence)


def place_rulebook(rb: Rulebook, device="cuda", *, mesh=None, rule_axis: str = "model",
                   obs=None) -> Rulebook:
    """Commit the rulebook's columns to ``device`` once: words as (R, W)
    int32 views, lengths int32, scores float32.

    On a ``mesh`` (on its device) the rows are padded with inert rows
    (``len = -1``, score 0) to a multiple of the ``rule_axis`` shard count,
    and this rank keeps its contiguous block of them — the serving twin of
    ``apriori.place_db``.  ``obs`` (optional mining observer) times it as
    the ``rulebook_place`` phase.
    """
    with phase(obs, "rulebook_place"):
        return _place(rb, mesh_device(device, mesh), mesh, rule_axis)


def _place(rb: Rulebook, dev, mesh, rule_axis: str) -> Rulebook:
    h = rb.to_host()
    ante, cons, lens, sc = h.ante_packed.view(np.int32), h.cons_packed.view(np.int32), h.ante_len, h.scores
    shard = None
    if mesh is not None:
        index, shards = mesh.shard((rule_axis,))
        pad = (-h.num_rows) % shards
        rows = (h.num_rows + pad) // shards
        block = slice(index * rows, (index + 1) * rows)
        ante = np.ascontiguousarray(np.pad(ante, ((0, pad), (0, 0)))[block])
        cons = np.ascontiguousarray(np.pad(cons, ((0, pad), (0, 0)))[block])
        lens = np.ascontiguousarray(np.pad(lens, (0, pad), constant_values=-1)[block])
        sc = np.ascontiguousarray(np.pad(sc, (0, pad))[block])
        shard = RuleShard(mesh, rule_axis, h.num_rows + pad, h.num_rules)
    return Rulebook(
        torch.from_numpy(ante).to(dev), torch.from_numpy(cons).to(dev),
        torch.from_numpy(lens).to(dev), torch.from_numpy(sc).to(dev),
        rb.num_items, rb.score_kind, rb.min_confidence, shard,
    )
