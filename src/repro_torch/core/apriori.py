"""Level-wise Apriori on one device — the paper's algorithm (§3.3) in PyTorch.

Per level k:
  driver (host):  candidate generation from F_{k-1}   (core.candidates)
  Map (device):   support counting of every candidate over the whole DB
                  (kernels.ops.support_count — the K3 tensor-core kernel —
                  or kernels.ops.support_count_packed — the K1 kernel)
  driver (host):  prune by min support -> F_k

Two device representations of the transaction store (DESIGN.md §4):
  * ``dense``  — {0,1} (N, Ip) in the operand dtype (bfloat16 or int8),
    the item axis padded once with zero columns to the K3 kernel's multiple
    (``kernels.support_count.item_width``);
  * ``packed`` — uint32 bitsets (N, ceil(I/32)), held as an int32 view.
Either is placed ONCE (``place_db``).  Candidates pad with zero rows and
``|c| = -1`` lengths (never match).  A level's candidate passes run as a
depth-2 pipeline: the host places pass p+1 (a pinned-host, non-blocking
copy) and launches its count before it waits on pass p's ``.cpu()``.
Counting is exact (int32).

On a mesh (``launch.mesh``, one process a rank) the level loop runs on
every rank and generates the same candidates there (it is deterministic).
The transaction rows are split over ``cfg.data_axes`` (the HDFS block
layout) and the candidate rows over ``cfg.model_axis``, a 2-D
decomposition of the paper's 1-D map phase (DESIGN.md §5): each rank
places only its row block and its candidate block and counts them; the
step's one all-reduce sums the row blocks' partial counts of its candidate
block over the data axes (``core.mapreduce``), as the JAX package's step
with ``out_specs=P(model_axis)`` does.  The level loop then assembles the
candidate blocks over the model axis, outside the step
(``mapreduce.gather_blocks``).  On a mesh of one rank every collective is
skipped.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core import candidates as cand_mod
from repro_torch.core import itemsets as enc
from repro_torch.core.mapreduce import MapReduceJob, gather_blocks, mapreduce, pad_rows_to_shards
from repro_torch.launch.mesh import mesh_device
from repro_torch.kernels import ops as kops
from repro_torch.obs.mining import device_timer, phase
k3 = importlib.import_module("repro_torch.kernels.support_count")

COUNT_IMPLS = ("auto", "kernel", "ref")
REPRESENTATIONS = ("dense", "packed")


@dataclasses.dataclass(frozen=True)
class AprioriConfig:
    min_support: float = 0.01          # fraction of |DB|; min_count = ceil(frac * N)
    max_k: int = 8                     # maximum itemset size to mine
    count_impl: str = "auto"           # auto (by device) | kernel (CUDA only) | ref (plain)
    representation: str = "dense"      # dense {0,1} bf16/int8 | packed uint32 bitsets
    data_axes: tuple = ("data",)       # mesh axes sharding the transaction rows
    model_axis: str | None = None      # mesh axis sharding the candidate rows
    candidate_pad: int = 256           # K padded to a multiple (pass bucket)
    max_candidates_per_pass: int = 1 << 16  # split huge candidate sets across passes
    use_naive_paper_map: bool = False  # paper's 'all subsets' enumeration (small I only)
    operand_dtype: str = "bf16"        # dense kernel operand mode (bf16 / int8)
    packed_mode: str = "and_cmp"       # packed kernel containment mode (| popcount)


@dataclasses.dataclass
class AprioriResult:
    """k -> (itemsets (F_k, k) int32, supports (F_k,) int64).

    Built by :func:`mine`, or directly from another miner's ``levels`` dict
    of numpy arrays (e.g. the JAX package's result).

    ``fault_report`` is set only by the fault-tolerant SON executor
    (``streaming.mine_son_streamed(fault=...)``): what the retrying work
    queue did — retries, speculative copies, skipped partitions.
    """

    levels: dict
    num_transactions: int
    min_count: int
    fault_report: object | None = dataclasses.field(default=None, compare=False)
    # the full pre-prune SON phase-2 union with exact counts, k -> (cands,
    # counts): set only by mine_son_streamed(collect_union=True), the raw
    # material of the incremental count cache
    union_counts: dict | None = dataclasses.field(default=None, compare=False)

    def frequent(self, k: int) -> np.ndarray:
        return self.levels[k][0] if k in self.levels else np.zeros((0, k), np.int32)

    def support(self, itemset) -> int:
        k = len(itemset)
        if k not in self.levels:
            return 0
        sets, sup = self.levels[k]
        hit = np.all(sets == np.asarray(sorted(itemset), np.int32)[None, :], axis=1)
        idx = np.flatnonzero(hit)
        return int(sup[idx[0]]) if idx.size else 0

    def as_dict(self) -> dict:
        out = {}
        for k, (sets, sup) in self.levels.items():
            for row, s in zip(sets, sup):
                out[tuple(int(x) for x in row)] = int(s)
        return out

    @property
    def total_frequent(self) -> int:
        return sum(v[0].shape[0] for v in self.levels.values())


def _pad_bucket(k: int, quantum: int) -> int:
    """Pad K to a power-of-two-ish bucket (few distinct pass shapes)."""
    k = max(k, 1)
    bucket = quantum
    while bucket < k:
        bucket *= 2
    return bucket


def _check_cfg(cfg: AprioriConfig) -> None:
    if cfg.representation not in REPRESENTATIONS:
        raise ValueError(f"representation must be dense|packed, got {cfg.representation!r}")
    if cfg.count_impl not in COUNT_IMPLS:
        raise ValueError(f"count_impl must be one of {COUNT_IMPLS}, got {cfg.count_impl!r}")
    if cfg.operand_dtype not in k3.DTYPES:
        raise ValueError(f"operand_dtype must be bf16|int8, got {cfg.operand_dtype!r}")


def _check_mesh(cfg: AprioriConfig, mesh) -> None:
    if mesh is None:
        return
    axes = tuple(cfg.data_axes) + ((cfg.model_axis,) if cfg.model_axis else ())
    if not cfg.data_axes or set(axes) - set(mesh.axes) or len(set(axes)) != len(axes):
        raise ValueError(f"data_axes {cfg.data_axes} and model_axis {cfg.model_axis!r} must be "
                         f"distinct axes of the mesh {tuple(mesh.axes)}")


def make_count_step(cfg: AprioriConfig, mesh=None) -> Callable:
    """The support-count step ``fn(T, C, lengths) -> counts (Kp,) int32``
    on the operands' device.

    Dense:  T (N, Ip), C (Kp, Ip) {0,1} in the operand dtype (K3).
    Packed: T (N, W), C (Kp, W) int32 word views (K1).

    On a mesh T is this rank's row block and C, lengths its candidate block
    (Kp / model shards rows); the step is the Map/Reduce job that counts
    them and returns that block's counts, summed over ``cfg.data_axes``
    (:func:`assemble_counts` makes the blocks whole).
    """
    _check_cfg(cfg)
    if cfg.representation == "dense":

        def count_step(t, c, ln):
            return kops.support_count(t, c, ln, impl=cfg.count_impl, operand_dtype=cfg.operand_dtype)

    else:

        def count_step(t, c, ln):
            return kops.support_count_packed(t, c, ln, impl=cfg.count_impl, mode=cfg.packed_mode)

    if mesh is None:
        return count_step
    _check_mesh(cfg, mesh)
    return mapreduce(MapReduceJob(map_fn=count_step, reduce_axes=tuple(cfg.data_axes)), mesh)


def assemble_counts(block: torch.Tensor, cfg: AprioriConfig, mesh=None) -> np.ndarray:
    """A pass's whole (Kp,) counts on the host of every rank, from this
    rank's block of them (reduced over the data axes): the candidate blocks
    gathered over ``cfg.model_axis``, staged through the host."""
    block = block.cpu()
    if mesh is not None and cfg.model_axis:
        block = gather_blocks(block, mesh, (cfg.model_axis,))
    return block.numpy()


def place_db(t_np: np.ndarray, cfg: AprioriConfig, device="cuda", *, mesh=None) -> torch.Tensor:
    """Encode the dense {0,1} DB and place it on ``device`` ONCE for the
    whole mine: one int8 copy to the device, then the encoding there.
    On a mesh, only this rank's row block (rows zero-padded to the data-shard
    count: inert) is copied, to the mesh's device.

    Dense: (N, k3.item_width(I)) in the operand dtype — the zero-column pad
    and the cast (the JAX wrapper casts and pads the whole DB on every pass
    instead).
    Packed: (N, W) int32 views of the uint32 bitset words, packed by
    ``ops.pack_bits_device`` and handed to :func:`place_words`.
    """
    dev = mesh_device(device, mesh)
    _check_cfg(cfg)
    t_np = np.asarray(t_np, dtype=np.int8)
    num_items = t_np.shape[1]
    if mesh is not None:
        _check_mesh(cfg, mesh)
        index, shards = mesh.shard(cfg.data_axes)
        t_np, _ = pad_rows_to_shards(t_np, shards)
        rows = t_np.shape[0] // shards
        t_np = np.ascontiguousarray(t_np[index * rows : (index + 1) * rows])
    t = torch.from_numpy(t_np).to(dev)
    if cfg.representation == "packed":
        return place_words(kops.pack_bits_device(t), num_items, cfg)
    t = torch.nn.functional.pad(t, (0, k3.item_width(num_items) - num_items))
    return t.to(k3.DTYPES[cfg.operand_dtype][1])


def place_words(words: torch.Tensor, num_items: int, cfg: AprioriConfig) -> torch.Tensor:
    """The count step's transaction operand from packed (R, W) int32 word
    views already on the device — a whole DB or one streamed chunk.

    Packed: the words as they are.  Dense: unpacked there to
    (R, k3.item_width(I)) {0,1} in the operand dtype, so the host never
    unpacks and a chunk crosses to the card at 4·W bytes a row.
    """
    if cfg.representation == "packed":
        return words
    return kops.unpack_bits_device(words, num_items, k3.item_width(num_items),
                                   k3.DTYPES[cfg.operand_dtype][1])


def _candidate_quantum(cfg: AprioriConfig, mesh=None) -> int:
    """Pad quantum for the candidate axis: at least ``candidate_pad``, and a
    multiple of the model-shard count so every bucket splits evenly over
    ``model_axis`` (``_pad_bucket`` only doubles, which keeps the
    divisibility — e.g. 3 shards with pad 256 give buckets 258, 516, ...)."""
    model_shards = mesh.shape[cfg.model_axis] if (mesh is not None and cfg.model_axis) else 1
    quantum = max(cfg.candidate_pad, model_shards)
    return ((quantum + model_shards - 1) // model_shards) * model_shards


def _place_candidates(chunk: np.ndarray, kp: int, num_items: int, cfg: AprioriConfig, device,
                      mesh=None):
    """Encode one candidate pass to device tensors, zero-padded to the
    bucket: (Kp, k3.item_width(I)) {0,1} rows in the operand dtype, or (Kp, W)
    int32 words; plus lengths with ``|c| = -1`` padding.  On CUDA the host
    buffers are pinned and the copies are non-blocking (dense rows cross as
    int8 and are cast on the device, in stream order), so the caller can
    launch the count before earlier passes finish.  On a mesh split over
    ``model_axis``, only this rank's block of Kp / shards rows is encoded,
    as tensors of their own (16-byte aligned for the kernels)."""
    dev = torch.device(device)
    if mesh is not None and cfg.model_axis:
        index, shards = mesh.shard((cfg.model_axis,))
        kp //= shards
        chunk = chunk[index * kp : (index + 1) * kp]
    if cfg.representation == "packed":
        c_host = np.zeros((kp, enc.packed_words(num_items)), dtype=np.uint32)
        c_host[: chunk.shape[0]] = enc.itemsets_to_packed(chunk, num_items)
        c_host = c_host.view(np.int32)
    else:
        c_host = np.zeros((kp, k3.item_width(num_items)), dtype=np.int8)
        c_host[: chunk.shape[0]] = enc.itemsets_to_dense(chunk, c_host.shape[1])
    lengths = np.full(kp, -1, dtype=np.int32)
    lengths[: chunk.shape[0]] = chunk.shape[1]
    c_t = torch.from_numpy(c_host)
    len_t = torch.from_numpy(lengths)
    if dev.type == "cuda":
        c_t = c_t.pin_memory().to(dev, non_blocking=True)
        len_t = len_t.pin_memory().to(dev, non_blocking=True)
    if cfg.representation == "dense":
        c_t = c_t.to(k3.DTYPES[cfg.operand_dtype][1])
    return c_t, len_t


def _count_level(count_step, t_dev, cand_sets: np.ndarray, num_items: int, cfg: AprioriConfig,
                 mesh=None, obs=None):
    """Count supports for one level's candidates, in padded passes.

    Depth-2 pipeline: pass p+1 is placed and its count launched before the
    host blocks on pass p's ``.cpu()``, so at most two passes of candidate
    tensors are live on the device (the bound ``max_candidates_per_pass``
    exists to give).  On a mesh ``count_step`` is the mesh's step, the
    drain assembles its blocks and every rank gets every count.

    ``obs`` times the ``cand_place``, ``count_kernel`` (the device span of
    a pass's count launch by CUDA events, read after the drain's sync) and
    ``host_sync`` phases; observation only.
    """
    k_total = cand_sets.shape[0]
    quantum = _candidate_quantum(cfg, mesh)
    counts = np.zeros(k_total, dtype=np.int64)
    pending = []
    timer = device_timer(obs, "count_kernel", t_dev.device)

    def _drain(limit):
        while len(pending) > limit:
            start, m, out = pending.pop(0)
            with phase(obs, "host_sync"):
                counts[start : start + m] = assemble_counts(out, cfg, mesh)[:m]
            timer.flush()

    for start in range(0, k_total, cfg.max_candidates_per_pass):
        chunk = cand_sets[start : start + cfg.max_candidates_per_pass]
        kp = _pad_bucket(chunk.shape[0], quantum)
        with phase(obs, "cand_place"):
            c_dev, len_dev = _place_candidates(chunk, kp, num_items, cfg, t_dev.device, mesh)
        with timer:
            out = count_step(t_dev, c_dev, len_dev)
        pending.append((start, chunk.shape[0], out))
        _drain(limit=1)   # sync pass p only once pass p+1 is in flight
    _drain(limit=0)
    return counts


def run_level_loop(
    count_fn: Callable[[np.ndarray, int], np.ndarray],
    n: int,
    num_items: int,
    cfg: AprioriConfig,
    checkpoint_cb: Callable | None = None,
    resume_state: dict | None = None,
    obs=None,
) -> AprioriResult:
    """The driver's level loop, abstracted over HOW candidates are counted.

    ``count_fn(cand_sets (K, k) int32, level_k) -> supports (K,) int``.
    Candidate generation, min-support pruning, checkpointing and
    termination live here, so every driver that counts differently shares
    them.  Given the same DB and config, the candidates of level k are a
    pure function of F_{k-1} (``generate_candidates`` is canonical), which
    is what lets a resumed mine regenerate them.

    ``obs`` (optional) records per-level counters and the candidate-
    generation phase time (its join and prune inside it); observation only.
    """
    min_count = max(1, math.ceil(cfg.min_support * n))
    levels = dict(resume_state["levels"]) if resume_state else {}
    start_k = resume_state["next_k"] if resume_state else 1

    if start_k <= 1:
        # level 1: supports of singletons — the same count path
        with phase(obs, "candidate_gen"):
            singles = enc.singleton_itemsets(num_items)
        if obs is not None:
            obs.on_level_start(1, singles.shape[0])
        sup1 = count_fn(singles, 1)
        keep = sup1 >= min_count
        levels[1] = (singles[keep], sup1[keep])
        if obs is not None:
            obs.on_level_end(1, int(keep.sum()))
        if checkpoint_cb:
            checkpoint_cb(1, levels)
        start_k = 2

    for k in range(start_k, cfg.max_k + 1):
        prev_sets = levels.get(k - 1, (np.zeros((0, k - 1), np.int32),))[0]
        if prev_sets.shape[0] < k:   # cannot form a k-itemset
            break
        with phase(obs, "candidate_gen"):
            if cfg.use_naive_paper_map:
                # paper §3.3: enumerate every k-subset of the (frequent) item universe
                freq_items = levels[1][0].ravel()
                combos = cand_mod.all_k_subsets_of_universe(freq_items.size, k)
                cands = freq_items[combos]
            else:
                cands = cand_mod.generate_candidates(prev_sets, obs=obs)
        if cands.shape[0] == 0:
            break
        if obs is not None:
            obs.on_level_start(k, cands.shape[0])
        sup = count_fn(cands, k)
        keep = sup >= min_count
        if obs is not None:
            obs.on_level_end(k, int(keep.sum()))
        if not keep.any():
            break
        levels[k] = (cands[keep], sup[keep])
        if checkpoint_cb:
            checkpoint_cb(k, levels)

    return AprioriResult(levels=levels, num_transactions=n, min_count=min_count)


def mine(
    transactions_dense,
    cfg: AprioriConfig = AprioriConfig(),
    *,
    device="cuda",
    mesh=None,
    checkpoint_cb: Callable | None = None,
    resume_state: dict | None = None,
    obs=None,
) -> AprioriResult:
    """Level-wise Apriori over a dense {0,1} transaction matrix on ``device``.

    ``mesh`` (``launch.mesh.Mesh``): run as this rank of a data x model
    mesh, on the mesh's device; every rank returns the same result, equal
    to the single-device mine's.
    checkpoint_cb(level_k, levels_dict): called after each completed level;
    ``resume_state`` = {'levels': ..., 'next_k': ...} restarts from one.
    ``obs`` (optional mining observer, ``obs.MiningObs``): per-level
    counters and phase times, as ``streaming.mine_streamed`` records them;
    observation only.
    """
    dev = mesh_device(device, mesh)
    _check_cfg(cfg)
    t_np = np.asarray(transactions_dense, dtype=np.int8)
    n, num_items = t_np.shape

    t_dev = place_db(t_np, cfg, dev, mesh=mesh)
    count_step = make_count_step(cfg, mesh)

    def count_fn(cand_sets, level_k):
        return _count_level(count_step, t_dev, cand_sets, num_items, cfg, mesh, obs=obs)

    return run_level_loop(count_fn, n, num_items, cfg, checkpoint_cb, resume_state, obs=obs)
