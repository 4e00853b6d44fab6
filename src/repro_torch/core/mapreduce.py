"""Generic Map/Combine/Reduce engine over a ``torch.distributed`` mesh.

The paper's Hadoop pipeline is: map over HDFS partitions -> local combine ->
hash shuffle -> reduce per key.  On a mesh the key space is dense (tensor
indices), so the shuffle and reduce become one all-reduce (sum, max or min)
of each rank's partial over the data axes (DESIGN.md §2).  Every rank runs
the same program on its own shard (``launch.mesh``: one process a rank);
``core.apriori`` instantiates the engine for support counting and
``serving.recommend`` for rule matching, and :func:`hierarchical_psum`
models the paper's rack-local combiner tier.

An output split over another axis (the candidate axis over ``"model"``)
stays split, as the JAX package's ``out_specs=P("model")`` leaves it: each
rank reduces only its own block, and :func:`gather_blocks` assembles the
blocks outside the step, where JAX's ``device_get`` assembles a sharded
array.  A float sum that must come out the same bit for bit whatever the
payload's size or place (a served score) is :func:`ordered_sum`: gloo's
all-reduce adds the ranks' values in an order that varies along the buffer.

A step that must outlive a failure on one rank (the mesh gateway's batch)
carries it as data: :class:`StepFaults` sends one flag a rank beside every
block of the step's all-gathers, so a rank that failed still enters each of
them, the ranks whose results read its part learn that it failed, and no
collective is added.
Every collective here is waited for by the mesh (``Mesh.wait``), so an
aborted mesh releases its waiting ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import MeshLayout

_REDUCERS = {
    "sum": dist.ReduceOp.SUM,
    "max": dist.ReduceOp.MAX,
    "min": dist.ReduceOp.MIN,
}


def _tree_map(fn, x):
    """``fn`` on every tensor of a tensor, tuple, list or dict of them."""
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return fn(x)


def all_reduce(x, mesh, axes, op: str = "sum"):
    """Reduce ``x`` (a tensor or a tuple/list/dict of them) over the mesh
    ``axes`` in place; every rank of the group gets the result.  A group of
    one rank is left alone."""
    if op not in _REDUCERS:
        raise ValueError(f"unknown reduce_op {op!r}")
    axes = tuple(axes)
    if not axes or mesh.group_size(axes) == 1:
        return x
    group = mesh.group(axes)

    def reduce(t):
        mesh.wait(dist.all_reduce(t, op=_REDUCERS[op], group=group, async_op=True))
        return t

    return _tree_map(reduce, x)


def _block_order(mesh, axes) -> list:
    """The group's members (in group-rank order, as ``all_gather`` lists
    them) sorted by the block each holds when an array splits over
    ``axes``: position p of the result is the group rank holding block p."""
    shape = tuple(mesh.shape.values())
    blocks = [MeshLayout(shape, mesh.axes, r).shard(axes)[0] for r in mesh.group_ranks(axes)]
    return sorted(range(len(blocks)), key=blocks.__getitem__)


class StepFaults:
    """Which ranks of a mesh failed one step, carried in the step's own
    all-gathers: each rank's block travels with one flag byte a rank, and
    each rank ORs the flags it receives into its own.  In a step that
    all-gathers over one axis and then over the others (the rule axis, then
    the data axes), a flag set before the first reaches every rank; one set
    between them reaches the ranks of the second's group.  ``gathers``
    lists the step's all-gathers in order,
    ``(axes, bytes of a rank's block)``.  A rank that failed calls
    :meth:`fail`, then :meth:`drain`, which enters every all-gather it has
    not entered yet with a block of zeros.  ``lost`` is set when an
    all-gather itself raised (a lost peer): that is not contained."""

    def __init__(self, mesh, gathers):
        self.mesh = mesh
        self.plan = [(tuple(a), int(n)) for a, n in gathers if mesh.group_size(tuple(a)) > 1]
        self.flags = torch.zeros(mesh.size, dtype=torch.uint8)
        self.entered = 0
        self.lost = False

    def fail(self) -> None:
        self.flags[self.mesh.rank] = 1

    @property
    def ranks(self) -> list:
        """The ranks known to have failed the step."""
        return torch.nonzero(self.flags).flatten().tolist()

    def gather(self, wire: torch.Tensor, axes) -> list:
        """All-gather ``wire`` (this rank's block) over ``axes``, the flags
        beside it; returns the group's blocks in group-rank order."""
        want_axes, want_bytes = self.plan[self.entered]
        got_bytes = wire.numel() * wire.element_size()
        if (tuple(axes), got_bytes) != (want_axes, want_bytes):
            raise ValueError(f"all-gather {self.entered} of the step sends {got_bytes} bytes over {tuple(axes)}; "
                             f"its plan says {want_bytes} over {want_axes}")
        self.entered += 1
        raw = wire.contiguous().view(-1).view(torch.uint8)
        flags = self.flags.to(raw.device)
        blocks = [torch.empty(raw.numel() + flags.numel(), dtype=torch.uint8, device=raw.device)
                  for _ in range(self.mesh.group_size(axes))]
        try:
            self.mesh.wait(dist.all_gather(blocks, torch.cat([raw, flags]), group=self.mesh.group(axes),
                                           async_op=True))
        except BaseException:
            self.lost = True
            raise
        for b in blocks:
            self.flags |= b[raw.numel():].cpu()
        return [b[: raw.numel()].view(wire.dtype).view(wire.shape) for b in blocks]

    def drain(self) -> None:
        """Enter every all-gather of the plan this rank has not entered."""
        while self.entered < len(self.plan):
            axes, n = self.plan[self.entered]
            device = "cpu" if self.mesh.backend == "gloo" else self.mesh.device
            self.gather(torch.zeros(n, dtype=torch.uint8, device=device), axes)


def gather_blocks(x: torch.Tensor, mesh, axes, faults: StepFaults | None = None) -> torch.Tensor:
    """The whole of a tensor split by rows over ``axes`` (this rank holds
    block ``mesh.shard(axes)``), on every rank of the group along ``axes``,
    on ``x``'s device: one all-gather.  Under gloo the blocks travel as CPU
    tensors, since gloo cannot all-gather CUDA tensors (it stages its CUDA
    all-reduce through the host all the same); under NCCL on the card.
    With ``faults`` the step's fault flags travel beside the blocks."""
    axes = tuple(axes)
    if not axes or mesh.group_size(axes) == 1:
        return x
    wire = (x.cpu() if mesh.backend == "gloo" else x.to(mesh.device)).contiguous()
    if faults is not None:
        blocks = faults.gather(wire, axes)
    else:
        blocks = [torch.empty_like(wire) for _ in range(mesh.group_size(axes))]
        mesh.wait(dist.all_gather(blocks, wire, group=mesh.group(axes), async_op=True))
    return torch.cat([blocks[p] for p in _block_order(mesh, axes)]).to(x.device)


def ordered_sum(x: torch.Tensor, mesh, axes, faults: StepFaults | None = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axes``, added in the order of
    their blocks (``((x_0 + x_1) + x_2) ...``) on every rank: the same bits
    on every rank and whatever ``x``'s size, which a float all-reduce does
    not promise (gloo starts its ring at another rank for each part of the
    buffer).  One all-gather of the partials (with ``faults``, the step's
    fault flags beside them)."""
    axes = tuple(axes)
    if not axes or mesh.group_size(axes) == 1:
        return x
    parts = gather_blocks(x[None], mesh, axes, faults)
    out = parts[0].clone()
    for part in parts[1:]:
        out += part
    return out


@dataclasses.dataclass(frozen=True)
class MapReduceJob:
    """A Hadoop-style job description.

    map_fn:      per-shard function ``(*shard_args) -> tensor(s)`` — the map
                 task with its combiner already folded in (emit *partial
                 sums*, not per-record pairs; Hadoop combiners do the same).
    reduce_axes: mesh axes over which partials are reduced (the shuffle).
    reduce_op:   'sum' | 'max' | 'min' | 'ordered_sum' (:func:`ordered_sum`).
    """

    map_fn: Callable[..., Any]
    reduce_axes: tuple[str, ...]
    reduce_op: str = "sum"


def mapreduce(job: MapReduceJob, mesh, *, on_map: Callable[[], Any] | None = None) -> Callable[..., Any]:
    """Run a :class:`MapReduceJob` on this rank of ``mesh``.

    Returns ``fn(*shard_args, faults=None, on_map=None) -> reduced``: the
    map on this rank's shards, then the reduce over ``job.reduce_axes``;
    every rank of those axes gets the result.  An output the map splits over
    another axis stays split: each rank gets its own block, reduced
    (:func:`gather_blocks` makes it whole).  ``on_map()``, given here or to
    one call, runs between the map and the reduce (a timer's lap).
    ``faults`` (a :class:`StepFaults`) rides the ``ordered_sum`` reduce's
    all-gather (an all-reduce carries none).
    """
    if job.reduce_op not in _REDUCERS and job.reduce_op != "ordered_sum":
        raise ValueError(f"unknown reduce_op {job.reduce_op!r}")
    axes = tuple(job.reduce_axes)
    step_lap = on_map

    def fn(*args, faults=None, on_map=None):
        partial = job.map_fn(*args)
        for lap in (step_lap, on_map):
            if lap is not None:
                lap()
        if job.reduce_op == "ordered_sum":
            return _tree_map(lambda t: ordered_sum(t, mesh, axes, faults), partial)
        return all_reduce(partial, mesh, axes, job.reduce_op)

    return fn


def hierarchical_psum(
    x: Any,
    mesh,
    inner_axes: tuple[str, ...],
    outer_axes: tuple[str, ...] = (),
    outer_transform: tuple[Callable, Callable] | None = None,
) -> Any:
    """Two-level reduction: sum within ``inner_axes`` (the fast links), then
    over ``outer_axes`` (the slow ones), optionally transforming the payload
    for the outer hop (e.g. narrowing partial counts before the cross-pod
    hop): ``encode`` before it, ``decode`` after."""
    y = all_reduce(x, mesh, inner_axes)
    if not outer_axes:
        return y
    if outer_transform is None:
        return all_reduce(y, mesh, outer_axes)
    encode, decode = outer_transform
    return decode(all_reduce(encode(y), mesh, outer_axes))


def shard_rows(x, mesh, axes):
    """This rank's contiguous row block of ``x`` split over ``axes`` (the
    HDFS block layout, ``PartitionSpec(axes, None)``).  The row count must
    divide evenly (:func:`pad_rows_to_shards`)."""
    index, count = mesh.shard(tuple(axes))
    if x.shape[0] % count:
        raise ValueError(f"{x.shape[0]} rows do not split over {count} shards; pad them first")
    rows = x.shape[0] // count
    return x[index * rows : (index + 1) * rows]


def pad_rows_to_shards(arr: np.ndarray, num_shards: int):
    """Pad axis 0 to a multiple of num_shards with zero rows.

    Zero transaction rows are inert for support counting in both device
    representations: dense — every real candidate has |c| >= 1 and
    <0-row, c> == 0 != |c|; packed uint32 — a zero row misses every set
    candidate bit, so ``t & c == c`` fails (DESIGN.md §3). The row partition
    is payload-agnostic: over int8 items or uint32 words alike.
    Returns (padded, original_n).
    """
    n = arr.shape[0]
    rem = (-n) % num_shards
    if rem == 0:
        return arr, n
    pad = np.zeros((rem,) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([np.asarray(arr), pad], axis=0), n
