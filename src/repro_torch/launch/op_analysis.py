"""Static cost of a torch function from one walk on meta tensors: FLOPs, an
HBM-traffic estimate, the peak of live intermediates and collective bytes.

The counterpart of the JAX package's ``launch/hlo_analysis.py``, which walks
the compiled HLO of a count step lowered from ``jax.ShapeDtypeStruct``s.
Eager PyTorch has no compiled module to read, so the function runs once on
``meta`` tensors (shapes and dtypes, no storage, no device) under a
``TorchDispatchMode`` that sees every aten op:

  flops       = Σ ops  ``torch.utils.flop_counter``'s per-op formula
                (the matmul family; elementwise ops count 0, as HLO's
                 fusions do)
  hbm_bytes   = Σ ops  (tensor operand bytes + result bytes)
                (each aten op is one kernel of eager mode, so its operands
                 and results are what crosses HBM, as a fusion's boundary is
                 for XLA; views and ``empty`` move nothing, and an in-place
                 op's result is its operand, counted once)
  temp_bytes  = the peak of the bytes of the op results alive at once
                (the counterpart of XLA's temp size; the arguments are not
                 counted)
  coll_bytes  = Σ collectives  operand bytes

Collectives cannot run on meta tensors.  A ``TorchFunctionMode`` catches
each ``torch.distributed.all_reduce`` the mesh engine (``core/mapreduce.py``)
issues, records its operand bytes and its group's ranks, and skips it; any
other ``torch.distributed`` call raises, so nothing goes uncounted.  On a
:class:`launch.mesh.MeshLayout` the groups are shapes only; on a live
:class:`launch.mesh.Mesh` nothing reaches its process groups either.

The walk runs the function's Python once.  Data-dependent ops
(``nonzero``, ``unique``, boolean-mask indexing, ``.item()``) fail on meta
tensors, so walk only steps with static shapes (the count step), never the
level loop.  Every tensor the walk makes is a meta tensor, or it raises: it
allocates no device or host memory for data.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

_aten = torch.ops.aten
# ops that allocate without writing: no bytes cross HBM
_UNWRITTEN = {_aten.empty.memory_format, _aten.empty_like.default, _aten.empty_strided.default}
# the collectives the walk records, by the JAX package's HLO names
_COLLECTIVES = {dist.all_reduce: "all-reduce"}


def meta(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype``: the counterpart of
    ``jax.ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class OpCosts:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    temp_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    collective_by_type: dict = dataclasses.field(default_factory=dict)
    # the global ranks of each collective's group, in issue order
    collective_groups: list = dataclasses.field(default_factory=list)


class _Ops(TorchDispatchMode):
    """Bytes and live intermediates of every aten op."""

    def __init__(self, costs: OpCosts):
        super().__init__()
        self.costs = costs
        self.live = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(t.device.type != "meta" for t in outs):
            raise RuntimeError(f"op_analysis walks meta tensors only; {func} made a tensor off meta")
        aliased = [r.alias_info is not None for r in func._schema.returns]
        fresh = [t for t, a in zip(outs, aliased + [False] * len(outs)) if not a]
        if func not in _UNWRITTEN:
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.costs.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, fresh))
        for t in fresh:
            n = _nbytes(t)
            self.live += n
            self.costs.temp_bytes = max(self.costs.temp_bytes, self.live)
            weakref.finalize(t, self._free, n)
        return out


class _Collectives(TorchFunctionMode):
    """Records the mesh engine's collectives instead of running them."""

    def __init__(self, costs: OpCosts):
        super().__init__()
        self.costs = costs

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _COLLECTIVES.get(func)
        if kind is None:
            if (getattr(func, "__module__", None) or "").startswith("torch.distributed"):
                raise NotImplementedError(f"op_analysis does not count {func.__name__}")
            return func(*args, **kwargs)
        tensor = args[0] if args else kwargs["tensor"]
        group = kwargs.get("group", args[2] if len(args) > 2 else None)
        # a MeshLayout's group is its ranks; a Mesh's is a process group
        ranks = group if isinstance(group, tuple) else dist.get_process_group_ranks(group)
        n = _nbytes(tensor)
        c = self.costs
        c.collective_bytes += n
        c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
        c.collective_by_type[kind] = c.collective_by_type.get(kind, 0) + n
        c.collective_groups.append(tuple(int(r) for r in ranks))
        return None


def analyze(fn, *args, **kwargs) -> OpCosts:
    """Walk ``fn(*args, **kwargs)`` once on its meta tensor arguments and
    return what it costs (per rank, when ``fn`` is one rank's step)."""
    costs = OpCosts()
    flops = FlopCounterMode(display=False)
    with torch.no_grad(), _Collectives(costs), flops, _Ops(costs):
        fn(*args, **kwargs)
    costs.flops = float(flops.get_total_flops())
    return costs
