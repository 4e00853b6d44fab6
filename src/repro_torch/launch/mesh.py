"""A named-axis mesh of ranks over ``torch.distributed``, and a launcher.

The JAX package's mesh is one process holding every device; its tests fake
several CPU devices in one process.  PyTorch's idiom is one process per
rank, so here a :class:`Mesh` is this rank's view of a grid of ranks with
named axes (``("data", "model")``, ``("pod", "data", "model")``):

  * ``mesh.shape`` is an ordered ``axis -> size`` map, so
    ``math.prod(mesh.shape[a] for a in cfg.data_axes)`` reads as in JAX;
  * ``mesh.group(axes)`` is the process group of the ranks that differ only
    along ``axes`` (this rank's row, column or slab of the grid);
  * ``mesh.coord(axis)`` / ``mesh.shard(axes)`` place this rank on the grid;
  * ``mesh.device`` is the device this rank computes on.

The grid arithmetic (coordinates, blocks, the ranks of a group) lives in
:class:`MeshLayout`, which :class:`Mesh` extends with process groups.  On
its own a layout stands in for a mesh whose ranks are never started: the
dry run costs one rank of :func:`production_mesh_shape`'s 256 on meta
tensors (``launch.op_analysis``).

Every group of every non-empty subset of the axes is created when the mesh
is built, by every rank in the same order: ``dist.new_group`` is a
collective call, so a group created later by some ranks only would hang.
Each group takes the mesh's explicit timeout, so a rank that dies before a
collective makes the others fail within it instead of gloo's 30 minutes.
(``DeviceMesh`` is not used: it creates its per-axis groups with the
backend's default timeout.)

Every collective of the engine (``core.mapreduce``) and of a
:class:`Mesh`'s ``barrier``, ``all_gather_object`` and ``broadcast`` is
waited for by :meth:`Mesh.wait`, which reads the mesh's abort key in the
default group's store every ``ABORT_POLL_S``, so once any rank has called
:meth:`Mesh.abort` every rank waiting in a collective of that mesh lets go
with :class:`MeshAborted` instead of waiting out the groups' timeout (gloo
releases no peer on its own: neither ``abort()`` nor destroying a group
does).  A gloo collective is waited for in timed slices; an NCCL one by
polling its completion from the host (:meth:`Mesh.wait` says why).  An
aborted mesh is done with: its groups may hold collectives no peer will
join, so its ranks build another (:meth:`Mesh.twin`) and
:meth:`Mesh.destroy` it.

Ranks compute on ``device``: ``"cpu"``, one card for all (``"cuda:0"``), or
``"cuda"``, which puts local rank ``r`` on card ``r % cards``.  The backend
is the caller's choice and nothing switches it: gloo works on both devices
(its all-reduce stages CUDA tensors through the host), NCCL needs one card
per rank and refuses two ranks of one communicator on one card, which
:func:`make_mesh` reports itself before NCCL does.

:func:`spawn` starts one process per rank on this host with a ``FileStore``
rendezvous, returns each rank's result, re-raises the first rank's error
and kills every other rank when one fails or the deadline passes.  It is
the counterpart of the JAX package's fake host devices.
"""

from __future__ import annotations

import datetime
import itertools
import math
import multiprocessing as mp
import os
import pickle
import queue
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

BACKENDS = ("gloo", "nccl")
DEFAULT_TIMEOUT_S = 120.0
EXIT_GRACE_S = 30.0   # how long ranks that all reported may take to exit
# how long a rank's error waits for a peer that died without a word: a peer's
# death reaches the others as lost-connection errors before its exit code can
# be read
SILENT_DEATH_GRACE_S = 1.0
# how often a rank waiting in a collective looks at its mesh's abort key
ABORT_POLL_S = 0.05
# how often a rank waiting in an NCCL collective asks whether it has ended
DEVICE_POLL_S = 2e-4


def production_mesh_shape(*, multi_pod: bool = False) -> tuple[tuple, tuple]:
    """``(shape, axes)`` of the dry run's production layout: 16 x 16 = 256
    ranks ``("data", "model")``; multi-pod prepends a 2-pod axis, (2, 16, 16)
    = 512 ranks ``("pod", "data", "model")``.  Shapes only: 256 ranks cannot
    be spawned here, so the dry run costs one rank of a :class:`MeshLayout`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def host_mesh_shape(shape=(2, 2), axes=("data", "model")) -> tuple[tuple, tuple]:
    """``(shape, axes)`` of a small mesh of ranks on this host, for tests and
    examples (:func:`spawn` starts it)."""
    return tuple(int(s) for s in shape), tuple(axes)


class MeshLayout:
    """One rank's place on a grid of ranks with named axes, and nothing
    else: the arithmetic :class:`Mesh` shares, without process groups.

    Rank ``r`` sits at ``np.unravel_index(r, shape)``: the last axis varies
    fastest, as in ``jax.make_mesh``.  On its own it stands in for a mesh
    whose ranks cannot be started (the dry run's 256): ``group`` returns the
    tuple of the group's global ranks, no process group, and a collective on
    it runs only under ``launch.op_analysis``, which records it.
    """

    def __init__(self, shape, axes, rank: int = 0):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes) or min(shape) < 1:
            raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
        self.size = math.prod(shape)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not on a {shape} mesh")
        self.shape = dict(zip(axes, shape))
        self.axes = axes
        self.rank = int(rank)
        self._coords = dict(zip(axes, (int(c) for c in np.unravel_index(self.rank, shape))))

    def _key(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.axes)
        if unknown or not axes:
            raise KeyError(f"axes {axes} are not a non-empty subset of the mesh axes {self.axes}")
        return tuple(a for a in self.axes if a in axes)

    def group(self, axes):
        """This rank's group along ``axes``: its :meth:`group_ranks`."""
        return self.group_ranks(axes)

    def group_ranks(self, axes) -> tuple:
        """The global ranks that share this rank's coordinates on every axis
        outside ``axes``, in rank order."""
        key = self._key(axes)
        grid = np.arange(self.size).reshape(tuple(self.shape.values()))
        index = tuple(slice(None) if a in key else self._coords[a] for a in self.axes)
        return tuple(int(r) for r in np.sort(grid[index], axis=None))

    def wait(self, work) -> None:
        """A layout runs no collective: ``launch.op_analysis`` records each
        one and hands back no work to wait for."""

    def group_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._key(axes))

    def coord(self, axis: str) -> int:
        return self._coords[self._key(axis)[0]]

    def shard(self, axes) -> tuple[int, int]:
        """``(index, count)`` of this rank's block when an array is split over
        ``axes`` in the given order (the first axis major), as
        ``PartitionSpec(axes)`` splits it."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        index, count = 0, 1
        for a in axes:
            self._key(a)
            index, count = index * self.shape[a] + self._coords[a], count * self.shape[a]
        return index, count

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape}, rank={self.rank})"


class MeshAborted(RuntimeError):
    """A collective on a mesh let go because a rank aborted the mesh."""


class Mesh(MeshLayout):
    """This rank's view of a grid of ranks with named axes, with a process
    group for every subset of the axes.

    Built by :func:`make_mesh` once the default process group exists.
    """

    def __init__(self, shape, axes, device, *, timeout_s: float = DEFAULT_TIMEOUT_S):
        size = math.prod(int(s) for s in shape)
        if dist.get_world_size() != size:
            raise ValueError(f"a {tuple(shape)} mesh needs {size} ranks, "
                             f"the process group has {dist.get_world_size()}")
        super().__init__(shape, axes, dist.get_rank())
        shape = tuple(self.shape.values())
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.timeout_s = float(timeout_s)
        timeout = datetime.timedelta(seconds=timeout_s)
        grid = np.arange(self.size).reshape(shape)
        self._groups = {}
        for n in range(1, len(axes) + 1):
            for sub in itertools.combinations(range(len(axes)), n):
                rest = [i for i in range(len(axes)) if i not in sub]
                # rows of the grid: the other axes fixed, ``sub`` varying
                blocks = np.transpose(grid, rest + list(sub)).reshape(-1, math.prod(shape[i] for i in sub))
                for ranks in blocks.tolist():
                    group = dist.new_group(ranks, timeout=timeout)
                    if self.rank in ranks:
                        self._groups[tuple(self.axes[i] for i in sub)] = group
        # objects and barriers travel over gloo whatever the tensors' backend
        self._host_group = dist.new_group(list(range(self.size)), timeout=timeout, backend="gloo")
        # this mesh's keys in the default group's store (the abort key); the
        # group's name is the same on every rank and new with every mesh
        self.store = dist.PrefixStore(f"mesh-{self._host_group.group_name}/",
                                      dist.distributed_c10d._get_default_store())

    def twin(self) -> "Mesh":
        """A second mesh on the same ranks, shape, axes, device and timeout,
        with process groups of its own: two threads of a rank may then
        each run collectives, one on each mesh.  A collective call, made
        by every rank in the same order."""
        return Mesh(tuple(self.shape.values()), self.axes, self.device, timeout_s=self.timeout_s)

    def group(self, axes):
        """The process group of the ranks that share this rank's coordinates
        on every axis outside ``axes``."""
        return self._groups[self._key(axes)]

    def wait(self, work) -> None:
        """Wait for ``work``, a collective sent with ``async_op=True`` on one
        of this mesh's groups; every ``ABORT_POLL_S`` raise
        :class:`MeshAborted` if a rank has aborted the mesh.  The
        collective's own error (a lost peer, the groups' timeout) is
        raised as it comes.  ``work`` is None where the collective was only
        recorded (``launch.op_analysis``).

        Under gloo the work is waited for in timed slices.  Under NCCL it is
        not: NCCL's ``wait(timeout)`` blocks the host and, when the
        collective has not ended within the timeout (a peer still counting,
        so any slice short enough to read the abort key), marks it failed
        and aborts the communicator.  So the host polls the work's
        completion (a query of its CUDA event, every ``DEVICE_POLL_S``) and
        then calls ``wait()``, which orders this rank's stream after it.
        The host is therefore held until the collective ends, as under
        gloo, and a device collective is not left in flight behind the
        host.  A peer that died is reported by NCCL's watchdog after the
        groups' timeout.  A rank released by an abort leaves its collective
        running on the card, waiting for the peers that never come: a
        device-wide synchronize waits for it until :meth:`destroy` aborts
        the mesh's communicators."""
        if work is None:
            return
        if self.backend == "nccl":
            self._wait_polled(work)
        else:
            self._wait_sliced(work)

    def _check_abort(self) -> None:
        if self.store.check(["abort"]):
            raise MeshAborted(f"{self.store.get('abort').decode()} aborted the mesh")

    def _wait_polled(self, work) -> None:
        look = time.monotonic() + ABORT_POLL_S
        while not work.is_completed():
            if time.monotonic() >= look:
                self._check_abort()
                look = time.monotonic() + ABORT_POLL_S
            time.sleep(DEVICE_POLL_S)
        work.wait()

    def _wait_sliced(self, work) -> None:
        """Wait for a gloo collective in slices of ``ABORT_POLL_S``."""
        slice_ = datetime.timedelta(seconds=ABORT_POLL_S)
        while True:
            try:
                work.wait(slice_)
                return
            except RuntimeError:
                if work.is_completed():   # it ended as the slice did: its own outcome, or error
                    work.wait()
                    return
            self._check_abort()

    def abort(self, who: str) -> None:
        """Release every rank waiting, or about to wait, in a collective of
        this mesh (``who`` names the rank in their :class:`MeshAborted`).
        Not a collective call.  The mesh is done with afterwards."""
        self.store.set("abort", who)

    def destroy(self) -> None:
        """Destroy this mesh's process groups (an aborted mesh's, once its
        replacement is built).  A gloo collective a peer never joined is
        left to gloo's timeout; it holds no other group.  NCCL groups are
        aborted (``ncclCommAbort``), which ends such a collective on the
        card; destroying them would wait for it."""
        for group in {*self._groups.values(), self._host_group}:
            if group is not self._host_group and self.backend == "nccl":
                dist.distributed_c10d._abort_process_group(group)
            else:
                dist.destroy_process_group(group)

    def barrier(self) -> None:
        self._wait_sliced(dist.barrier(group=self._host_group, async_op=True))

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank (pickled): the
        sizes, then the padded bytes, in two all-gathers."""
        data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(self.size)]
        self._wait_sliced(dist.all_gather(sizes, torch.tensor([data.numel()]), group=self._host_group,
                                          async_op=True))
        n = max(int(s) for s in sizes)
        blocks = [torch.empty(n, dtype=torch.uint8) for _ in range(self.size)]
        wire = torch.cat([data, torch.zeros(n - data.numel(), dtype=torch.uint8)])
        self._wait_sliced(dist.all_gather(blocks, wire, group=self._host_group, async_op=True))
        return [pickle.loads(b[: int(s)].numpy().tobytes()) for b, s in zip(blocks, sizes)]

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s CPU ``tensor`` into every rank's, in place."""
        self._wait_sliced(dist.broadcast(tensor, src, group=self._host_group, async_op=True))
        return tensor

    def broadcast_object(self, obj=None, src: int = 0):
        """Rank ``src``'s ``obj`` on every rank (pickled)."""
        box = [obj]
        dist.broadcast_object_list(box, src, group=self._host_group)
        return box[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device}, backend={self.backend})"


def rank_device(device, backend: str, local: int, local_world: int) -> torch.device:
    """The device one rank computes on.  ``"cuda"`` with no index puts local
    rank ``r`` on card ``r % cards``; an index pins every rank to that card.
    NCCL with two ranks of this host on one card raises here."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; use gloo on the CPU")
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    resolve_device(dev)
    cards = torch.cuda.device_count()
    if backend == "nccl" and local_world > 1 and (dev.index is not None or local_world > cards):
        raise RuntimeError(
            f"nccl needs one card per rank: {local_world} ranks on this host, "
            f"{cards if dev.index is None else 1} card(s) for them; run several ranks "
            "of one card with backend='gloo'")
    return torch.device("cuda", dev.index if dev.index is not None else local % cards)


def make_mesh(shape, axes, *, device="cuda", backend: str, timeout_s: float = DEFAULT_TIMEOUT_S,
              init_method: str = "env://", rank: int | None = None,
              world_size: int | None = None) -> Mesh:
    """Join (or reuse) the default process group and build this rank's
    :class:`Mesh`.

    ``init_method="env://"`` reads ``torchrun``'s rendezvous; :func:`spawn`
    passes a ``file://`` store with ``rank`` and ``world_size``.  The backend
    is required: nothing picks one.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not dist.is_initialized():
        kw = {} if rank is None else {"rank": rank, "world_size": world_size}
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size or math.prod(shape)))
        dev = rank_device(device, backend, local, local_world)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method,
                                timeout=datetime.timedelta(seconds=timeout_s), **kw)
    else:
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
        dev = rank_device(device, backend, int(os.environ.get("LOCAL_RANK", dist.get_rank())),
                          int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size())))
    return Mesh(shape, axes, dev, timeout_s=timeout_s)


def mesh_device(device, mesh: Mesh | None) -> torch.device:
    """The device an entry point runs on: ``device`` without a mesh; the
    mesh's device with one, where ``device`` must name the same kind (and
    card, if it names one)."""
    if mesh is None:
        return resolve_device(device)
    dev = torch.device(device)
    if dev.type != mesh.device.type or (dev.index is not None and dev.index != mesh.device.index):
        raise ValueError(f"device={dev} but the mesh's ranks compute on {mesh.device}")
    return mesh.device


def close_mesh() -> None:
    """Leave the default process group (the end of a rank's work)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------------ spawn --
class RankFailed(RuntimeError):
    """A rank of :func:`spawn` died without raising a Python error."""


def _rank_main(fn, rank, world, shape, axes, device, backend, timeout_s, store_path, out, args):
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    try:
        mesh = make_mesh(shape, axes, device=device, backend=backend, timeout_s=timeout_s,
                         init_method=f"file://{store_path}", rank=rank, world_size=world)
        result = fn(mesh, *args)
        sys.stdout.flush()
        sys.stderr.flush()
        out.put((rank, True, result))
    except BaseException as e:  # noqa: BLE001 — the parent re-raises it
        # reported before this rank leaves the group, so that it reaches the
        # parent ahead of the other ranks' lost-peer errors
        tb = traceback.format_exc()
        try:
            pickle.dumps(e)
            out.put((rank, False, (e, tb)))
        except Exception:  # noqa: BLE001 — an error that does not pickle
            out.put((rank, False, (RuntimeError(f"{type(e).__name__}: {e}"), tb)))
    finally:
        close_mesh()


def _silent_death(procs, done, reporter, grace_s: float):
    """A rank, neither ``reporter`` nor one in ``done``, that has exited
    with a non-zero code, watched for ``grace_s``; or None."""
    deadline = time.monotonic() + grace_s
    while True:
        for r, p in enumerate(procs):
            if r not in done and r != reporter and p.exitcode not in (None, 0):
                return r
        if time.monotonic() >= deadline:
            return None
        time.sleep(0.01)


def spawn(fn, shape, axes, *, device="cuda", backend: str, timeout_s: float = DEFAULT_TIMEOUT_S,
          args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` on ``prod(shape)`` new local ranks and return
    their results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path) and results
    come back pickled.  The first rank that raises has its error re-raised
    here, with the rank's traceback as the cause; a rank that dies without
    one raises :class:`RankFailed`; past ``timeout_s`` a ``TimeoutError``.
    Either way every rank still running is killed before this returns.
    """
    world = math.prod(shape)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(fn, r, world, tuple(shape), tuple(axes), str(device), backend,
                              timeout_s, os.path.join(tmp, "store"), out, tuple(args)))
            for r in range(world)
        ]
        results = {}
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            while len(results) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world} ranks did not finish within {timeout_s} s "
                                       f"(done: {sorted(results)})")
                try:
                    rank, ok, payload = out.get(timeout=min(left, 0.2))
                except queue.Empty:
                    rank, ok, payload = None, True, None
                # a rank that died without a word is the cause of its
                # peers' lost-connection errors
                dead = _silent_death(procs, results, rank, 0.0 if ok else SILENT_DEATH_GRACE_S)
                if dead is not None:
                    raise RankFailed(f"rank {dead} exited with code {procs[dead].exitcode}") from (
                        None if ok else payload[0])
                if not ok:
                    err, tb = payload
                    raise err from RankFailed(f"rank {rank} raised:\n{tb}")
                if rank is not None:
                    results[rank] = payload
        finally:
            # ranks that all reported leave on their own (flushing their
            # output); after a failure the survivors are killed at once
            grace = time.monotonic() + (EXIT_GRACE_S if len(results) == world else 0)
            started = [p for p in procs if p.pid is not None]
            for p in started:
                p.join(timeout=max(0.0, grace - time.monotonic()))
                if p.is_alive():
                    p.kill()
            for p in started:
                p.join(timeout=10)
            out.close()
    return [results[r] for r in range(world)]
