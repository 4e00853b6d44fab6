"""Rank functions of the port's multi-rank tests.

``repro_torch.launch.mesh.spawn`` pickles a rank function by its module
name, and every rank imports that module; this one imports only the port
and numpy (no jax), so a rank starts in about a second.  Each function runs
as one rank of a mesh on the CPU and returns plain Python or numpy values.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np
import torch

from repro_torch.core import incremental as inc
from repro_torch.core.apriori import AprioriConfig, mine
from repro_torch.core.mapreduce import MapReduceJob, hierarchical_psum, mapreduce
from repro_torch.core.son import mine_son
from repro_torch.core.streaming import (
    _effective_chunk_rows,
    count_union_streamed,
    mine_son_streamed,
    mine_streamed,
)
from repro_torch.data.store import append_chunks, open_store
from repro_torch.distributed.checkpoint import MiningCheckpoint
from repro_torch.serving.recommend import recommend
from repro_torch.serving.rulebook import place_rulebook


class Stop(BaseException):
    """Raised on every rank at the same save, as a crash would stop a mine."""


class StopAfter(MiningCheckpoint):
    """A checkpoint manager that stops the mine right after its Nth save."""

    def __init__(self, path, stop_after):
        super().__init__(path)
        self.stop_after, self.saves = stop_after, 0

    def save(self, state, store_fp, mine_fp):
        seq = super().save(state, store_fp, mine_fp)
        self.saves += 1
        if self.saves >= self.stop_after:
            self.wait()
            raise Stop()
        return seq


# ---------------------------------------------------------------- engine --
def reduce_ops(mesh):
    """A 1-rank sum, max and min through ``mapreduce``."""
    x = torch.arange(12.0).reshape(4, 3)
    out = {}
    for op, fn in (("sum", lambda v: v.sum(0)), ("max", lambda v: v.max(0).values),
                   ("min", lambda v: v.min(0).values)):
        out[op] = mapreduce(MapReduceJob(map_fn=fn, reduce_axes=("data",), reduce_op=op), mesh)(x).numpy()
    return out


def hierarchical(mesh):
    """``hierarchical_psum`` over ("pod", "data") of each rank's own rows,
    with and without an outer transform (int32 counts carried as float64
    over the outer hop), and a max job."""
    x = torch.arange(6, dtype=torch.int32) * (mesh.rank + 1)
    plain = hierarchical_psum(x.clone(), mesh, ("data",), ("pod",))
    calls = []

    def encode(v):
        calls.append("encode")
        return v.to(torch.float64)

    def decode(v):
        calls.append("decode")
        return v.to(torch.int32)

    narrowed = hierarchical_psum(x.clone(), mesh, ("data",), ("pod",), outer_transform=(encode, decode))
    inner = hierarchical_psum(x.clone(), mesh, ("data",))
    biggest = mapreduce(MapReduceJob(map_fn=lambda v: v, reduce_axes=("pod", "data"), reduce_op="max"),
                        mesh)(x.clone())
    return dict(plain=plain.numpy(), narrowed=narrowed.numpy(), narrowed_dtype=str(narrowed.dtype),
                inner=inner.numpy(), calls=calls, max=biggest.numpy())


# ----------------------------------------------------------------- mining --
def mine_dicts(mesh, db, cfgs):
    """``mine`` of ``db`` on the mesh under each config."""
    return [mine(db, cfg, device="cpu", mesh=mesh).as_dict() for cfg in cfgs]


def son_dicts(mesh, db, cfgs, num_partitions):
    return [mine_son(db, cfg, device="cpu", mesh=mesh, num_partitions=num_partitions).as_dict()
            for cfg in cfgs]


def stream_2x3(mesh, store_path):
    """The streamed miners on a (2, 3) mesh, both representations."""
    store = open_store(store_path)
    out = {}
    for rep in ("dense", "packed"):
        cfg = AprioriConfig(min_support=0.05, max_k=4, representation=rep, data_axes=("data",),
                            model_axis="model", candidate_pad=256)
        out[rep] = dict(
            chunk_rows=_effective_chunk_rows(67, cfg, mesh),
            streamed=mine_streamed(store, cfg, device="cpu", mesh=mesh, chunk_rows=67).as_dict(),
            son=mine_son_streamed(store, cfg, device="cpu", mesh=mesh, chunk_rows=64).as_dict(),
        )
    return out


def stream_2x2(mesh, store_path, per_level, delta_path, append_dense, stop_path, resume_path):
    """On a (2, 2) mesh: a union count; a count cache built, rows appended
    by rank 0 and a delta mine; a mine stopped after its second save; a
    mine resumed from a checkpoint written without a mesh."""
    cfg = AprioriConfig(min_support=0.05, max_k=4, representation="packed", data_axes=("data",),
                        model_axis="model")
    out = dict(union=count_union_streamed(open_store(store_path), per_level, cfg, device="cpu",
                                          mesh=mesh, chunk_rows=64))
    built, cache = inc.build_count_cache(open_store(delta_path), cfg, "cpu", chunk_rows=64, mesh=mesh)
    out["built"], out["cache_seq"] = built.as_dict(), cache.seq
    if mesh.rank == 0:
        append_chunks(iter([append_dense]), delta_path)
    mesh.barrier()
    res, rep = inc.mine_delta(open_store(delta_path), cfg, "cpu", chunk_rows=64, mesh=mesh)
    out["delta"], out["report"] = res.as_dict(), dataclasses.asdict(rep)
    try:
        mine_streamed(open_store(store_path), cfg, device="cpu", mesh=mesh, chunk_rows=64,
                      checkpoint=StopAfter(stop_path, 2), checkpoint_every_chunks=1)
        out["stopped"] = False
    except Stop:
        out["stopped"] = True
    out["resumed"] = mine_streamed(open_store(store_path), cfg, device="cpu", mesh=mesh, chunk_rows=64,
                                   checkpoint=MiningCheckpoint(resume_path), checkpoint_every_chunks=1,
                                   resume=True).as_dict()
    return out


# ---------------------------------------------------------------- serving --
def serve(mesh, rb, baskets, top_k, batch_size):
    """``place_rulebook`` and ``recommend`` on the mesh, from a placed and
    from a host rulebook."""
    placed = place_rulebook(rb, "cpu", mesh=mesh)
    a = recommend(placed, baskets, top_k=top_k, batch_size=batch_size, device="cpu", mesh=mesh)
    b = recommend(rb, baskets, top_k=top_k, batch_size=batch_size, device="cpu", mesh=mesh)
    refused = []
    if mesh.size > 1:
        try:
            recommend(place_rulebook(rb, "cpu"), baskets, device="cpu", mesh=mesh)
        except ValueError:
            refused.append("recommend")
        try:
            placed.to_host()
        except ValueError:
            refused.append("to_host")
    return dict(num_rows=placed.num_rows, num_rules=placed.num_rules,
                local_rows=int(placed.ante_packed.shape[0]), refused=refused,
                items=a.items, scores=a.scores, host_items=b.items, host_scores=b.scores)


# ----------------------------------------------------------------- faults --
def fail(mesh, how, pid_dir):
    """Rank 1 raises, hangs or exits; the other ranks wait in a collective.
    ``exit_late``: rank 0 raises at once, as a peer's lost-connection error
    does, and rank 1 exits without a word 0.3 s later."""
    with open(os.path.join(pid_dir, str(mesh.rank)), "w") as f:
        f.write(str(os.getpid()))
    mesh.barrier()   # every rank has written its pid
    if how == "exit_late":
        if mesh.rank == 0:
            raise RuntimeError("Connection reset by peer")
        time.sleep(0.3)
        os._exit(3)
    if mesh.rank == 1:
        if how == "raise":
            raise ValueError("rank 1 failed on purpose")
        if how == "exit":
            os._exit(3)
        time.sleep(3600)
    torch.distributed.all_reduce(torch.zeros(1), group=mesh.group(("data",)))
    return mesh.rank


def row_blocks(mesh, chunks):
    """The rows this rank's chunk iterator yields of each chunk."""
    from repro_torch.data.pipeline import ShardedBatchIterator

    with ShardedBatchIterator(iter(chunks), "cpu", mesh=mesh, data_axes=("data",)) as it:
        return [t.numpy() for t in it]


# ------------------------------------------------------------ on the card --
def card_kernels(mesh, db_path):
    """On the card, at the T10I4D100K shape: the mesh's level-2 pass through
    K1 (both modes) and K3, rows split and candidates split, and a mesh
    ``recommend`` of 1,024 baskets through K2, rules split and baskets split;
    each against this rank's single-device launches."""
    from repro_torch.core import apriori
    from repro_torch.core.candidates import generate_candidates
    from repro_torch.kernels import ops
    from repro_torch.serving.rulebook import compile_rulebook

    db = np.load(db_path)
    dev = mesh.device
    freq1 = np.flatnonzero(db.sum(0, dtype=np.int64) >= 200).astype(np.int32)[:, None]
    cands = generate_candidates(freq1)
    layouts = {"rows": dict(data_axes=("data",), model_axis="model"),
               "candidates": dict(data_axes=("model",), model_axis="data")}
    out = {}
    for rep, mode in (("packed", "and_cmp"), ("packed", "popcount"), ("dense", "and_cmp")):
        cfg = AprioriConfig(representation=rep, packed_mode=mode)
        want = apriori._count_level(apriori.make_count_step(cfg), apriori.place_db(db, cfg, dev), cands,
                                    db.shape[1], cfg)
        for name, axes in layouts.items():
            mcfg = dataclasses.replace(cfg, **axes)
            kernel = "support_count" if rep == "dense" else "support_count_packed"
            before = ops.launch_counts()[kernel]
            got = apriori._count_level(apriori.make_count_step(mcfg, mesh),
                                       apriori.place_db(db, mcfg, dev, mesh=mesh), cands, db.shape[1], mcfg,
                                       mesh)
            out[f"{rep}-{mode}-{name}"] = (bool(np.array_equal(got, want)),
                                           ops.launch_counts()[kernel] - before)
    res = mine(db, AprioriConfig(min_support=0.002, max_k=4, representation="packed"), device=dev)
    rb = compile_rulebook(res, min_confidence=0.4, num_items=db.shape[1])
    single = recommend(place_rulebook(rb, dev), db[:1024], top_k=10, batch_size=1024, device=dev)
    for name, (data_axes, rule_axis) in {"baskets": (("data",), "model"),
                                         "rules": (("model",), "data")}.items():
        before = ops.launch_counts()["rule_match"]
        got = recommend(rb, db[:1024], top_k=10, batch_size=1024, device="cuda", mesh=mesh,
                        data_axes=data_axes, rule_axis=rule_axis)
        out[f"k2-{name}"] = dict(items=got.items, scores=got.scores,
                                 launches=ops.launch_counts()["rule_match"] - before)
    out["k2-single"] = dict(items=single.items, scores=single.scores)
    return out


# ------------------------------------------------------- the mesh gateway --
def count_step_collectives(mesh, db, kp):
    """The (2, 2) mesh's packed count step on its blocks: every all-reduce
    it sends (elements, group ranks), and ``_count_level``'s whole counts."""
    import torch.distributed as dist

    from repro_torch.core import apriori
    from repro_torch.core.candidates import generate_candidates

    cfg = AprioriConfig(representation="packed", data_axes=("data",), model_axis="model")
    cands = generate_candidates(np.arange(db.shape[1], dtype=np.int32)[:, None])
    t = apriori.place_db(db, cfg, "cpu", mesh=mesh)
    c, ln = apriori._place_candidates(cands, kp, db.shape[1], cfg, "cpu", mesh)
    sent, all_reduce = [], dist.all_reduce

    def recorded(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
        sent.append((tensor.numel(), tuple(dist.get_process_group_ranks(group))))
        return all_reduce(tensor, op=op, group=group, async_op=async_op)

    dist.all_reduce = recorded
    try:
        block = apriori.make_count_step(cfg, mesh)(t, c, ln)
        step_sent = list(sent)
        counts = apriori._count_level(apriori.make_count_step(cfg, mesh), t, cands, db.shape[1], cfg, mesh)
    finally:
        dist.all_reduce = all_reduce
    return dict(block=block.numpy(), step_sent=step_sent, counts=counts, model=mesh.coord("model"))


def _drive(gw, baskets, clients, mid=None):
    """``clients`` closed-loop threads submit every basket (a dense row) once,
    one a request, as its item ids; ``mid()`` runs once half of them are
    answered.  Returns each basket's response (None where it failed) and
    the failures."""
    from concurrent.futures import ThreadPoolExecutor

    out, failed = [None] * len(baskets), []

    def client(indices):
        for i in indices:
            try:
                out[i] = gw.submit(np.flatnonzero(baskets[i]).tolist()).result(60)
            except Exception as e:  # noqa: BLE001 — counted as a drop
                failed.append(repr(e))

    half = len(baskets) // 2 if mid is not None else len(baskets)
    with ThreadPoolExecutor(max_workers=clients) as pool:
        for f in [pool.submit(client, range(c, half, clients)) for c in range(clients)]:
            f.result()
        if mid is not None:
            mid()
            for f in [pool.submit(client, range(half + c, len(baskets), clients)) for c in range(clients)]:
                f.result()
    return out, failed


def _answered(log):
    """Within ``with``: ``Gateway._match`` of this process logs the
    generation and bucket of every batch this rank answers."""
    from repro_torch.serving.gateway import Gateway

    match = Gateway._match

    def logged(self, b, gen, top_k, *args):
        log.append((gen.generation, int(b.shape[0])))
        return match(self, b, gen, top_k, *args)

    return match, logged


HOLD_S = 30.0          # the longest a rank waits for a file of the held-mine protocol
ANSWER_S = 8.0         # the longest the leader waits for answers while a mine is held
HELD_DEADLINE_MS = 5000.0
HELD_REQUESTS = 24
CLOSE_RELEASE_S = 2.0  # how long after rank 0's close() starts the closing cycle's mine is released


def _wait_files(paths, timeout=HOLD_S):
    deadline = time.monotonic() + timeout
    while not all(os.path.exists(p) for p in paths):
        if time.monotonic() > deadline:
            raise TimeoutError(f"waited {timeout} s for {[p for p in paths if not os.path.exists(p)]}")
        time.sleep(0.01)


def _touch(path):
    with open(path, "w"):
        pass


class HeldMines:
    """Within ``with``: this process's ``incremental.mine_delta``, its calls
    counted from 1.  A call named in ``plan`` (call -> (name, failing rank
    or None)) writes ``<name>-held-<rank>`` into ``hold_dir`` and waits
    until ``<name>-release`` is there (at most ``HOLD_S``) before it mines;
    on the failing rank it raises once it has mined."""

    def __init__(self, rank, hold_dir, plan):
        self.rank, self.hold_dir, self.plan, self.calls = rank, hold_dir, plan, 0

    def __enter__(self):
        self.mine_delta = inc.mine_delta

        def held(*args, **kwargs):
            self.calls += 1
            name, failing = self.plan.get(self.calls, (None, None))
            if name is not None:
                _touch(os.path.join(self.hold_dir, f"{name}-held-{self.rank}"))
                _wait_files([os.path.join(self.hold_dir, f"{name}-release")])
            out = self.mine_delta(*args, **kwargs)
            if failing == self.rank:
                raise RuntimeError(f"the mine fails on rank {self.rank} on purpose")
            return out

        inc.mine_delta = held
        return self

    def __exit__(self, *exc):
        inc.mine_delta = self.mine_delta

    def hold(self, name, size):
        """Leader: wait until every rank holds the mine ``name``."""
        _wait_files([os.path.join(self.hold_dir, f"{name}-held-{r}") for r in range(size)])

    def release(self, name):
        _touch(os.path.join(self.hold_dir, f"{name}-release"))


class GroupLog:
    """Within ``with``: every collective this process sends through
    ``torch.distributed``: whether it came from a refresh's mine cycle
    (``RefreshController._mine_cycle``) and the id of its group (None: the
    default group), and every overlap: a collective entered on a group
    while another thread's collective is still in it (one sent with
    ``async_op=True`` is in its group until it completes: the log waits for
    it), every mine mesh a failed cycle built (``Mesh.twin``), and the
    thread that sent each collective."""

    NAMES = ("all_reduce", "all_gather", "broadcast", "all_gather_object", "broadcast_object_list", "barrier")

    def __enter__(self):
        import torch.distributed as dist

        from repro_torch.serving.refresh import RefreshController

        self.dist, self.cls = dist, RefreshController
        self.calls, self.overlaps, busy = [], [], {}
        lock, local = threading.Lock(), threading.local()
        self.saved = {name: getattr(dist, name) for name in self.NAMES}
        self.mine_cycle = RefreshController._mine_cycle
        from repro_torch.launch.mesh import Mesh

        self.mesh_cls, self.twin, self.twins = Mesh, Mesh.twin, []

        def twin(mesh):
            self.twins.append(self.twin(mesh))
            return self.twins[-1]

        def wrap(name, fn):
            def run(*args, **kwargs):
                group = kwargs.get("group")
                key, me = (None if group is None else id(group)), threading.current_thread().name
                with lock:
                    if busy.get(key) is not None:
                        self.overlaps.append((name, me, busy[key]))
                    busy[key] = me
                    self.calls.append((getattr(local, "mine", False), key, threading.get_ident()))
                try:
                    work = fn(*args, **kwargs)
                    if kwargs.get("async_op") and work is not None:
                        work.wait()
                    return work
                finally:
                    with lock:
                        busy[key] = None

            return run

        def marked(ctl, *args, **kwargs):
            local.mine = True
            try:
                return self.mine_cycle(ctl, *args, **kwargs)
            finally:
                local.mine = False

        for name, fn in self.saved.items():
            setattr(dist, name, wrap(name, fn))
        RefreshController._mine_cycle = marked
        Mesh.twin = twin
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)
        self.cls._mine_cycle = self.mine_cycle
        self.mesh_cls.twin = self.twin

    def report(self, serving_mesh, mine_mesh) -> dict:
        """The calls on each mesh's groups (the mine's: ``mine_mesh``, the
        one the log began with, and every mine mesh built within the log),
        and those on a wrong one."""
        serving, mine = _group_ids(serving_mesh), _group_ids(mine_mesh, *self.twins)
        wrong = [(m, key) for m, key, _ in self.calls if key not in (mine if m else serving)]
        return dict(mine=sum(m for m, _, _ in self.calls), serving=sum(not m for m, _, _ in self.calls), wrong=wrong,
                    overlaps=self.overlaps, shared=sorted(serving & mine))

    def report_replicas(self, replica_meshes, mine_mesh) -> dict:
        """A router's replicas, each on a mesh of its own, and a refresh's
        mine on ``mine_mesh``: each replica's calls and the threads that
        sent them; the mine's calls; the calls on a group of none of these
        meshes (or the mine's outside its mesh); the groups two of them
        share; and every overlap.  A replica's ``switches`` count the
        calls on its groups sent by another thread than the call before."""
        meshes = [_group_ids(m) for m in replica_meshes]
        mine = _group_ids(mine_mesh)
        wrong = [(m, key) for m, key, _ in self.calls
                 if (key not in mine if m else not any(key in g for g in meshes))]
        every = meshes + [mine]
        shared = sorted({k for i, a in enumerate(every) for b in every[i + 1:] for k in a & b})
        replicas = []
        for g in meshes:
            threads = [t for m, key, t in self.calls if not m and key in g]
            replicas.append(dict(calls=len(threads), threads=len(set(threads)),
                                 switches=sum(a != b for a, b in zip(threads, threads[1:]))))
        return dict(replicas=replicas, mine=sum(m for m, _, _ in self.calls),
                    mine_threads=len({t for m, _, t in self.calls if m}), wrong=wrong, overlaps=self.overlaps,
                    shared=shared)


    def report_meshes(self, serving_meshes, caller, mine_meshes) -> dict:
        """A refresh's calls against three sets of groups: serving's (the
        target's meshes), the mesh the caller passed to the controller, and
        the mine's (``mine_meshes``: its mine mesh and every one a failed
        cycle built).  The calls of each, the calls on a group outside
        their set, the groups two sets share, and every overlap."""
        serving, mine, passed = _group_ids(*serving_meshes), _group_ids(*mine_meshes), _group_ids(caller)
        wrong = [(m, key) for m, key, _ in self.calls if key not in (mine if m else serving)]
        return dict(mine=sum(m for m, _, _ in self.calls), serving=sum(not m for m, _, _ in self.calls),
                    caller=sum(key in passed for _, key, _ in self.calls), wrong=wrong, overlaps=self.overlaps,
                    shared=sorted((serving & mine) | (serving & passed) | (mine & passed)))


def _group_ids(*meshes):
    return {id(g) for m in meshes for g in [*m._groups.values(), m._host_group]}


def _in_thread(fn):
    """``fn()`` in a thread of its own; returns the thread and a box that
    gets ``fn``'s result or its error's text."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except Exception as e:  # noqa: BLE001 — the caller reads it
            box["error"] = str(e)

    t = threading.Thread(target=run, name="test-refresh", daemon=True)
    t.start()
    return t, box


def _answers(gw, baskets, deadline_ms=HELD_DEADLINE_MS, wait_s=ANSWER_S):
    """Every basket submitted at once with a deadline; each response, or the
    text of what it failed with (not answered within ``wait_s`` included)."""
    from concurrent.futures import TimeoutError as NotYet

    gw.cache.evict_generation(gw.generation)   # answered by a batch, not the cache
    futs = [gw.submit(np.flatnonzero(b).tolist(), deadline_ms=deadline_ms) for b in baskets]
    deadline = time.monotonic() + wait_s
    got, failed = [None] * len(futs), []
    for i, f in enumerate(futs):
        try:
            got[i] = f.result(max(0.0, deadline - time.monotonic()))
        except NotYet:
            failed.append(f"request {i}: not answered within {wait_s} s")
        except Exception as e:  # noqa: BLE001 — DeadlineExceeded, AdmissionRejected
            failed.append(f"request {i}: {type(e).__name__}: {e}")
    return got, failed


def _live_threads():
    return sorted(t.name for t in threading.enumerate()
                  if t.is_alive() and t.name.startswith(("gateway-", "refresh-", "test-", "router-", "replica-set-")))


def _held_cycles(mesh, gw, ctl, held, baskets, rb1, store_path, made, out):
    """Three refresh cycles, each with its mine held on every rank.  A: 30
    rows appended; while the mine is held rank 0 submits baskets with a
    deadline (the old generation must answer them), then an operator's
    hot swap to ``rb1``, then more baskets; then the mine is released and
    the refresh commits.  B: the mine fails on the last rank, a follower,
    once it is released; baskets submitted while it is held.  C: rank 0
    closes the gateway while the mine is held; the mine is released
    ``CLOSE_RELEASE_S`` after the close began."""
    if mesh.rank != 0:
        out["held_refresh"] = ctl.refresh_now()
        out["held_rb"] = made[-1][1]
        for key in ("failed_mine", "closed_refresh"):
            try:
                ctl.refresh_now()
            except RuntimeError as e:
                out[key] = str(e)
        t0 = time.perf_counter()
        gw.close()
        out["close_s"] = time.perf_counter() - t0
        return
    append_chunks(iter([baskets[:30]]), store_path)
    refresher, box = _in_thread(ctl.refresh_now)
    held.hold("a", mesh.size)
    before = gw.generation
    got, failed = _answers(gw, baskets[:HELD_REQUESTS])
    out["held"] = dict(before=before, got=got, failed=failed, refresh_running=refresher.is_alive(),
                       generation=gw.generation, cycles=len(ctl.history))
    swapper, swap = _in_thread(lambda: gw.hot_swap(rb1))
    swapper.join(ANSWER_S)
    out["held_swap"] = dict(returned_while_held=not swapper.is_alive())
    got, failed = _answers(gw, baskets[HELD_REQUESTS : HELD_REQUESTS + 8])
    out["held_after_swap"] = dict(got=got, failed=failed, refresh_running=refresher.is_alive())
    held.release("a")
    refresher.join(HOLD_S)
    swapper.join(HOLD_S)
    out["held_swap"].update(swap)
    out["held_refresh"] = box.get("value", box.get("error"))
    out["held_rb"] = made[-1][1]
    got, failed = _answers(gw, baskets[:8])
    out["held_next"] = dict(got=got, failed=failed)

    refresher, box = _in_thread(ctl.refresh_now)
    held.hold("b", mesh.size)
    got, failed = _answers(gw, baskets[:HELD_REQUESTS])
    out["failing"] = dict(got=got, failed=failed, refresh_running=refresher.is_alive())
    held.release("b")
    refresher.join(HOLD_S)
    out["failed_mine"], out["kept_after_failure"] = box.get("error"), gw.generation

    refresher, box = _in_thread(ctl.refresh_now)
    held.hold("c", mesh.size)
    release = threading.Timer(CLOSE_RELEASE_S, held.release, ("c",))
    release.start()
    t0 = time.perf_counter()
    gw.close()
    out["close_s"] = time.perf_counter() - t0
    out["closed_while_held"] = not os.path.exists(os.path.join(held.hold_dir, "c-release"))
    release.join()
    refresher.join(HOLD_S)
    out["closed_refresh"] = box.get("error")


def mesh_gateway(mesh, rb0, rb1, baskets, store_path, cfg, top_k, max_batch, clients, hold_dir):
    """One rank of the mesh gateway: 90 baskets from ``clients`` threads
    on rank 0 with a hot swap to ``rb1`` at half load; then ``refresh_now``
    on every rank twice: under a config every rank refuses, then a delta
    mine of the rows appended to the store; then the baskets again, and one
    alone.  Every rank logs the batches it answered.  Then three refresh
    cycles whose mines are held on every rank (:func:`_held_cycles`), the
    last of which closes the gateway, while every collective is logged
    (:class:`GroupLog`).  After ``close()`` every rank runs the mesh
    ``recommend`` of each generation at each bucket rank 0 answered with."""
    from repro_torch.serving import refresh as refresh_mod
    from repro_torch.serving.gateway import Gateway
    from repro_torch.serving.refresh import RefreshController

    torch.set_num_threads(1)
    log, made = [], []
    compile_rulebook = refresh_mod.compile_rulebook

    def captured(res, **kw):
        rb = compile_rulebook(res, **kw)
        made.append((res, rb))
        return rb

    match, logged = _answered(log)
    Gateway._match, refresh_mod.compile_rulebook = logged, captured
    held = HeldMines(mesh.rank, hold_dir, {3: ("a", None), 4: ("b", mesh.size - 1), 5: ("c", None)})
    try:
        gw = Gateway(rb0, mesh=mesh, device="cpu", top_k=top_k, max_batch=max_batch, warmup="ladder",
                     max_wait_ms=2.0)
        ctl = RefreshController(store_path, gw, cfg, mesh=mesh, device="cpu", min_confidence=0.4,
                                chunk_rows=64)
        out = dict(rank=mesh.rank, ladder=gw.ladder())

        def refresh_twice():
            ctl.cfg = dataclasses.replace(cfg, representation="bitmap")   # every rank fails alike
            try:
                ctl.refresh_now()
            except RuntimeError as e:
                out["failed_refresh"] = str(e)
            ctl.cfg = cfg
            out["kept"] = gw.generation
            out["refreshed"] = ctl.refresh_now()

        first_mine = ctl.mine_mesh   # a failed cycle replaces it
        with held, GroupLog() as groups:
            if mesh.rank == 0:
                out["load"] = _drive(gw, baskets, clients, mid=lambda: gw.hot_swap(rb1))
                refresh_twice()
                out["after"] = _drive(gw, baskets, clients)
                gw.cache.evict_generation(gw.generation)   # basket 0 again, alone: bucket 2
                out["alone"] = gw.query(np.flatnonzero(baskets[0]).tolist())
            else:
                try:
                    gw.submit(baskets[0])
                except RuntimeError as e:
                    out["follower_submit"] = str(e)
                refresh_twice()
            answered = len(log)   # the followers' logs are cut to rank 0's below
            out["history"], out["failures"], res2_rb2 = list(ctl.history), ctl.metrics.failures, made[-1]
            _held_cycles(mesh, gw, ctl, held, baskets, rb1, store_path, made, out)
        out["groups"] = groups.report(mesh, first_mine)
        out["threads_after_close"] = _live_threads()
    finally:
        Gateway._match, refresh_mod.compile_rulebook = match, compile_rulebook
    out["answered"] = log[: mesh.broadcast_object(answered if mesh.rank == 0 else None)]
    out["answered_all"], out["history_all"] = log, ctl.history
    res2, rb2 = res2_rb2
    out["result"] = res2.as_dict()
    served = None
    if mesh.rank == 0:
        responses = out["load"][0] + out["after"][0] + [out["alone"]]
        for key in ("held", "held_after_swap", "held_next", "failing"):
            responses += out[key]["got"]
        # each generation's rulebook, by the ids rank 0 was handed
        names = {0: "rb0", 1: "rb1", 2: "rb2", out["held_swap"].get("value"): "rb1", out["held_refresh"]: "held"}
        served = (sorted({(r.generation, r.bucket) for r in responses if r is not None}), names)
    keys, names = mesh.broadcast_object(served)
    rbs = dict(rb0=rb0, rb1=rb1, rb2=rb2, held=out["held_rb"])
    refs = {key: recommend(rbs[names[key[0]]], baskets, top_k=top_k, batch_size=key[1], device="cpu", mesh=mesh)
            for key in keys}
    out["refs"] = {key: (r.items, r.scores) for key, r in refs.items()}
    out["rb2"] = rb2
    return out


def mesh_gateway_idle(mesh, rb, baskets, timeout_s, idle_s):
    """A gateway on a mesh whose groups time out after ``timeout_s``, idle
    for ``idle_s``, then serving ``baskets``; each response with the mesh
    ``recommend`` of its bucket."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serving.gateway import Gateway

    torch.set_num_threads(1)
    short = Mesh(tuple(mesh.shape.values()), mesh.axes, mesh.device, timeout_s=timeout_s)
    gw = Gateway(rb, mesh=short, device="cpu", top_k=5, max_batch=8)
    got = None
    if short.rank == 0:
        time.sleep(idle_s)
        got, failed = _drive(gw, baskets, 2)
        assert not failed, failed
    gw.close()
    buckets = short.broadcast_object(sorted({r.bucket for r in got}) if got else None)
    refs = {b: recommend(rb, baskets, top_k=5, batch_size=b, device="cpu", mesh=short) for b in buckets}
    return dict(got=got, refs={b: (r.items, r.scores) for b, r in refs.items()}, timeout_s=short.timeout_s)


def mesh_gateway_dies(mesh, rb, baskets, pid_dir):
    """Rank 0 serves a steady load; the follower of the highest rank exits
    without a word once the load runs."""
    from repro_torch.serving.gateway import Gateway

    torch.set_num_threads(1)
    with open(os.path.join(pid_dir, str(mesh.rank)), "w") as f:
        f.write(str(os.getpid()))
    gw = Gateway(rb, mesh=mesh, device="cpu", top_k=5, max_batch=8)
    if mesh.rank == mesh.size - 1:
        time.sleep(1.0)
        os._exit(3)
    if mesh.rank == 0:
        while True:
            _drive(gw, baskets, 2)
    gw.close()


def one_rank_gateway(mesh, rb, baskets):
    """A (1, 1) mesh: the single-device gateway, answering ``baskets``."""
    from repro_torch.serving.gateway import Gateway

    gw = Gateway(rb, mesh=mesh, device="cpu", top_k=5, max_batch=8)
    got, failed = _drive(gw, baskets, 2)
    gw.close()
    return dict(single=gw._mesh is None and gw._commands is None, got=got, failed=failed)


def mesh_refresh_idle(mesh, rb, baskets, store_path, cfg, timeout_s, idle_s):
    """A gateway and its refresh controller on a mesh whose groups time out
    after ``timeout_s``, every rank idle for ``idle_s`` (the mine mesh's
    groups see no traffic at all), then a refresh on every rank and
    ``baskets`` served by its generation."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serving import refresh as refresh_mod
    from repro_torch.serving.gateway import Gateway
    from repro_torch.serving.refresh import RefreshController

    torch.set_num_threads(1)
    short = Mesh(tuple(mesh.shape.values()), mesh.axes, mesh.device, timeout_s=timeout_s)
    made = []
    compile_rulebook = refresh_mod.compile_rulebook

    def captured(res, **kw):
        made.append(res)
        return compile_rulebook(res, **kw)

    refresh_mod.compile_rulebook = captured
    try:
        gw = Gateway(rb, mesh=short, device="cpu", top_k=5, max_batch=8)
        ctl = RefreshController(store_path, gw, cfg, mesh=short, device="cpu", min_confidence=0.4, chunk_rows=64)
        time.sleep(idle_s)
        refreshed = ctl.refresh_now()
        got = _drive(gw, baskets, 2) if short.rank == 0 else None
        gw.close()
    finally:
        refresh_mod.compile_rulebook = compile_rulebook
    return dict(refreshed=refreshed, got=got, result=made[-1].as_dict(), mode=ctl.history[-1]["mode"],
                timeouts=(short.timeout_s, ctl.mine_mesh.timeout_s))


# ------------------------------------------------- faults on the mesh tier --
def _short_mesh(mesh, timeout_s):
    """A mesh on ``mesh``'s ranks whose groups time out after ``timeout_s``."""
    from repro_torch.launch.mesh import Mesh

    return Mesh(tuple(mesh.shape.values()), mesh.axes, mesh.device, timeout_s=timeout_s)


class FailingBatches:
    """Within ``with``: this process's ``Gateway._match``, its calls counted
    from 1 (one a batch, on every rank).  ``plan`` maps a call to the ranks
    that fail it and where: ``"match"`` raises as ``_match`` starts, before
    the batch's all-gathers; ``"topk"`` raises in the top-k, between the
    rule axis's all-gather and the data axes'."""

    def __init__(self, rank, plan):
        self.rank, self.plan, self.calls = rank, plan, 0

    def __enter__(self):
        import importlib

        from repro_torch.serving.gateway import Gateway

        rec_mod = importlib.import_module("repro_torch.serving.recommend")   # the package's name is the function
        self.gateway, self.rec_mod = Gateway, rec_mod
        self.match, self.topk = Gateway._match, rec_mod._topk_items

        def match(gw, *args, **kwargs):
            self.calls += 1
            if self.plan.get(self.calls, {}).get(self.rank) == "match":
                raise RuntimeError(f"batch {self.calls} fails on rank {self.rank} before its all-gathers")
            return self.match(gw, *args, **kwargs)

        def topk(*args, **kwargs):
            if self.plan.get(self.calls, {}).get(self.rank) == "topk":
                raise RuntimeError(f"batch {self.calls} fails on rank {self.rank} between its all-gathers")
            return self.topk(*args, **kwargs)

        Gateway._match, rec_mod._topk_items = match, topk
        return self

    def __exit__(self, *exc):
        self.gateway._match, self.rec_mod._topk_items = self.match, self.topk


def _outcomes(futures, wait_s=ANSWER_S):
    """Each future's response, or the text of its error."""
    got = []
    for f in futures:
        try:
            got.append(f.result(wait_s))
        except Exception as e:  # noqa: BLE001 — the test reads it
            got.append(f"{type(e).__name__}: {e}")
    return got


def mesh_failing_batches(mesh, rb, baskets, top_k, max_batch, timeout_s, plan, clients):
    """A mesh gateway on groups that time out after ``timeout_s``, every
    rank failing the batches ``plan`` names (:class:`FailingBatches`).  Rank
    0 sends 15 baskets one at a time (a batch each), then the rest from
    ``clients`` threads at once.  Every rank closes its gateway,
    then runs the mesh ``recommend`` of each bucket rank 0 answered with."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.serving.gateway import Gateway

    torch.set_num_threads(1)
    short = _short_mesh(mesh, timeout_s)
    one_by_one = 15
    out = dict(rank=short.rank)
    with FailingBatches(short.rank, plan) as failing:
        gw = Gateway(rb, mesh=short, device="cpu", top_k=top_k, max_batch=max_batch, max_wait_ms=2.0)
        if short.rank == 0:
            out["alone"] = [_outcomes([gw.submit(np.flatnonzero(b).tolist())])[0] for b in baskets[:one_by_one]]
            rest = baskets[one_by_one:]
            with ThreadPoolExecutor(max_workers=clients) as pool:
                out["together"] = [f.result() for f in [
                    pool.submit(lambda idx: [_outcomes([gw.submit(np.flatnonzero(rest[i]).tolist())])[0]
                                             for i in idx], range(c, len(rest), clients))
                    for c in range(clients)]]
            out["failed_metric"] = gw.metrics.failed
        try:
            gw.close()
            out["closed"] = True
        except Exception as e:  # noqa: BLE001 — the test reads it
            out["closed"] = f"{type(e).__name__}: {e}"
        out["batches"], out["calls"] = getattr(gw, "_batch_seq", None), failing.calls
    buckets = None
    if short.rank == 0:
        answered = [r for r in out["alone"] + [r for c in out["together"] for r in c] if not isinstance(r, str)]
        buckets = sorted({r.bucket for r in answered})
    buckets = short.broadcast_object(buckets)
    refs = {b: recommend(rb, baskets, top_k=top_k, batch_size=b, device="cpu", mesh=short) for b in buckets}
    out["refs"] = {b: (r.items, r.scores) for b, r in refs.items()}
    return out


class FailingMines:
    """Within ``with``: this process's ``incremental.mine_delta``, its calls
    counted from 1 (one a refresh cycle, on every rank).  In a call named
    in ``failing`` this rank's second ``streaming._reduced`` (the union
    count's level 2, between its all-reduce and the level before's
    all-gather) writes ``<call>-held-<rank>`` into ``hold_dir``, waits for
    ``<call>-release`` (at most ``HOLD_S``) and raises."""

    def __init__(self, rank, hold_dir, failing):
        self.rank, self.hold_dir, self.failing, self.calls, self.armed = rank, hold_dir, failing, 0, 0

    def __enter__(self):
        from repro_torch.core import streaming

        self.streaming, self.mine_delta, self.reduced = streaming, inc.mine_delta, streaming._reduced

        def mine_delta(*args, **kwargs):
            self.calls += 1
            self.armed = 2 if self.calls in self.failing else 0
            return self.mine_delta(*args, **kwargs)

        def reduced(*args, **kwargs):
            if self.armed:
                self.armed -= 1
                if not self.armed:
                    _touch(os.path.join(self.hold_dir, f"{self.calls}-held-{self.rank}"))
                    _wait_files([os.path.join(self.hold_dir, f"{self.calls}-release")])
                    raise RuntimeError(f"mine {self.calls} fails on rank {self.rank} inside level 2")
            return self.reduced(*args, **kwargs)

        inc.mine_delta, streaming._reduced = mine_delta, reduced
        return self

    def __exit__(self, *exc):
        inc.mine_delta, self.streaming._reduced = self.mine_delta, self.reduced


def mesh_failing_refresh(mesh, rb, baskets, store_path, cfg, timeout_s, hold_dir, failing_rank, appended):
    """A mesh gateway and its refresh controller (delta mode) on groups that
    time out after ``timeout_s``, four cycles on every rank: the first and
    third fail on ``failing_rank`` inside level 2 of the mine (held there
    while rank 0 sends baskets with a deadline), the second and fourth are
    clean; before the third rank 0 appends ``appended`` to the store.  Rank
    0's commits wait 0.3 s, so a follower whose ``refresh_now`` returned
    before its commit would read the old generation.  Every rank records
    each cycle's outcome and ``gw.generation`` right after it, and the mine
    mesh's host group; rank 0 the requests and the time each failed cycle
    took to fail from the release."""
    from repro_torch.serving import refresh as refresh_mod
    from repro_torch.serving.gateway import Gateway
    from repro_torch.serving.refresh import RefreshController

    torch.set_num_threads(1)
    short = _short_mesh(mesh, timeout_s)
    made = []
    compile_rulebook, commit_swap = refresh_mod.compile_rulebook, Gateway.commit_swap

    def captured(res, **kw):
        rb_made = compile_rulebook(res, **kw)
        made.append((res, rb_made))
        return rb_made

    def slow_commit(gw, prepared):
        time.sleep(0.3)
        return commit_swap(gw, prepared)

    refresh_mod.compile_rulebook = captured
    if short.rank == 0:
        Gateway.commit_swap = slow_commit
    out = dict(rank=short.rank, cycles=[], mine_groups=[])
    try:
        with FailingMines(short.rank, hold_dir, {1, 3} if short.rank == failing_rank else set()):
            gw = Gateway(rb, mesh=short, device="cpu", top_k=5, max_batch=8, max_wait_ms=2.0)
            ctl = RefreshController(store_path, gw, cfg, mesh=short, device="cpu", min_confidence=0.4,
                                    chunk_rows=64)
            out["mine_groups"].append(ctl.mine_mesh._host_group.group_name)
            for cycle in (1, 2, 3, 4):
                if cycle == 3 and short.rank == 0:
                    append_chunks(iter([appended]), store_path)
                if short.rank == 0 and cycle in (1, 3):
                    refresher, box = _in_thread(ctl.refresh_now)
                    _wait_files([os.path.join(hold_dir, f"{cycle}-held-{failing_rank}")])
                    held = _answers(gw, baskets[:8])
                    t0 = time.perf_counter()
                    _touch(os.path.join(hold_dir, f"{cycle}-release"))
                    refresher.join(HOLD_S)
                    outcome = dict(error=box.get("error"), value=box.get("value"), held=held,
                                   fail_s=time.perf_counter() - t0, after=_answers(gw, baskets[8:16]))
                else:
                    try:
                        outcome = dict(value=ctl.refresh_now())
                    except RuntimeError as e:
                        outcome = dict(error=str(e))
                outcome["generation"] = gw.generation
                out["cycles"].append(outcome)
                out["mine_groups"].append(ctl.mine_mesh._host_group.group_name)
            if short.rank == 0:
                out["last"] = _answers(gw, baskets[:16])
            gw.close()
    finally:
        refresh_mod.compile_rulebook, Gateway.commit_swap = compile_rulebook, commit_swap
    out["results"] = [res.as_dict() for res, _ in made]
    out["history"] = ctl.history
    out["threads_after_close"] = _live_threads()
    # references: each generation's mesh recommend at each bucket rank 0 answered with
    keys = None
    if short.rank == 0:
        answered = [r for c in out["cycles"] if "held" in c for r in c["held"][0] + c["after"][0]]
        keys = sorted({(r.generation, r.bucket) for r in answered + out["last"][0] if r is not None})
    keys = short.broadcast_object(keys)
    rbs = {0: rb, **{g: rb_made for g, (_, rb_made) in enumerate(made, 1)}}   # the clean cycles' rulebooks
    out["refs"] = {key: (lambda r: (r.items, r.scores))(recommend(rbs[key[0]], baskets, top_k=5,
                                                                  batch_size=key[1], device="cpu", mesh=short))
                   for key in keys if key[0] in rbs}
    return out


# ------------------------------------------- the replicated tier on a mesh --
def _mined(made):
    """Within ``with``: ``refresh.compile_rulebook`` of this process, each
    (result, rulebook) it compiles appended to ``made``."""
    from repro_torch.serving import refresh as refresh_mod

    class Captured:
        def __enter__(self):
            self.fn = refresh_mod.compile_rulebook

            def captured(res, **kw):
                rb = self.fn(res, **kw)
                made.append((res, rb))
                return rb

            refresh_mod.compile_rulebook = captured
            return self

        def __exit__(self, *exc):
            refresh_mod.compile_rulebook = self.fn

    return Captured()


class Placed:
    """Within ``with``: every ``Gateway._prepare_everywhere`` of this process,
    logged as (the gateway, the generation, the rulebook it places)."""

    def __enter__(self):
        from repro_torch.serving.gateway import Gateway

        self.cls, self.fn, self.log = Gateway, Gateway._prepare_everywhere, []

        def logged(gw, generation, make_rulebook):
            def make():
                rb = make_rulebook()
                self.log.append((gw, generation, rb))
                return rb

            return self.fn(gw, generation, make)

        Gateway._prepare_everywhere = logged
        return self

    def __exit__(self, *exc):
        self.cls._prepare_everywhere = self.fn


def _healthy(router, generation, timeout=30.0):
    """Leader: wait until every replica is healthy at ``generation``; its stats."""
    deadline = time.monotonic() + timeout
    while True:
        stats = router.stats()
        if all(r["state"] == "healthy" and r["generation"] == generation for r in stats["replicas"]) \
                or time.monotonic() > deadline:
            return stats
        time.sleep(0.02)


def mesh_router(mesh, rb0, rb1, baskets, extra, store_path, cfg, top_k, max_batch, clients):
    """F13, one rank of ``Router(rb0, 2, mesh=mesh)``, refreshed by
    ``RefreshController(router, mesh=mesh)``: rank 0 sends ``baskets`` from
    ``clients`` threads, kills replica 0's dispatch worker and swaps to
    ``rb1`` at half load, waits until both replicas are healthy, appends
    ``extra`` to the store and refreshes in a thread while it sends the
    baskets again, then once more after the refresh; every other rank calls
    ``refresh_now``.  Every collective is logged (:class:`GroupLog`), every
    place (:class:`Placed`) and every mine.  After ``close()`` every rank
    runs the mesh ``recommend`` of each generation at each bucket rank 0
    answered with."""
    from repro_torch.distributed import FaultConfig
    from repro_torch.serving.refresh import RefreshController
    from repro_torch.serving.router import Router

    torch.set_num_threads(1)
    made, mines = [], []
    mine_delta = inc.mine_delta

    def counted(*args, **kwargs):
        mines.append(threading.current_thread().name)
        return mine_delta(*args, **kwargs)

    out = dict(rank=mesh.rank)
    inc.mine_delta = counted
    try:
        with _mined(made), Placed() as placed, GroupLog() as groups:
            router = Router(rb0, 2, mesh=mesh, device="cpu", top_k=top_k, max_batch=max_batch, warmup="ladder",
                            max_wait_ms=2.0, fault=FaultConfig(max_retries=3, backoff_s=0.01), attempt_timeout_s=5.0)
            ctl = RefreshController(store_path, router, cfg, mesh=mesh, device="cpu", min_confidence=0.4,
                                    chunk_rows=64)
            replica_meshes = [rep.gateway._mesh for rep in router.replicas]
            if mesh.rank == 0:
                def mid():
                    router.fault_injection.kill_replica(0)
                    out["swapped"] = router.hot_swap(rb1)

                out["load"] = _drive(router, baskets, clients, mid=mid)
                out["before_refresh"] = _healthy(router, 1)
                append_chunks(iter([extra]), store_path)
                refresher, box = _in_thread(ctl.refresh_now)
                out["during"] = _drive(router, baskets, clients)
                refresher.join(HOLD_S)
                out["refreshed"] = box.get("value", box.get("error"))
                out["after"] = _drive(router, baskets, clients)
                out["stats"] = _healthy(router, out["refreshed"])
                out["kills_fired"] = router.fault_injection.kills_fired
            else:
                for what, call in (("submit", lambda: router.submit(baskets[0])), ("stats", router.stats),
                                   ("hot_swap", lambda: router.hot_swap(rb1))):
                    try:
                        call()
                    except RuntimeError as e:
                        out[f"follower_{what}"] = str(e)
                out["refreshed"] = ctl.refresh_now()
            out["generations"] = [rep.gateway.generation for rep in router.replicas]
            router.close()
            ctl.close()
        out["groups"] = groups.report_replicas(replica_meshes, ctl.mine_mesh)
    finally:
        inc.mine_delta = mine_delta
    out["threads_after_close"] = _live_threads()
    out["mines"], out["history"] = mines, ctl.history
    res2, rb2 = made[-1]
    out["result"] = res2.as_dict()
    # the refresh's generation, placed on each replica from this rank's own rulebook
    gen2 = out["refreshed"]
    out["placed"] = [[(g, rb is rb2) for gw2, g, rb in placed.log if gw2 is rep.gateway and g == gen2]
                     for rep in router.replicas]
    answered = None
    if mesh.rank == 0:
        responses = [r for key in ("load", "during", "after") for r in out[key][0] if r is not None]
        answered = sorted({(r.generation, r.bucket) for r in responses})
    rbs = {0: rb0, 1: rb1, gen2: rb2}
    refs = {key: recommend(rbs[key[0]], baskets, top_k=top_k, batch_size=key[1], device="cpu", mesh=mesh)
            for key in mesh.broadcast_object(answered)}
    out["refs"] = {key: (r.items, r.scores) for key, r in refs.items()}
    return out


def mesh_refresh_single(mesh, rb0, baskets, stores, cfg, top_k, max_batch, clients, hold_dir):
    """F12, one rank: ``RefreshController(target, mesh=mesh)`` where rank 0's
    target serves on its one device and the other ranks pass None.  Four
    controllers, each on its own copy of a store with its count cache and
    40 rows appended (``stores``):

    * ``router``: ``Router(rb0, 2)`` on rank 0; a delta refresh on every
      rank while rank 0 sends the baskets, then the baskets again;
    * ``gateway``: ``Gateway(rb0)`` on rank 0; a refresh whose mine raises
      on the last rank (every rank raises, generation 0 serves on), then
      the baskets, then a refresh that commits, then the baskets;
    * ``full``: ``Gateway(rb0)``, ``mode="full"``: one refresh;
    * ``close``: ``Gateway(rb0)``; the refresh's mine held on every rank
      (:class:`HeldMines`) while rank 0 closes the controller, then
      released; then every rank's ``refresh_now`` once more.

    Each rank records every ``refresh_now``'s outcome, its history, the
    results mined, and the threads left; rank 0 the responses and each
    generation's single-device ``recommend`` at each bucket it answered."""
    from repro_torch.serving.gateway import Gateway
    from repro_torch.serving.refresh import RefreshController
    from repro_torch.serving.router import Router

    torch.set_num_threads(1)
    lead = mesh.rank == 0
    out = dict(rank=mesh.rank)
    made = []

    def controller(store, target, **kw):
        return RefreshController(store, target, cfg, mesh=mesh, device="cpu", min_confidence=0.4, chunk_rows=64,
                                 **kw)

    def outcome(call):
        try:
            return dict(value=call())
        except RuntimeError as e:
            return dict(error=str(e))

    rbs = {0: rb0}
    served = []
    with _mined(made):
        # router
        router = Router(rb0, 2, device="cpu", top_k=top_k, max_batch=max_batch, max_wait_ms=2.0) if lead else None
        ctl = controller(stores["router"], router)
        if lead:
            before = _drive(router, baskets, clients)
            refresher, box = _in_thread(ctl.refresh_now)
            during = _drive(router, baskets, clients)
            refresher.join(HOLD_S)
            out["router"] = dict(refreshed=box.get("value", box.get("error")), during=during,
                                 after=_drive(router, baskets, clients), before=before,
                                 generations=[rep.gateway.generation for rep in router.replicas],
                                 target=router.generation)
            served += [r for key in ("before", "during", "after") for r in out["router"][key][0]]
            router.close()
        else:
            out["router"] = dict(refreshed=ctl.refresh_now())
        ctl.close()
        out["router"].update(history=ctl.history, result=made[-1][0].as_dict())
        rbs[1] = made[-1][1]

        # gateway: a failed cycle, then one that commits
        gw = Gateway(rb0, device="cpu", top_k=top_k, max_batch=max_batch, max_wait_ms=2.0) if lead else None
        ctl = controller(stores["gateway"], gw)
        failing = mesh.size - 1
        mine_delta, calls = inc.mine_delta, []

        def fails_once(*args, **kwargs):
            calls.append(1)
            if mesh.rank == failing and len(calls) == 1:
                raise RuntimeError(f"the mine fails on rank {mesh.rank} on purpose")
            return mine_delta(*args, **kwargs)

        inc.mine_delta = fails_once
        try:
            failed = outcome(ctl.refresh_now)
            out["gateway"] = dict(failed=failed, failures=ctl.metrics.failures)
            if lead:
                out["gateway"]["kept"] = (gw.generation, _drive(gw, baskets, clients))
            out["gateway"]["refreshed"] = outcome(ctl.refresh_now)
        finally:
            inc.mine_delta = mine_delta
        if lead:
            out["gateway"]["after"] = _drive(gw, baskets, clients)
            served += [r for r in out["gateway"]["kept"][1][0] + out["gateway"]["after"][0]]
            gw.close()
        ctl.close()
        out["gateway"].update(history=ctl.history, result=made[-1][0].as_dict(), calls=len(calls))

        # mode="full"
        gw = Gateway(rb0, device="cpu", top_k=top_k, max_batch=max_batch) if lead else None
        ctl = controller(stores["full"], gw, mode="full")
        out["full"] = dict(refreshed=outcome(ctl.refresh_now))
        ctl.close()
        if lead:
            out["full"]["generation"] = gw.generation
            gw.close()
        out["full"].update(history=ctl.history, result=made[-1][0].as_dict())

        # close() during a cycle
        gw = Gateway(rb0, device="cpu", top_k=top_k, max_batch=max_batch) if lead else None
        ctl = controller(stores["close"], gw)
        with HeldMines(mesh.rank, hold_dir, {1: ("close", None)}) as held:
            if lead:
                refresher, box = _in_thread(ctl.refresh_now)
                held.hold("close", mesh.size)
                closer, _ = _in_thread(ctl.close)
                time.sleep(0.3)
                waited = closer.is_alive()
                held.release("close")
                closer.join(HOLD_S)
                refresher.join(HOLD_S)
                out["close"] = dict(refreshed=dict(error=box.get("error"), value=box.get("value")),
                                    close_waited=waited, closed=not closer.is_alive(), generation=gw.generation)
                gw.close()
            else:
                out["close"] = dict(refreshed=outcome(ctl.refresh_now))
                ctl.close()
        out["close"]["again"] = outcome(ctl.refresh_now)
        out["close"]["history"] = ctl.history
    out["threads_after_close"] = _live_threads()
    if lead:
        keys = sorted({(r.generation, r.bucket) for r in served if r is not None})
        out["refs"] = {key: (lambda r: (r.items, r.scores))(recommend(rbs[key[0]], baskets, top_k=top_k,
                                                                      batch_size=key[1], device="cpu"))
                       for key in keys}
    return out


# ------------------------- a refresh mining on a mesh of its own shape --
def mesh_refresh_reshaped(mesh, rb0, baskets, extra, stores, cfg, top_k, max_batch, clients, hold_dir):
    """F14, one rank: the target serves on the spawn's mesh (``mesh``, 2 x 2),
    and ``RefreshController(target, mesh=mine)`` mines on ``mine``, a
    (``mesh.size``, 1) ``("data", "model")`` mesh of the same ranks, built
    here.  Three controllers, each on its own copy of a store with its count
    cache and 40 rows appended (``stores``), every collective of the
    gateway's cycles after the failed one and of the router stage logged
    (:class:`GroupLog`):

    * ``gateway``: ``Gateway(rb0, mesh=mesh)``; a refresh whose mine raises
      on the last rank (every rank raises, generation 0 serves on), then a
      delta refresh on every rank while rank 0 sends the baskets before,
      during and after it; then ``extra`` appended and a third refresh whose
      mine is held on every rank (:class:`HeldMines`) while rank 0 closes
      the gateway;
    * ``router``: ``Router(rb0, 2, mesh=mesh)``; a delta refresh under load
      as above, every place logged (:class:`Placed`); then ``extra``
      appended and a refresh whose mine is held while rank 0 closes the
      controller;
    * ``full``: ``Gateway(rb0, mesh=mesh)``; a controller to which the
      followers pass None (refused on every rank), then one in
      ``mode="full"``: one refresh, then the baskets.

    Each rank records every ``refresh_now``'s outcome and the generation
    that serves right after it returns, its history, the results mined,
    the group report of each stage, and the threads left; then every rank
    runs the mesh ``recommend`` of each generation at each bucket rank 0
    answered with, on ``mesh``."""
    from repro_torch.distributed import FaultConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serving.gateway import Gateway
    from repro_torch.serving.refresh import RefreshController
    from repro_torch.serving.router import Router

    torch.set_num_threads(1)
    lead, last = mesh.rank == 0, mesh.size - 1
    mine = Mesh((mesh.size, 1), ("data", "model"), mesh.device, timeout_s=mesh.timeout_s)
    out = dict(rank=mesh.rank)
    made = []

    def controller(store, target, **kw):
        return RefreshController(store, target, cfg, mesh=mine, device="cpu", min_confidence=0.4, chunk_rows=64,
                                 **kw)

    def outcome(call, serving):
        """``call()``'s value or error, and the generation ``serving()``
        reads right after it returns."""
        try:
            got = dict(value=call())
        except RuntimeError as e:
            got = dict(error=str(e))
        got["serving"] = serving()
        return got

    def under_load(ctl, target, serving):
        """Rank 0: the baskets before, during and after ``ctl.refresh_now``;
        a follower: its ``refresh_now``."""
        if not lead:
            return dict(refreshed=outcome(ctl.refresh_now, serving))
        before = _drive(target, baskets, clients)
        refresher, box = _in_thread(ctl.refresh_now)
        during = _drive(target, baskets, clients)
        refresher.join(HOLD_S)
        return dict(refreshed=dict(value=box.get("value"), error=box.get("error"), serving=serving()),
                    before=before, during=during, after=_drive(target, baskets, clients))

    def held_close(ctl, held, name, closing, serving):
        """``extra`` appended; the next refresh's mine (``name`` in ``held``'s
        plan) held on every rank while rank 0 runs ``closing()``, then
        released."""
        if not lead:
            return dict(refreshed=outcome(ctl.refresh_now, serving))
        append_chunks(iter([extra]), ctl.store_path)
        refresher, box = _in_thread(ctl.refresh_now)
        held.hold(name, mesh.size)
        closer, _ = _in_thread(closing)
        time.sleep(0.3)
        waited = closer.is_alive()
        held.release(name)
        closer.join(HOLD_S)
        refresher.join(HOLD_S)
        return dict(refreshed=dict(value=box.get("value"), error=box.get("error"), serving=serving()),
                    close_waited=waited, closed=not closer.is_alive())

    rbs = {}
    with _mined(made):
        # gateway: a failed cycle, one under load, one closed while its mine is held
        mine_delta, calls = inc.mine_delta, []

        def fails_once(*args, **kwargs):   # before the mine: the count cache stays at 400 rows
            calls.append(1)
            if mesh.rank == last and len(calls) == 1:
                raise RuntimeError(f"the mine fails on rank {mesh.rank} on purpose")
            return mine_delta(*args, **kwargs)

        inc.mine_delta = fails_once
        try:
            with HeldMines(mesh.rank, hold_dir, {3: ("gateway", None)}) as held:
                gw = Gateway(rb0, mesh=mesh, device="cpu", top_k=top_k, max_batch=max_batch, max_wait_ms=2.0,
                             warmup="ladder")
                ctl = controller(stores["gateway"], gw)
                serving = lambda: gw.generation  # noqa: E731
                st = dict(failed=outcome(ctl.refresh_now, serving))
                st["failures"] = ctl.metrics.failures
                if lead:
                    st["kept"] = _drive(gw, baskets, clients)
                # from the rebuilt mine mesh on (the log waits for a collective whole, so an abort
                # could not release a rank from it)
                with GroupLog() as groups:
                    first_mine = ctl.mine_mesh
                    st.update(under_load(ctl, gw, serving))
                    rbs[("gateway", 1)] = made[-1][1]
                    st["result"] = made[-1][0].as_dict()
                    st["closing"] = held_close(ctl, held, "gateway", gw.close, serving)
                    if not lead:
                        gw.close()
                    ctl.close()
            st.update(history=ctl.history, mines=held.calls,
                      groups=groups.report_meshes([mesh], mine, [first_mine, *groups.twins]))
        finally:
            inc.mine_delta = mine_delta
        out["gateway"] = st

        # router: a refresh under load, then one whose controller closes while its mine is held
        with GroupLog() as groups, Placed() as placed, \
                HeldMines(mesh.rank, hold_dir, {2: ("router", None)}) as held:
            router = Router(rb0, 2, mesh=mesh, device="cpu", top_k=top_k, max_batch=max_batch, max_wait_ms=2.0,
                            fault=FaultConfig(max_retries=3, backoff_s=0.01), attempt_timeout_s=5.0)
            replica_meshes = [rep.gateway._mesh for rep in router.replicas]
            ctl = controller(stores["router"], router)
            first_mine, twins = ctl.mine_mesh, len(groups.twins)
            serving = lambda: [rep.gateway.generation for rep in router.replicas]  # noqa: E731
            st = under_load(ctl, router, serving)
            rb1 = rbs[("router", 1)] = made[-1][1]
            st["result"] = made[-1][0].as_dict()
            st["placed"] = [[g for gw2, g, rb in placed.log if gw2 is rep.gateway and rb is rb1]
                            for rep in router.replicas]
            st["closing"] = held_close(ctl, held, "router", ctl.close, serving)
            if not lead:
                ctl.close()
            st["again"] = outcome(ctl.refresh_now, serving)
            router.close()
        st.update(history=ctl.history, mines=held.calls,
                  groups=groups.report_meshes(replica_meshes, mine, [first_mine, *groups.twins[twins:]]))
        out["router"] = st

        # mode="full", after a controller whose followers pass None for the mesh gateway
        gw = Gateway(rb0, mesh=mesh, device="cpu", top_k=top_k, max_batch=max_batch, max_wait_ms=2.0)
        st = dict(refused=None)
        try:
            controller(stores["full"], gw if lead else None)
        except ValueError as e:
            st["refused"] = str(e)
        ctl = controller(stores["full"], gw, mode="full")
        st["refreshed"] = outcome(ctl.refresh_now, lambda: gw.generation)
        rbs[("full", 1)] = made[-1][1]
        if lead:
            st["after"] = _drive(gw, baskets, clients)
        gw.close()
        ctl.close()
        st.update(history=ctl.history, result=made[-1][0].as_dict())
        out["full"] = st
    out["threads_after_close"] = _live_threads()
    # references: each stage's generations, the mesh recommend on ``mesh`` at each bucket rank 0 answered with
    keys = None
    if lead:
        keys = sorted({(stage, r.generation, r.bucket) for stage, loads in (
            ("gateway", ("kept", "before", "during", "after")), ("router", ("before", "during", "after")),
            ("full", ("after",))) for key in loads for r in out[stage][key][0] if r is not None})
    refs = {}
    for stage, g, bucket in mesh.broadcast_object(keys):
        r = recommend(rbs.get((stage, g), rb0), baskets, top_k=top_k, batch_size=bucket, device="cpu", mesh=mesh)
        refs[(stage, g, bucket)] = (r.items, r.scores)
    out["refs"] = refs
    return out
