"""Rank functions of the port's multi-rank tests.

``repro_torch.launch.mesh.spawn`` pickles a rank function by its module
name, and every rank imports that module; this one imports only the port
and numpy (no jax), so a rank starts in about a second.  Each function runs
as one rank of a mesh on the CPU and returns plain Python or numpy values.
"""

from __future__ import annotations

import dataclasses
import os
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

    def logged(self, b, gen, top_k):
        log.append((gen.generation, int(b.shape[0])))
        return match(self, b, gen, top_k)

    return match, logged


def mesh_gateway(mesh, rb0, rb1, baskets, store_path, cfg, top_k, max_batch, clients):
    """One rank of the mesh gateway: 90 baskets from ``clients`` threads
    on rank 0 with a hot swap to ``rb1`` at half load; then ``refresh_now``
    on every rank twice: under a config every rank refuses, then a delta
    mine of the rows appended to the store; then the baskets again, and one
    alone.  Every rank logs the batches it
    answered; after ``close()`` every rank runs the mesh ``recommend`` of
    each generation at each bucket rank 0 answered with."""
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
        gw.close()
    finally:
        Gateway._match, refresh_mod.compile_rulebook = match, compile_rulebook
    out["answered"], out["history"], out["failures"] = log, ctl.history, ctl.metrics.failures
    res2, rb2 = made[-1]
    out["result"] = res2.as_dict()
    responses = (out["load"][0] + out["after"][0] + [out["alone"]]) if mesh.rank == 0 else None
    keys = mesh.broadcast_object(sorted({(r.generation, r.bucket) for r in responses}) if responses else None)
    rbs = {0: rb0, 1: rb1, 2: rb2}
    refs = {key: recommend(rbs[key[0]], baskets, top_k=top_k, batch_size=key[1], device="cpu", mesh=mesh)
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
