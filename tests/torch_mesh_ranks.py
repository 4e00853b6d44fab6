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
