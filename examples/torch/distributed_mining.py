"""Distributed mining on a mesh of ranks, reproducing the paper's single-node
vs multi-node comparison (Fig 5) plus the SON two-round variant, on the card
(PyTorch port of ``examples/distributed_mining.py``).

PYTHONPATH=src python examples/torch/distributed_mining.py [--device cuda|cpu]
                                                           [--mesh 4x2]
                                                           [--transactions N] [--items I]

The JAX example fakes 8 XLA host devices in one process.  Here a rank is a
process: ``launch.mesh.spawn`` starts the 4 x 2 data x model mesh's 8 ranks
on this host over gloo (on one card, all 8 share it, each with its own CUDA
context), and each rank counts its block of rows and candidates through the
same kernels as the standalone mine.  The mesh walls are timed from a
barrier, so the spawn's set-up (processes, imports, contexts, rendezvous) is
reported apart.
"""

import argparse
import time

import torch

from repro_torch.core.apriori import AprioriConfig, mine
from repro_torch.core.son import mine_son
from repro_torch.data.synthetic import QuestConfig, gen_transactions
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod


def _rank(mesh, db, cfg):
    """One rank of the 'cluster': the level-wise mine and SON, each timed
    from a barrier; returns the walls and the mined dicts."""
    out = {}
    for name, run in (("mine", lambda: mine(db, cfg, device=mesh.device, mesh=mesh)),
                      ("son", lambda: mine_son(db, cfg, device=mesh.device, mesh=mesh,
                                               num_partitions=8))):
        mesh.barrier()
        t0 = time.time()
        res = run()
        out[name] = (time.time() - t0, res.as_dict(), res.total_frequent)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--mesh", default="4x2", metavar="DxM", help="data x model ranks")
    ap.add_argument("--transactions", type=int, default=20_000)
    ap.add_argument("--items", type=int, default=512)
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.mesh.split("x"))

    db = gen_transactions(QuestConfig(num_transactions=args.transactions, num_items=args.items,
                                      avg_len=10, seed=7))
    print(f"DB: {db.shape} ({db.nbytes/1e6:.0f} MB dense)")

    # single node (the paper's 'standalone').  Each rank below creates its
    # CUDA context in the mesh's set-up, which is reported apart; this
    # process creates its own before the timer, likewise
    torch.empty(0, device=resolve_device(args.device))
    cfg1 = AprioriConfig(min_support=0.02, max_k=5)
    t0 = time.time(); r1 = mine(db, cfg1, device=args.device); t1 = time.time() - t0
    print(f"standalone: {t1:.2f}s, {r1.total_frequent} itemsets")

    # 4x2 'cluster' (4-way transaction sharding x 2-way candidate sharding)
    cfg = AprioriConfig(min_support=0.02, max_k=5, data_axes=("data",), model_axis="model")
    t0 = time.time()
    ranks = mesh_mod.spawn(_rank, shape, ("data", "model"), device=args.device, backend="gloo",
                           timeout_s=600.0, args=(db, cfg))
    spawn_s = time.time() - t0
    t2 = max(r["mine"][0] for r in ranks)
    t3 = max(r["son"][0] for r in ranks)
    print(f"distributed ({args.mesh}): {t2:.2f}s, {ranks[0]['mine'][2]} itemsets "
          f"(speedup {t1/t2:.2f}x)")
    assert all(r["mine"][1] == r1.as_dict() for r in ranks), "distribution must not change results"

    # SON: 2 distributed rounds instead of max_k
    print(f"SON 2-phase: {t3:.2f}s, {ranks[0]['son'][2]} itemsets")
    assert all(r["son"][1] == r1.as_dict() for r in ranks)
    print(f"mesh set-up: {spawn_s - t2 - t3:.2f}s of the {spawn_s:.2f}s spawn "
          f"({len(ranks)} processes over gloo)")
    print("all modes agree — the paper's design claim, verified")
    return {"standalone": r1, "ranks": ranks}


if __name__ == "__main__":
    main()
