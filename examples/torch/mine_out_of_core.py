"""Out-of-core mining walkthrough on the card (PyTorch port of
``examples/mine_out_of_core.py``): ingest a Quest DB into an on-disk
partitioned store (chunked — the dense matrix is never materialized), then
mine it with the streaming Map/Reduce driver and verify bit-identical
results against the in-memory miner, reporting peak host RSS for both.

python examples/torch/mine_out_of_core.py [--device cuda|cpu]
                                          [--transactions N] [--items I]
                                          [--chunk-rows C] [--min-support S]
                                          [--kill-resume]

``--kill-resume`` adds the fault-tolerance walkthrough (DESIGN.md §11): the
same store is mined in a CHILD process with mid-level checkpointing enabled,
the child is ``kill -9``'d at its first mid-level commit, and a resumed mine
restores the snapshot and finishes — asserted dict-identical to the
uninterrupted streamed result.

Exits non-zero if streamed and in-memory results differ.
"""

import argparse
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time


def _child_kill(store_dir, cfg, chunk_rows, every, device):
    """Child mode: mine with checkpoints, SIGKILL at the first mid-level
    commit — a real node loss, no atexit, no finally."""
    import signal

    from repro_torch.core.streaming import mine_streamed
    from repro_torch.data.store import open_store
    from repro_torch.distributed.checkpoint import MiningCheckpoint

    store = open_store(store_dir)

    class Killing(MiningCheckpoint):
        def save(self, state, sfp, mfp):
            seq = super().save(state, sfp, mfp)
            if state.mid_level and state.next_k >= 2:
                self.wait()                 # snapshot committed; now "die"
                os.kill(os.getpid(), signal.SIGKILL)
            return seq

    mine_streamed(store, cfg, device=device, chunk_rows=chunk_rows,
                  checkpoint=Killing(store.checkpoint_path),
                  checkpoint_every_chunks=every)
    raise SystemExit("unreachable: the SIGKILL above must have fired")


def rss_mb() -> float:
    """Peak RSS of this process so far, in MB (ru_maxrss is KB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--transactions", type=int, default=30_000)
    ap.add_argument("--items", type=int, default=256)
    ap.add_argument("--chunk-rows", type=int, default=2048)
    ap.add_argument("--shard-rows", type=int, default=4096)
    ap.add_argument("--min-support", type=float, default=0.02)
    ap.add_argument("--max-k", type=int, default=4)
    ap.add_argument("--keep-store", default="", metavar="DIR",
                    help="ingest here and keep it (default: temp dir, removed)")
    ap.add_argument("--kill-resume", action="store_true",
                    help="also run the kill -9 / resume cycle (DESIGN.md §11)")
    ap.add_argument("--checkpoint-every", type=int, default=4, metavar="CHUNKS",
                    help="mid-level checkpoint cadence of the kill-resume cycle")
    ap.add_argument("--_child-kill", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from repro_torch.core.apriori import AprioriConfig, mine
    from repro_torch.core.streaming import mine_son_streamed, mine_streamed
    from repro_torch.data.store import ingest_quest
    from repro_torch.data.synthetic import QuestConfig, gen_transactions

    qcfg = QuestConfig(num_transactions=args.transactions, num_items=args.items,
                       avg_len=10, seed=7)
    cfg = AprioriConfig(min_support=args.min_support, max_k=args.max_k,
                        count_impl="auto", representation="packed")

    if args._child_kill:
        _child_kill(args._child_kill, cfg, args.chunk_rows, args.checkpoint_every, args.device)
        return None

    store_dir = args.keep_store or tempfile.mkdtemp(prefix="quest_store_")
    try:
        # --- 1. chunked ingest: generator -> packed shards on disk ---------
        t0 = time.time()
        store = ingest_quest(qcfg, store_dir, shard_rows=args.shard_rows,
                             chunk_rows=args.chunk_rows)
        disk_mb = sum(
            os.path.getsize(os.path.join(store_dir, f)) for f in os.listdir(store_dir)
        ) / 1e6
        print(f"ingest: {time.time()-t0:.2f}s -> {store.num_partitions} shards, "
              f"{disk_mb:.1f} MB on disk "
              f"(dense would be {args.transactions*args.items/1e6:.1f} MB in RAM)")

        # --- 2. streamed mine: host RAM bounded by chunk_rows --------------
        rss_before = rss_mb()
        t0 = time.time()
        streamed = mine_streamed(store, cfg, device=args.device, chunk_rows=args.chunk_rows)
        print(f"mine_streamed: {time.time()-t0:.2f}s, "
              f"{streamed.total_frequent} itemsets, "
              f"peak RSS delta {rss_mb()-rss_before:.1f} MB "
              f"(chunk = {args.chunk_rows} rows)")

        # --- 3. streamed SON: 2 rounds, shards as partitions ----------------
        t0 = time.time()
        son = mine_son_streamed(store, cfg, device=args.device, chunk_rows=args.chunk_rows)
        print(f"mine_son_streamed: {time.time()-t0:.2f}s, {son.total_frequent} itemsets")

        # --- 4. in-memory reference: the dense-materialization baseline ----
        t0 = time.time()
        db = gen_transactions(qcfg)
        inmem = mine(db, cfg, device=args.device)
        print(f"in-memory mine: {time.time()-t0:.2f}s "
              f"(dense DB resident: {db.nbytes/1e6:.1f} MB), "
              f"total peak RSS now {rss_mb():.1f} MB")

        assert streamed.as_dict() == inmem.as_dict(), "streamed != in-memory"
        assert son.as_dict() == inmem.as_dict(), "streamed SON != in-memory"
        assert streamed.min_count == inmem.min_count
        print("OUT_OF_CORE_OK — streamed, streamed-SON and in-memory results "
              "are dict-identical")

        # --- 5. (optional) kill -9 mid-mine, resume from the checkpoint ----
        if args.kill_resume:
            from repro_torch.distributed.checkpoint import MiningCheckpoint

            t0 = time.time()
            child = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--_child-kill", store_dir,
                 "--device", args.device,
                 "--chunk-rows", str(args.chunk_rows),
                 "--min-support", str(args.min_support),
                 "--max-k", str(args.max_k),
                 "--checkpoint-every", str(args.checkpoint_every)],
                capture_output=True, text=True, timeout=600, env=dict(os.environ),
            )
            assert child.returncode == -9, (
                f"child should die by SIGKILL, got rc={child.returncode}\n"
                f"{child.stderr[-2000:]}")
            snap, _ = MiningCheckpoint(store.checkpoint_path).load_latest()
            print(f"kill -9'd the child mid-level ({time.time()-t0:.2f}s): "
                  f"committed snapshot at level {snap.next_k}, "
                  f"{snap.chunks_done} chunks folded")
            t0 = time.time()
            resumed = mine_streamed(store, cfg, device=args.device, chunk_rows=args.chunk_rows,
                                    checkpoint=True,
                                    checkpoint_every_chunks=args.checkpoint_every,
                                    resume=True)
            assert resumed.as_dict() == streamed.as_dict(), "resumed != streamed"
            print(f"resume: {time.time()-t0:.2f}s — KILL_RESUME_OK, resumed "
                  "mine is dict-identical to the uninterrupted one")
        return streamed
    finally:
        if not args.keep_store:
            shutil.rmtree(store_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
