"""End-to-end mining driver on one device — the paper's job, CLI form.

  PYTHONPATH=src python -m repro_torch.launch.mine --transactions 20000 --items 256 \\
      --min-support 0.02 --max-k 5
  # mine AND emit a servable rulebook artifact (same .npz as the JAX package):
  PYTHONPATH=src python -m repro_torch.launch.mine ... --rulebook rb.npz \\
      --min-confidence 0.6 --rule-score confidence --max-rules 8192
  # SON, or the packed representation (K1) in place of the dense one (K3):
  PYTHONPATH=src python -m repro_torch.launch.mine ... --algo son --partitions 8
  PYTHONPATH=src python -m repro_torch.launch.mine ... --representation packed
  # on the CPU (plain versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.mine ... --device cpu
  # out of core: ingest into an on-disk store, stream-mine it with
  # checkpoints every 4 chunks, then resume from the newest checkpoint:
  PYTHONPATH=src python -m repro_torch.launch.mine ... --store DIR --ingest \
      --stream-chunk-rows 8192 --shard-rows 12500 --checkpoint-every 4
  PYTHONPATH=src python -m repro_torch.launch.mine ... --store DIR --checkpoint-every 4 --resume
  # streamed SON with the retrying phase-1 executor:
  PYTHONPATH=src python -m repro_torch.launch.mine ... --store DIR --algo son \
      --max-partition-retries 1

Level-wise, SON and the paper's all-subsets map, over dense or packed
transactions, in memory or (``--store``) streamed from an on-disk store
that either package may have written.  The last line is the same JSON object the
JAX package's mine CLI prints (``seconds``, ``total_frequent``,
``levels``), so the two can be diffed.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--transactions", type=int, default=20_000)
    ap.add_argument("--items", type=int, default=256)
    ap.add_argument("--avg-len", type=float, default=10.0)
    ap.add_argument("--min-support", type=float, default=0.02)
    ap.add_argument("--max-k", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", default="auto", choices=["auto", "kernel", "ref"],
                    help="count step: by device, the CUDA kernel only, or the plain version")
    ap.add_argument("--representation", default="dense", choices=["dense", "packed"],
                    help="device transaction store: dense {0,1} (K3) or packed uint32 bitsets (K1)")
    ap.add_argument("--algo", default="levelwise", choices=["levelwise", "son", "naive_paper"])
    ap.add_argument("--partitions", type=int, default=8, help="SON phase-1 partitions")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rules", action="store_true", help="extract association rules")
    ap.add_argument("--min-confidence", type=float, default=0.6)
    ap.add_argument("--rulebook", default="", metavar="PATH",
                    help="compile + save a servable rulebook artifact (.npz)")
    ap.add_argument("--rule-score", default="confidence", choices=["confidence", "lift"],
                    help="rulebook serving score column")
    ap.add_argument("--max-rules", type=int, default=None,
                    help="truncate the rulebook to the top-scoring rules")
    ap.add_argument("--store", default="", metavar="DIR",
                    help="on-disk transaction store: mine out of core through the "
                         "streaming miner (ingested here if absent)")
    ap.add_argument("--ingest", action="store_true",
                    help="force (re-)ingest of the synthetic DB into --store")
    ap.add_argument("--stream-chunk-rows", type=int, default=8192,
                    help="rows per streamed chunk (bounds host RAM during mining)")
    ap.add_argument("--shard-rows", type=int, default=8192,
                    help="rows per on-disk shard at ingest (= SON partition size)")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="CHUNKS",
                    help="streamed mining: persist a resumable checkpoint next to the "
                         "store manifest every N chunks (and at level boundaries)")
    ap.add_argument("--resume", action="store_true",
                    help="resume the streamed mine from the newest committed checkpoint "
                         "in the store's checkpoint dir")
    ap.add_argument("--max-partition-retries", type=int, default=None, metavar="N",
                    help="SON streamed phase 1: run shard mappers through the retrying "
                         "executor with N re-executions per partition")
    args = ap.parse_args(argv)

    if (args.checkpoint_every or args.resume) and not args.store:
        ap.error("--checkpoint-every/--resume need the streamed miner: add --store DIR")
    if args.max_partition_retries is not None and not (args.store and args.algo == "son"):
        ap.error("--max-partition-retries needs --store DIR and --algo son")

    from repro_torch.core.apriori import AprioriConfig, mine
    from repro_torch.core.rules import extract_rules
    from repro_torch.core.son import mine_son
    from repro_torch.data.synthetic import QuestConfig, gen_transactions
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    qcfg = QuestConfig(num_transactions=args.transactions, num_items=args.items,
                       avg_len=args.avg_len, seed=args.seed)
    db = store = None
    if args.store:
        from repro_torch.data.store import MANIFEST_NAME, ingest_quest, open_store

        if args.ingest or not os.path.exists(os.path.join(args.store, MANIFEST_NAME)):
            print(f"[mine] ingesting {args.transactions} x {args.items} (chunked) -> {args.store} ...")
            store = ingest_quest(qcfg, args.store, shard_rows=args.shard_rows,
                                 chunk_rows=args.stream_chunk_rows)
        else:
            store = open_store(args.store)
        print(f"[mine] store: n={store.num_transactions} items={store.num_items} "
              f"shards={store.num_partitions}")
    else:
        print(f"[mine] generating {args.transactions} transactions x {args.items} items ...")
        db = gen_transactions(qcfg)
    cfg = AprioriConfig(min_support=args.min_support, max_k=args.max_k, count_impl=args.impl,
                        representation=args.representation, use_naive_paper_map=(args.algo == "naive_paper"))

    t0 = time.time()
    if store is not None:
        from repro_torch.core.streaming import mine_son_streamed, mine_streamed

        if args.algo == "son":
            fault = None
            if args.max_partition_retries is not None:
                from repro_torch.distributed.fault_tolerance import FaultConfig

                fault = FaultConfig(max_retries=args.max_partition_retries)
            res = mine_son_streamed(store, cfg, device=device, chunk_rows=args.stream_chunk_rows,
                                    fault=fault)
            if res.fault_report is not None:
                print(f"[mine] SON fault report: {json.dumps(res.fault_report.to_json())}")
        else:
            use_ckpt = bool(args.checkpoint_every) or args.resume
            if args.resume:
                print(f"[mine] resuming from {store.checkpoint_path} (if a committed checkpoint exists)")
            res = mine_streamed(store, cfg, device=device, chunk_rows=args.stream_chunk_rows,
                                checkpoint=True if use_ckpt else None,
                                checkpoint_every_chunks=args.checkpoint_every, resume=args.resume)
    elif args.algo == "son":
        res = mine_son(db, cfg, device=device, num_partitions=args.partitions)
    else:
        res = mine(db, cfg, device=device)
    dt = time.time() - t0

    print(f"[mine] {dt:.2f}s on {device}; min_count={res.min_count}")
    for k in sorted(res.levels):
        sets, sup = res.levels[k]
        print(f"  level {k}: {sets.shape[0]:6d} frequent itemsets "
              f"(max support {int(sup.max()) if sup.size else 0})")
    print(f"  total: {res.total_frequent}")

    if args.rules:
        rules = extract_rules(res, min_confidence=args.min_confidence, max_rules=20)
        print(f"[rules] top {len(rules)} by confidence:")
        for r in rules:
            print(f"  {r.antecedent} -> {r.consequent}  conf={r.confidence:.3f} "
                  f"supp={r.support:.4f} lift={r.lift:.2f}")
    if args.rulebook:
        from repro_torch.serving.rulebook import compile_rulebook

        rb = compile_rulebook(
            res, min_confidence=args.min_confidence, score=args.rule_score,
            max_rules=args.max_rules, num_items=store.num_items if store else args.items,
        )
        rb.save(args.rulebook)
        print(f"[rulebook] {rb.num_rules} rules ({rb.num_rows} padded rows, "
              f"score={rb.score_kind}) -> {args.rulebook}")

    print(json.dumps({"seconds": dt, "total_frequent": res.total_frequent,
                      "levels": {k: int(v[0].shape[0]) for k, v in res.levels.items()}}))


if __name__ == "__main__":
    main()
