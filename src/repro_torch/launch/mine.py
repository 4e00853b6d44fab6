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

The in-memory paths: level-wise, SON and the paper's all-subsets map, over
dense or packed transactions.  The last line is the same JSON object the
JAX package's mine CLI prints (``seconds``, ``total_frequent``,
``levels``), so the two can be diffed.
"""

from __future__ import annotations

import argparse
import json
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
    args = ap.parse_args(argv)

    from repro_torch.core.apriori import AprioriConfig, mine
    from repro_torch.core.rules import extract_rules
    from repro_torch.core.son import mine_son
    from repro_torch.data.synthetic import QuestConfig, gen_transactions
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    qcfg = QuestConfig(num_transactions=args.transactions, num_items=args.items,
                       avg_len=args.avg_len, seed=args.seed)
    print(f"[mine] generating {args.transactions} transactions x {args.items} items ...")
    db = gen_transactions(qcfg)
    cfg = AprioriConfig(min_support=args.min_support, max_k=args.max_k, count_impl=args.impl,
                        representation=args.representation, use_naive_paper_map=(args.algo == "naive_paper"))

    t0 = time.time()
    if args.algo == "son":
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
            max_rules=args.max_rules, num_items=args.items,
        )
        rb.save(args.rulebook)
        print(f"[rulebook] {rb.num_rules} rules ({rb.num_rows} padded rows, "
              f"score={rb.score_kind}) -> {args.rulebook}")

    print(json.dumps({"seconds": dt, "total_frequent": res.total_frequent,
                      "levels": {k: int(v[0].shape[0]) for k, v in res.levels.items()}}))


if __name__ == "__main__":
    main()
