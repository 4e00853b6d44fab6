"""End-to-end rule serving on the card: mine -> compile rulebook -> batched
recommend (PyTorch port of ``examples/serve_rules.py``).

  PYTHONPATH=src python examples/torch/serve_rules.py [--device cuda|cpu] \
      [--transactions 4000] [--items 128] [--min-support 0.02] \
      [--min-confidence 0.5] [--top-k 5] [--batch-size 512] [--rulebook rb.npz]

The three stages (DESIGN.md §8):

  1. mine        — level-wise Apriori on the packed bitset path
                   (``core.apriori.mine``, representation='packed': K1);
  2. compile     — vectorized rule extraction + rulebook compilation
                   (``serving.compile_rulebook``): packed uint32
                   antecedent/consequent bitsets + a float32 score column,
                   saved/loaded as one ``.npz`` artifact;
  3. serve       — the batched query engine (``serving.recommend``): the
                   rule-match kernel (K2) scores every (basket, rule) pair,
                   aggregates evidence per item, masks the basket's own
                   items, and takes top-k.

The same artifact can be produced straight from the mining CLI:

  PYTHONPATH=src python -m repro_torch.launch.mine --transactions 4000 --items 128 \
      --rulebook rb.npz --min-confidence 0.5 --rule-score confidence

and a stored rulebook can be served without re-mining by passing
``--rulebook rb.npz`` here (it is loaded if the file exists).
"""

import argparse
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--transactions", type=int, default=4_000)
    ap.add_argument("--items", type=int, default=128)
    ap.add_argument("--avg-len", type=float, default=10.0)
    ap.add_argument("--min-support", type=float, default=0.02)
    ap.add_argument("--max-k", type=int, default=4)
    ap.add_argument("--min-confidence", type=float, default=0.5)
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--num-queries", type=int, default=1024)
    ap.add_argument("--impl", default="auto", choices=["auto", "kernel", "ref"])
    ap.add_argument("--rulebook", default="", metavar="PATH",
                    help="save the compiled rulebook here (and reuse it if present)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.core.apriori import AprioriConfig, mine
    from repro_torch.data.synthetic import QuestConfig, gen_transactions
    from repro_torch.serving import Rulebook, compile_rulebook, recommend

    print(f"[serve_rules] generating {args.transactions} x {args.items} transactions ...")
    db = gen_transactions(QuestConfig(
        num_transactions=args.transactions, num_items=args.items,
        avg_len=args.avg_len, seed=args.seed))

    res = None
    if args.rulebook and os.path.exists(args.rulebook):
        rb = Rulebook.load(args.rulebook)
        print(f"[serve_rules] loaded rulebook {args.rulebook}: {rb.num_rules} rules")
    else:
        t0 = time.perf_counter()
        res = mine(db, AprioriConfig(
            min_support=args.min_support, max_k=args.max_k,
            count_impl="auto", representation="packed"), device=args.device)
        t_mine = time.perf_counter() - t0
        print(f"[serve_rules] mined {res.total_frequent} frequent itemsets "
              f"in {t_mine:.2f}s (min_count={res.min_count})")

        t0 = time.perf_counter()
        rb = compile_rulebook(res, min_confidence=args.min_confidence,
                              num_items=args.items)
        print(f"[serve_rules] compiled {rb.num_rules} rules "
              f"({rb.num_rows} padded rows, score={rb.score_kind}) "
              f"in {time.perf_counter() - t0:.2f}s")
        if args.rulebook:
            rb.save(args.rulebook)
            rb = Rulebook.load(args.rulebook)   # round-trip the artifact
            print(f"[serve_rules] saved + reloaded {args.rulebook}")

    # queries: the transaction rows themselves make natural baskets
    queries = db[: args.num_queries]
    out = recommend(rb, queries, top_k=args.top_k, batch_size=args.batch_size,
                    impl=args.impl, device=args.device)   # warm: builds and places
    t0 = time.perf_counter()
    out = recommend(rb, queries, top_k=args.top_k, batch_size=args.batch_size,
                    impl=args.impl, device=args.device)
    dt = time.perf_counter() - t0
    qps = len(queries) / dt
    print(f"[serve_rules] served {len(queries)} baskets in {dt:.3f}s "
          f"({qps:,.0f} queries/s, batch={args.batch_size})")

    for b in range(min(3, len(queries))):
        have = np.flatnonzero(db[b]).tolist()
        recs = [(int(i), float(s)) for i, s in zip(out.items[b], out.scores[b])
                if np.isfinite(s) and s > 0]
        print(f"  basket {b} {have} -> {recs}")
    return res


if __name__ == "__main__":
    main()
