"""Quickstart: mine frequent itemsets + association rules on synthetic data,
on the card (PyTorch port of ``examples/quickstart.py``).

PYTHONPATH=src python examples/torch/quickstart.py [--device cuda|cpu]
                                                   [--transactions N] [--items I]

To go from mined rules to an ONLINE service (store -> mine_streamed ->
rulebook -> micro-batched gateway with live hot-swap, DESIGN.md §10), the
whole pipeline is one command:

    PYTHONPATH=src python -m repro_torch.launch.serve --transactions 4000 \
        --items 128 --requests 2000 --concurrency 16 --hot-swap-mid-load

(`examples/torch/serve_gateway.py` is the same flow, step by step; the
smaller `examples/torch/serve_rules.py` stops at the pre-assembled batch
engine.)

To watch that service against declared SLOs — burn-rate alerts, brownout
admission, p99-adaptive batching (DESIGN.md §14) — add ``--slo``:

    PYTHONPATH=src python -m repro_torch.launch.serve --replicas 3 --slo \
        --kill-replica-mid-load --alerts-jsonl alerts.jsonl

(`examples/torch/serve_slo.py` is the same loop, step by step.)
"""

import argparse

from repro_torch.core.apriori import AprioriConfig, mine
from repro_torch.core.rules import extract_rules
from repro_torch.data.synthetic import QuestConfig, gen_transactions


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--transactions", type=int, default=5_000)
    ap.add_argument("--items", type=int, default=200)
    args = ap.parse_args(argv)

    # 1. generate a T10-style transaction database (the paper's workload)
    db = gen_transactions(QuestConfig(num_transactions=args.transactions, num_items=args.items,
                                      avg_len=9, seed=42))
    print(f"DB: {db.shape[0]} transactions x {db.shape[1]} items, density {db.mean():.3f}")

    # 2. level-wise distributed Apriori (single device here; add a mesh for a pod)
    result = mine(db, AprioriConfig(min_support=0.03, max_k=5), device=args.device)
    for k in sorted(result.levels):
        print(f"  L{k}: {result.levels[k][0].shape[0]} frequent itemsets")

    # 3. association rules (KDD interpretation step)
    rules = extract_rules(result, min_confidence=0.7, max_rules=10)
    print("top rules:")
    for r in rules:
        print(f"  {r.antecedent} -> {r.consequent}   conf={r.confidence:.2f} lift={r.lift:.2f}")

    # 4. serve them online: see the module docstring — `repro_torch.launch.serve`
    #    runs store -> mine_streamed -> rulebook -> micro-batched gateway
    print("next: PYTHONPATH=src python -m repro_torch.launch.serve --hot-swap-mid-load")
    # 5. keep them fresh: appended rows fold in at delta cost and hot-swap
    #    under live traffic (DESIGN.md §15, examples/torch/serve_refresh.py)
    print("then: PYTHONPATH=src python -m repro_torch.launch.serve --refresh delta "
          "--append-mid-load 0.05")
    return result


if __name__ == "__main__":
    main()
