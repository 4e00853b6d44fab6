"""Continuous-refresh walkthrough on the card: append -> delta mine ->
hot-swap, live (PyTorch port of ``examples/serve_refresh.py``).

  PYTHONPATH=src python examples/torch/serve_refresh.py [--device cuda|cpu] \
      [--transactions 6000] [--items 96] [--append-frac 0.05]

The DESIGN.md §15 loop, step by step:

  1. ingest     — a synthetic Quest DB goes into an on-disk
                  ``TransactionStore`` (packed shards + manifest);
  2. seed       — ``build_count_cache`` runs the SON streamed mine ONCE and
                  persists what it used to throw away: the entire pre-prune
                  phase-1 union with exact global counts, stamped with the
                  store fingerprint it covers;
  3. serve      — the result compiles into a rulebook behind a live
                  ``Gateway`` (generation 0), and a ``RefreshController``
                  starts watching the store's row watermark;
  4. append     — new rows land through ``append_chunks``: shard files
                  first, then ONE atomic manifest rewrite publishes them
                  (a torn append is invisible);
  5. delta mine — the controller notices rows above the watermark and runs
                  ``mine_delta``: SON phase 1 over the NEW shards only,
                  cached candidates folded by integer addition, only the
                  genuinely novel ones re-counted over the base shards —
                  dict-identical to a full re-mine, at delta cost;
  6. swap       — the fresh rulebook hot-swaps in under traffic
                  (generation 1), ``generation_age_seconds`` re-stamps,
                  and the watermark advances to the rows now covered.

The same flow as a single command (plus a JSON summary for scripting):

  PYTHONPATH=src python -m repro_torch.launch.serve --refresh delta \
      --append-mid-load 0.05 --json refresh-smoke.json
"""

import argparse
import tempfile
import time

import numpy as np

from repro_torch.core import incremental as inc
from repro_torch.core.apriori import AprioriConfig
from repro_torch.data.store import append_chunks, ingest_quest, open_store
from repro_torch.data.synthetic import QuestConfig, gen_transactions
from repro_torch.serving import Gateway, RefreshController, compile_rulebook


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--transactions", type=int, default=6_000)
    ap.add_argument("--items", type=int, default=96)
    ap.add_argument("--append-frac", type=float, default=0.05)
    args = ap.parse_args(argv)

    cfg = AprioriConfig(min_support=0.02, max_k=3, representation="packed")
    with tempfile.TemporaryDirectory(prefix="refresh_store_") as d:
        # 1. ingest the base store
        store = ingest_quest(
            QuestConfig(num_transactions=args.transactions,
                        num_items=args.items, seed=1),
            d, shard_rows=1024)
        print(f"[1] store: n={store.num_transactions} "
              f"shards={store.num_partitions} (manifest seq={store.manifest.seq})")

        # 2. seed the count cache: one full SON mine, byproducts persisted
        res, cache = inc.build_count_cache(store, cfg, args.device, chunk_rows=1024)
        print(f"[2] count cache seq={cache.seq}: {cache.candidate_total()} "
              f"pre-prune candidates over levels {sorted(cache.levels)} "
              f"({res.total_frequent} frequent after pruning)")

        # 3. serve generation 0, controller watching the watermark
        rb = compile_rulebook(res, min_confidence=0.5, num_items=args.items)
        with Gateway(rb, device=args.device) as gw, RefreshController(
            d, gw, cfg, device=args.device, chunk_rows=1024, min_confidence=0.5,
            poll_interval_s=0.05,
        ) as ctl:
            print(f"[3] serving generation {gw.generation} "
                  f"({rb.num_rules} rules); watermark={ctl.watermark}")
            basket = np.flatnonzero(
                gen_transactions(QuestConfig(8, args.items, seed=2))[0]
            ).tolist() or [0]
            print(f"    probe basket {basket} -> "
                  f"{gw.submit(basket, top_k=3).result().items}")

            # 4. append new rows into the LIVE store
            extra = max(1, int(args.append_frac * args.transactions))
            grown = append_chunks(
                [gen_transactions(QuestConfig(extra, args.items, seed=9))], d)
            print(f"[4] appended {extra} rows -> n={grown.num_transactions} "
                  f"(manifest seq={grown.manifest.seq}); "
                  f"pending={ctl.pending_rows()}")

            # 5+6. the controller folds them in and swaps under traffic
            deadline = time.time() + 120
            while gw.generation == 0 and time.time() < deadline:
                gw.submit(basket, top_k=3).result()
                time.sleep(0.02)
            last = ctl.history[-1]
            print(f"[5] refresh: mode={last['mode']} ({last['reason']}) "
                  f"folded {last['delta_rows']} rows, "
                  f"{last['novel_candidates']} novel re-verified, "
                  f"in {last['seconds']:.2f}s")
            print(f"[6] serving generation {gw.generation} "
                  f"({last['rules']} rules); watermark={ctl.watermark}; "
                  f"age={gw.metrics.generation_age.value:.2f}s")

            # the delta result is dict-identical to a full re-mine: the
            # NEXT delta over the same store is a noop cache read
            _, rep = inc.mine_delta(open_store(d), cfg, args.device, chunk_rows=1024)
            print(f"[=] re-check: mine_delta now reports mode={rep.mode} "
                  f"({rep.reason}) — the cache covers the grown store")
    return res


if __name__ == "__main__":
    main()
