"""End-to-end online serving on the card: store -> mine_streamed -> rulebook
-> gateway (PyTorch port of ``examples/serve_gateway.py``).

  PYTHONPATH=src python examples/torch/serve_gateway.py [--device cuda|cpu] \
      [--transactions 4000] [--items 128] [--requests 1200] [--concurrency 12]

The full DESIGN.md §9 + §10 pipeline, step by step:

  1. ingest    — the synthetic Quest DB is written CHUNKED into an on-disk
                 ``TransactionStore`` (packed uint32 shards; the dense
                 matrix is never materialized);
  2. mine      — the streaming Map/Reduce driver (``mine_streamed``) folds
                 disk chunks through the count kernel (K1), one host sync
                 per candidate pass;
  3. compile   — the mined itemsets become a device-resident rulebook;
  4. serve     — a ``Gateway`` answers independent single-basket queries:
                 concurrent arrivals coalesce into power-of-two
                 buckets matched by K2, repeat baskets hit the
                 exact-basket LRU cache, and every response names the
                 rulebook generation that answered it;
  5. hot-swap  — while the client load is running, the store is re-mined
                 at a higher support and the fresh rulebook is swapped in
                 atomically: zero requests dropped, responses flip from
                 generation 0 to generation 1.

The same flow as a single command (plus a JSON summary for scripting):

  PYTHONPATH=src python -m repro_torch.launch.serve --transactions 4000 \
      --items 128 --requests 2000 --concurrency 16 --hot-swap-mid-load
"""

import argparse
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--transactions", type=int, default=4_000)
    ap.add_argument("--items", type=int, default=128)
    ap.add_argument("--avg-len", type=float, default=10.0)
    ap.add_argument("--min-support", type=float, default=0.02)
    ap.add_argument("--max-k", type=int, default=4)
    ap.add_argument("--min-confidence", type=float, default=0.4)
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--requests", type=int, default=1_200)
    ap.add_argument("--concurrency", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.core.apriori import AprioriConfig
    from repro_torch.core.streaming import mine_streamed
    from repro_torch.data.store import ingest_quest
    from repro_torch.data.synthetic import QuestConfig
    from repro_torch.serving import Gateway, compile_rulebook

    # ---- 1. ingest the synthetic DB into an on-disk store, chunked ----
    qcfg = QuestConfig(num_transactions=args.transactions, num_items=args.items,
                       avg_len=args.avg_len, seed=args.seed)
    tmp = tempfile.TemporaryDirectory(prefix="gateway_store_")
    store = ingest_quest(qcfg, tmp.name, shard_rows=2048, chunk_rows=2048)
    print(f"[gateway] store: n={store.num_transactions} items={store.num_items} "
          f"shards={store.num_partitions}")

    # ---- 2 + 3. mine_streamed -> compile a servable rulebook ----
    mined = []

    def mine_rulebook(min_support):
        res = mine_streamed(
            store,
            AprioriConfig(min_support=min_support, max_k=args.max_k,
                          representation="packed"),
            device=args.device,
            chunk_rows=2048,
        )
        mined.append(res)
        rb = compile_rulebook(res, min_confidence=args.min_confidence,
                              num_items=store.num_items)
        print(f"[gateway] min_support={min_support}: {res.total_frequent} itemsets "
              f"-> {rb.num_rules} rules")
        return rb

    rb0 = mine_rulebook(args.min_support)

    # client baskets = the store's own transactions (pre-packed rows)
    chunk, real = next(store.iter_chunks(min(2048, store.num_transactions)))
    baskets = list(chunk[:real])

    # ---- 4. gateway + concurrent client load, hot-swap mid-stream ----
    responses, lock = [], threading.Lock()

    with Gateway(rb0, device=args.device, top_k=args.top_k, max_batch=64, max_wait_ms=1.0,
                 cache_capacity=2048) as gw:

        def client(indices):
            for i in indices:
                resp = gw.submit(baskets[i % len(baskets)]).result(timeout=120)
                with lock:
                    responses.append(resp)

        half = args.requests // 2
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=args.concurrency) as pool:
            # first half of the load, answered by generation 0 ...
            for w in [pool.submit(client, range(o, half, args.concurrency))
                      for o in range(args.concurrency)]:
                w.result()
            # ---- 5. re-mine + hot-swap, then keep serving ----
            rb1 = mine_rulebook(2 * args.min_support)
            gen = gw.hot_swap(rb1)
            print(f"[gateway] hot-swapped to generation {gen}")
            for w in [pool.submit(client, range(half + o, args.requests, args.concurrency))
                      for o in range(args.concurrency)]:
                w.result()
        wall = time.perf_counter() - t0

        stats = gw.stats()

    gens = sorted({r.generation for r in responses})
    assert len(responses) == args.requests, "a request was dropped"
    assert gens == [0, 1], f"expected both generations to answer, saw {gens}"
    lat = np.array(sorted(r.latency_s for r in responses)) * 1e3
    print(f"[gateway] {len(responses)} responses in {wall:.2f}s "
          f"({len(responses) / wall:,.0f} qps) | generations={gens}")
    print(f"[gateway] latency p50={np.percentile(lat, 50):.2f}ms "
          f"p95={np.percentile(lat, 95):.2f}ms p99={np.percentile(lat, 99):.2f}ms")
    print(f"[gateway] batches={stats['batches']} occupancy={stats['batch_occupancy']:.2f} "
          f"cache_hit_rate={stats['cache_hit_rate']:.2f} swaps={stats['swaps']}")

    ex = responses[-1]
    print(f"[gateway] e.g. last response: items={ex.items.tolist()} "
          f"(generation {ex.generation}, cached={ex.cached}, "
          f"{ex.latency_s * 1e3:.2f}ms, bucket {ex.bucket})")
    tmp.cleanup()
    return mined[0]


if __name__ == "__main__":
    main()
