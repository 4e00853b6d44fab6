"""Replicated serving walkthrough on the card: router, replica kill,
coordinated swap (PyTorch port of ``examples/serve_replicated.py``).

  PYTHONPATH=src python examples/torch/serve_replicated.py [--device cuda|cpu] \
      [--transactions 4000] [--items 128] [--requests 1200] [--replicas 3]

The DESIGN.md §12 tier, step by step:

  1. ingest + mine — same store -> ``mine_streamed`` -> rulebook pipeline
                     as examples/torch/serve_gateway.py;
  2. replicate     — a ``Router`` fronts N independent ``Gateway`` replicas
                     (each with its own micro-batcher, basket cache and
                     device-resident rulebook) behind consistent basket
                     hashing, so a repeat basket lands on the SAME replica
                     and its LRU cache stays effective;
  3. kill          — mid-load, fault injection kills one replica's dispatch
                     worker: in-flight requests fail over to the next
                     replica on the hash ring while the router's supervisor
                     restarts the dead worker — zero requests dropped;
  4. swap          — a coordinated two-phase hot-swap (prepare on every
                     healthy replica, then flip) moves the whole replica
                     set to the new rulebook generation with traffic live;
  5. verify        — every response is bit-identical to an offline
                     ``recommend()`` against the generation that answered.

The same flow as a single command (plus a JSON summary for scripting):

  PYTHONPATH=src python -m repro_torch.launch.serve --replicas 3 \
      --kill-replica-mid-load --hot-swap-mid-load --requests 2000
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
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.core.apriori import AprioriConfig
    from repro_torch.core.streaming import mine_streamed
    from repro_torch.data.store import ingest_quest
    from repro_torch.data.synthetic import QuestConfig
    from repro_torch.distributed import FaultConfig
    from repro_torch.serving import Router, compile_rulebook, recommend

    # ---- 1. ingest + mine (identical to the single-gateway example) ----
    qcfg = QuestConfig(num_transactions=args.transactions, num_items=args.items,
                       avg_len=args.avg_len, seed=args.seed)
    tmp = tempfile.TemporaryDirectory(prefix="router_store_")
    store = ingest_quest(qcfg, tmp.name, shard_rows=2048, chunk_rows=2048)
    print(f"[router] store: n={store.num_transactions} items={store.num_items}")

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
        print(f"[router] min_support={min_support}: {res.total_frequent} itemsets "
              f"-> {rb.num_rules} rules")
        return rb

    rb0 = mine_rulebook(args.min_support)
    rb1 = mine_rulebook(2 * args.min_support)
    rulebooks = {0: rb0, 1: rb1}

    chunk, real = next(store.iter_chunks(min(2048, store.num_transactions)))
    baskets = list(chunk[:real])

    # ---- 2. the replicated tier + a concurrent client load ----
    responses, lock = [], threading.Lock()

    with Router(rb0, args.replicas, device=args.device, top_k=args.top_k, max_batch=64,
                max_wait_ms=1.0, cache_capacity=2048,
                fault=FaultConfig(max_retries=3, backoff_s=0.01),
                attempt_timeout_s=1.0) as router:
        print(f"[router] {args.replicas} replicas on a consistent hash ring, "
              f"supervised")

        def client(indices):
            for i in indices:
                resp = router.submit(baskets[i % len(baskets)]).result(timeout=120)
                with lock:
                    responses.append((baskets[i % len(baskets)], resp))

        half = args.requests // 2
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=args.concurrency) as pool:
            for w in [pool.submit(client, range(o, half, args.concurrency))
                      for o in range(args.concurrency)]:
                w.result()
            # ---- 3. kill replica 0 mid-load: failover + restart ----
            router.fault_injection.kill_replica(0)
            print("[router] killed replica 0's dispatch worker mid-load")
            # ---- 4. coordinated two-phase swap with traffic live ----
            gen = router.hot_swap(rb1)
            print(f"[router] two-phase swap -> generation {gen}, traffic live")
            for w in [pool.submit(client, range(half + o, args.requests,
                                                args.concurrency))
                      for o in range(args.concurrency)]:
                w.result()
        wall = time.perf_counter() - t0

        # let the supervisor finish reviving the killed replica
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            if all(r["state"] == "healthy" for r in router.stats()["replicas"]):
                break
            time.sleep(0.02)
        stats = router.stats()

    # ---- 5. every answer is bit-identical to the offline path ----
    assert len(responses) == args.requests, "a request was dropped"
    gens = sorted({r.generation for _, r in responses})
    assert gens == [0, 1], f"expected both generations to answer, saw {gens}"
    for basket, resp in responses[:: max(1, len(responses) // 50)]:
        ref = recommend(rulebooks[resp.generation], np.asarray([basket]),
                        top_k=args.top_k, batch_size=resp.bucket, device=args.device)
        np.testing.assert_array_equal(np.asarray(resp.items), np.asarray(ref.items[0]))

    lat = np.array(sorted(r.latency_s for _, r in responses)) * 1e3
    print(f"[router] {len(responses)} responses in {wall:.2f}s "
          f"({len(responses) / wall:,.0f} qps) | generations={gens}")
    print(f"[router] latency p50={np.percentile(lat, 50):.2f}ms "
          f"p99={np.percentile(lat, 99):.2f}ms")
    print(f"[router] failovers={stats['failovers']} "
          f"replica_states={[r['state'] for r in stats['replicas']]} "
          f"replica_gens={[r['generation'] for r in stats['replicas']]} "
          f"restarts={sum(g['gateway']['worker_restarts'] for g in stats['replicas'])} "
          f"max_gen_lag={stats['max_generation_lag']}")
    print("[router] spot-checked responses are bit-identical to offline "
          "recommend() for their generation")
    tmp.cleanup()
    return mined[0]


if __name__ == "__main__":
    main()
