"""SLO walkthrough on the card: burn-rate alerting + the closed loop, step
by step (PyTorch port of ``examples/serve_slo.py``).

  PYTHONPATH=src python examples/torch/serve_slo.py [--device cuda|cpu] \
      [--transactions 4000] [--items 128] [--requests 1200] [--replicas 3]

The DESIGN.md §14 observability loop on top of the §12 replicated tier:

  1. declare    — ``serving_slos()`` builds the serving SLO set (p99
                  latency, availability ratio, replica health, disruption
                  ratio, generation lag) as declarative specs; each spec
                  carries multi-window multi-burn-rate rules (fast-burn
                  pages, slow-burn warns, SRE-workbook style);
  2. evaluate   — an ``SLOEvaluator`` thread diffs ``MetricsRegistry``
                  snapshots over each rule's windows and runs every spec
                  through an ok -> warn -> page state machine with
                  hysteresis, emitting typed ``AlertEvent``s (deduplicated:
                  transitions only) to subscribers and a JSONL stream;
  3. close loop — the Router subscribes: an availability alert engages
                  brownout admission (shed when aggregate queues exceed
                  the alert level's budget), a generation-lag alert forces
                  an immediate replica re-sync.  Separately the Gateway's
                  ``p99_target_ms`` arms an AIMD controller that adapts the
                  micro-batcher's max-wait toward the latency objective —
                  batch timing changes, responses stay bit-identical;
  4. disrupt    — mid-load, fault injection kills a replica worker: the
                  failover burst burns the disruption budget, the page
                  fires, supervised restart + failover keep availability
                  at 100%, and the alert clears once the burn window
                  drains — watch the ok -> page -> ok arc in the stream;
  5. render     — ``render_status`` prints the final panel: per-SLO state,
                  burn rates, alert history, replica health.

The same flow as a single command (plus a JSON summary for scripting):

  PYTHONPATH=src python -m repro_torch.launch.serve --replicas 3 --slo \
      --kill-replica-mid-load --alerts-jsonl alerts.jsonl --requests 2000
"""

import argparse
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor


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
    ap.add_argument("--p99-ms", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.core.apriori import AprioriConfig
    from repro_torch.core.streaming import mine_streamed
    from repro_torch.data.store import ingest_quest
    from repro_torch.data.synthetic import QuestConfig
    from repro_torch.distributed import FaultConfig
    from repro_torch.obs import BurnRule, SLOEvaluator, serving_slos
    from repro_torch.launch.status import render_status
    from repro_torch.serving import Router, compile_rulebook

    # ---- 1. ingest + mine (identical to the replicated example) ----
    qcfg = QuestConfig(num_transactions=args.transactions, num_items=args.items,
                       avg_len=args.avg_len, seed=args.seed)
    tmp = tempfile.TemporaryDirectory(prefix="slo_store_")
    store = ingest_quest(qcfg, tmp.name, shard_rows=2048, chunk_rows=2048)
    res = mine_streamed(
        store,
        AprioriConfig(min_support=args.min_support, max_k=args.max_k,
                      representation="packed"),
        device=args.device,
        chunk_rows=2048,
    )
    rb = compile_rulebook(res, min_confidence=args.min_confidence,
                          num_items=store.num_items)
    print(f"[slo] {res.total_frequent} itemsets -> {rb.num_rules} rules")

    chunk, real = next(store.iter_chunks(min(2048, store.num_transactions)))
    baskets = list(chunk[:real])
    responses, lock = [], threading.Lock()

    with Router(rb, args.replicas, device=args.device, top_k=args.top_k, max_batch=64,
                max_wait_ms=1.0, cache_capacity=2048,
                fault=FaultConfig(max_retries=3, backoff_s=0.01),
                attempt_timeout_s=1.0) as router:
        # ---- 2. declare SLOs, start the evaluator, 3. close the loop ----
        # demo-scaled windows (seconds, not the production hours) so the
        # whole ok -> page -> ok arc fits in one short run
        rules = (BurnRule("page", long_window_s=2.0, short_window_s=0.5,
                          burn_threshold=10.0),
                 BurnRule("warn", long_window_s=6.0, short_window_s=1.5,
                          burn_threshold=3.0))
        specs = serving_slos("router", p99_ms=args.p99_ms, replicated=True,
                             rules=rules)
        evaluator = SLOEvaluator(router.metrics.registry, specs,
                                 interval_s=0.05, clear_after_s=0.5)
        evaluator.subscribe(router.handle_alert)          # the closed loop
        evaluator.subscribe(
            lambda ev: print(f"[alert] {ev.severity:>4} <- {ev.previous:<4} "
                             f"{ev.slo}: {ev.message}"))
        evaluator.start()
        print(f"[slo] evaluating {len(specs)} SLOs: "
              f"{', '.join(s.name for s in specs)}")

        def client(indices):
            for i in indices:
                resp = router.submit(baskets[i % len(baskets)]).result(timeout=120)
                with lock:
                    responses.append(resp)

        # ---- 4. load with a mid-load replica kill ----
        half = args.requests // 2
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=args.concurrency) as pool:
            for w in [pool.submit(client, range(o, half, args.concurrency))
                      for o in range(args.concurrency)]:
                w.result()
            router.fault_injection.kill_replica(0)
            print("[slo] killed replica 0's dispatch worker mid-load")
            for w in [pool.submit(client, range(half + o, args.requests,
                                                args.concurrency))
                      for o in range(args.concurrency)]:
                w.result()
        wall = time.perf_counter() - t0

        # idle until the burn windows drain and every SLO returns to ok
        deadline = time.perf_counter() + 15.0
        while time.perf_counter() < deadline:
            if all(st["state"] == "ok" for st in evaluator.status().values()):
                break
            time.sleep(0.05)
        evaluator.stop()

        # ---- 5. the final panel ----
        stats = router.stats()
        print(render_status(
            slo_status=evaluator.status(),
            alerts=[ev.to_json() for ev in evaluator.alert_history()],
            replicas=stats["replicas"], title="final SLO status"))

    fired = [ev for ev in evaluator.alert_history() if not ev.cleared]
    cleared = [ev for ev in evaluator.alert_history() if ev.cleared]
    assert len(responses) == args.requests, "a request was dropped"
    assert any(ev.signal == "availability" for ev in fired), \
        "the replica kill should have fired an availability alert"
    assert any(ev.signal == "availability" for ev in cleared), \
        "the availability alert should have cleared after recovery"
    print(f"[slo] {len(responses)} responses in {wall:.2f}s "
          f"({len(responses) / wall:,.0f} qps) | "
          f"{len(fired)} alerts fired, {len(cleared)} cleared, "
          f"final states all ok | availability="
          f"{stats['completed'] / max(1, stats['completed'] + stats['failed']):.4f}")
    tmp.cleanup()
    return res


if __name__ == "__main__":
    main()
