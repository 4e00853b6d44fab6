"""Online serving driver: load store → mine → compile → serve loop (§10).

  # end to end on synthetic data (store ingested under a temp dir):
  PYTHONPATH=src python -m repro_torch.launch.serve --transactions 4000 --items 128 \
      --requests 2000 --concurrency 16
  # persistent store (reused when the manifest exists; --ingest re-ingests):
  PYTHONPATH=src python -m repro_torch.launch.serve --store /data/quest --ingest ...
  # exercise a live rulebook hot-swap halfway through the client load:
  PYTHONPATH=src python -m repro_torch.launch.serve ... --hot-swap-mid-load \
      --swap-min-support 0.04
  # supervised dispatch worker + injected mid-load crash (DESIGN.md §11):
  PYTHONPATH=src python -m repro_torch.launch.serve ... --supervise \
      --crash-worker-mid-load
  # replicated tier (DESIGN.md §12): N replicas behind the failure-aware
  # router, with an injected replica kill AND a coordinated hot-swap live:
  PYTHONPATH=src python -m repro_torch.launch.serve ... --replicas 3 \
      --kill-replica-mid-load --hot-swap-mid-load --deadline-ms 5000
  # continuous refresh (DESIGN.md §15): the initial mine persists a count
  # cache; 5% new rows are APPENDED to the live store mid-load and the
  # RefreshController delta-mines + hot-swaps them in under traffic:
  PYTHONPATH=src python -m repro_torch.launch.serve ... --refresh delta \
      --append-mid-load 0.05
  # machine-readable summary (the same keys as the JAX CLI's):
  PYTHONPATH=src python -m repro_torch.launch.serve ... --json serve-smoke.json
  # SLOs + burn-rate alerting + closed-loop reactions (DESIGN.md §14); the
  # alert stream lands next to the metrics series and perfetto trace, and
  # `python -m repro_torch.launch.status` renders both offline:
  PYTHONPATH=src python -m repro_torch.launch.serve ... --replicas 2 \
      --kill-replica-mid-load --slo --slo-p99-ms 50 \
      --alerts-jsonl serve-alerts.jsonl --metrics-jsonl serve-series.jsonl

``--device cpu`` runs every step on the CPU through the kernels' plain
versions; the default is the card, and without CUDA the CLI raises.

The full paper-to-production pipeline in one command: the synthetic DB is
ingested CHUNKED into an on-disk ``TransactionStore``, mined with the
streaming Map/Reduce driver (``mine_streamed``), compiled into a servable
rulebook, and served through the micro-batched online ``Gateway`` while a
closed-loop client population (``--concurrency`` threads, baskets drawn from
the store's own transactions) fires independent single-basket queries.
``--hot-swap-mid-load`` re-mines the SAME store at ``--swap-min-support``
while traffic is running and hot-swaps the fresh rulebook in: the summary
then shows both generations answering, with zero dropped requests.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--transactions", type=int, default=4_000)
    ap.add_argument("--items", type=int, default=128)
    ap.add_argument("--avg-len", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--store", default="", metavar="DIR",
                    help="on-disk transaction store (default: temp dir, ingested fresh)")
    ap.add_argument("--ingest", action="store_true",
                    help="force (re-)ingest of the synthetic DB into --store")
    ap.add_argument("--shard-rows", type=int, default=2048)
    ap.add_argument("--stream-chunk-rows", type=int, default=2048)
    ap.add_argument("--min-support", type=float, default=0.02)
    ap.add_argument("--max-k", type=int, default=4)
    ap.add_argument("--min-confidence", type=float, default=0.4)
    ap.add_argument("--rule-score", default="confidence", choices=["confidence", "lift"])
    ap.add_argument("--max-rules", type=int, default=None)
    ap.add_argument("--impl", default="auto", choices=["auto", "kernel", "ref"],
                    help="count and match steps: by device, the CUDA kernels only, "
                         "or the plain versions")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the store is mined and the rulebook served")
    # gateway policy
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=1.0)
    ap.add_argument("--queue-depth", type=int, default=1024)
    ap.add_argument("--cache", type=int, default=4096, help="basket cache capacity")
    # client load
    ap.add_argument("--requests", type=int, default=2_000)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--hot-swap-mid-load", action="store_true",
                    help="re-mine the store and hot-swap the rulebook at half "
                         "load; goes through the incremental delta path when "
                         "the refresh mode resolves to delta (DESIGN.md §15)")
    ap.add_argument("--swap-min-support", type=float, default=None,
                    help="min-support of the full re-mine (default: 2x "
                         "--min-support; ignored on the delta path, which "
                         "keeps the serving config and folds in new rows)")
    ap.add_argument("--refresh", default="auto", choices=["auto", "delta", "full"],
                    help="rulebook refresh path: 'delta' mines appended rows "
                         "against the persisted count cache and drives the "
                         "swap through the RefreshController; 'full' keeps "
                         "the legacy whole-store re-mine; 'auto' picks delta "
                         "when the store already has a count cache (or "
                         "--append-mid-load asked for one)")
    ap.add_argument("--append-mid-load", type=float, default=0.0, metavar="FRAC",
                    help="append FRAC of the store's rows mid-load and wait "
                         "for the refresh controller to mine + hot-swap them "
                         "(the continuous-refresh smoke; implies a mid-load "
                         "swap)")
    ap.add_argument("--supervise", action="store_true",
                    help="run a WorkerSupervisor over the gateway's dispatch "
                         "worker (restarts it if it dies, DESIGN.md §11)")
    ap.add_argument("--crash-worker-mid-load", action="store_true",
                    help="fault injection: kill the dispatch worker once at "
                         "half load (requires --supervise to recover)")
    # replicated tier (DESIGN.md §12)
    ap.add_argument("--replicas", type=int, default=1,
                    help=">1 serves through the failure-aware Router over N "
                         "gateway replicas (consistent basket hashing, "
                         "failover, coordinated hot-swap)")
    ap.add_argument("--kill-replica-mid-load", action="store_true",
                    help="fault injection: kill one replica's dispatch worker "
                         "at half load (implies --replicas >= 2)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; expiry is a typed "
                         "DeadlineExceeded, counted in the summary")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write the serving summary as JSON")
    # observability (DESIGN.md §13)
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write sampled request spans as Chrome trace-event "
                         "JSON (load in ui.perfetto.dev)")
    ap.add_argument("--trace-sample", type=float, default=0.01,
                    help="root-request sampling rate for --trace-out "
                         "(1.0 = every request; swaps are always traced)")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="write the final unified metrics-registry snapshot "
                         "(gateway + per-replica + router) as JSON")
    ap.add_argument("--metrics-jsonl", default="", metavar="PATH",
                    help="append periodic registry snapshots as JSONL while "
                         "the load runs (obs.Sampler time series)")
    # active observability: SLOs + burn-rate alerting (DESIGN.md §14)
    ap.add_argument("--slo", action="store_true",
                    help="run the SLO evaluator over the serving registry "
                         "(latency/availability/replica-health/generation-lag "
                         "objectives, burn-rate alerts); with --replicas > 1 "
                         "the router subscribes to alerts (brownout shedding, "
                         "alert-triggered re-sync)")
    ap.add_argument("--slo-p99-ms", type=float, default=50.0,
                    help="latency SLO objective: p99 of request latency")
    ap.add_argument("--alerts-jsonl", default="", metavar="PATH",
                    help="append every alert state transition as JSONL "
                         "(implies --slo)")
    args = ap.parse_args(argv)
    if args.alerts_jsonl and not args.slo:
        args.slo = True
    if args.crash_worker_mid_load and not args.supervise:
        print("[serve] --crash-worker-mid-load implies --supervise (else the load hangs)")
        args.supervise = True
    if args.kill_replica_mid_load and args.replicas < 2:
        print("[serve] --kill-replica-mid-load implies --replicas 2 "
              "(a lone killed replica has nowhere to fail over)")
        args.replicas = 2

    import numpy as np

    from repro_torch.core import incremental as inc
    from repro_torch.device import resolve_device
    from repro_torch.core.apriori import AprioriConfig
    from repro_torch.core.streaming import mine_streamed
    from repro_torch.data.store import append_chunks, ingest_quest, open_store
    from repro_torch.data.synthetic import QuestConfig, gen_transactions_chunked
    from repro_torch.distributed import FaultConfig
    from repro_torch.serving import (
        AdmissionRejected,
        Gateway,
        RefreshController,
        Router,
        compile_rulebook,
    )

    device = resolve_device(args.device)

    # ---- 1. load (or ingest) the on-disk store ----
    qcfg = QuestConfig(num_transactions=args.transactions, num_items=args.items,
                       avg_len=args.avg_len, seed=args.seed)
    tmp = None
    store_dir = args.store
    if not store_dir:
        tmp = tempfile.TemporaryDirectory(prefix="serve_store_")
        store_dir = tmp.name
    if args.ingest or not os.path.exists(os.path.join(store_dir, "manifest.json")):
        print(f"[serve] ingesting {args.transactions} x {args.items} (chunked) "
              f"-> {store_dir} ...")
        store = ingest_quest(qcfg, store_dir, shard_rows=args.shard_rows,
                             chunk_rows=args.stream_chunk_rows)
    else:
        store = open_store(store_dir)
    print(f"[serve] store: n={store.num_transactions} items={store.num_items} "
          f"shards={store.num_partitions} device={device}")

    # ---- 2. mine (streamed) + 3. compile ----
    def mine_rulebook(min_support: float):
        cfg = AprioriConfig(min_support=min_support, max_k=args.max_k,
                            count_impl=args.impl, representation="packed")
        t0 = time.perf_counter()
        res = mine_streamed(store, cfg, device=device, chunk_rows=args.stream_chunk_rows)
        rb = compile_rulebook(res, min_confidence=args.min_confidence,
                              score=args.rule_score, max_rules=args.max_rules,
                              num_items=store.num_items)
        print(f"[serve] mined {res.total_frequent} itemsets -> {rb.num_rules} rules "
              f"(min_support={min_support}) in {time.perf_counter() - t0:.2f}s")
        return rb

    # refresh-path resolution (DESIGN.md §15): delta rides the persisted
    # count cache; auto picks it up when the store has one (a cache mined at
    # a different config is fine — mine_delta falls back + rebuilds it)
    refresh_mode = args.refresh
    if refresh_mode == "auto":
        refresh_mode = ("delta" if (store.count_cache_meta is not None
                                    or args.append_mid_load > 0) else "full")
    refresh_swap = (args.append_mid_load > 0
                    or (args.hot_swap_mid_load and refresh_mode == "delta"))
    legacy_swap = args.hot_swap_mid_load and not refresh_swap
    if refresh_swap and args.append_mid_load <= 0:
        args.append_mid_load = 0.05

    base_cfg = AprioriConfig(min_support=args.min_support, max_k=args.max_k,
                             count_impl=args.impl, representation="packed")
    if refresh_mode == "delta":
        # the universal entry: noop when the cache already covers the store,
        # delta when rows were appended, full build on a cold/invalid cache —
        # every path leaves a cache the mid-load refresh can fold into
        t0 = time.perf_counter()
        res0, rep0 = inc.mine_delta(store, base_cfg, device,
                                    chunk_rows=args.stream_chunk_rows)
        rb = compile_rulebook(res0, min_confidence=args.min_confidence,
                              score=args.rule_score, max_rules=args.max_rules,
                              num_items=store.num_items)
        print(f"[serve] initial mine via count cache: mode={rep0.mode} "
              f"({rep0.reason or 'up-to-date'}) {res0.total_frequent} itemsets "
              f"-> {rb.num_rules} rules in {time.perf_counter() - t0:.2f}s")
    else:
        rb = mine_rulebook(args.min_support)

    # baskets for the client load: the store's own transactions (packed rows)
    chunk, real = next(store.iter_chunks(min(4096, store.num_transactions)))
    baskets = list(chunk[:real])

    # ---- 4. serve loop under a closed-loop client population ----
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.distributed.supervisor import WorkerSupervisor
    from repro_torch.serving.batcher import DeadlineExceeded, WorkerCrashed

    use_router = args.replicas > 1
    tracer = None
    if args.trace_out:
        from repro_torch.obs import Tracer

        tracer = Tracer(sample_rate=args.trace_sample)
    gateway_kw = dict(device=device, impl=args.impl, top_k=args.top_k, max_batch=args.max_batch,
                      max_wait_ms=args.max_wait_ms, queue_depth=args.queue_depth,
                      cache_capacity=args.cache, warmup="ladder")
    if use_router:
        srv = Router(rb, args.replicas,
                     fault=FaultConfig(max_retries=3, backoff_s=0.01),
                     attempt_timeout_s=1.0, tracer=tracer, **gateway_kw)
        print(f"[serve] replicated tier: {args.replicas} replicas behind the "
              f"router (consistent basket hashing, supervised)")
    else:
        srv = Gateway(rb, tracer=tracer, **gateway_kw)

    supervisor = None
    sampler = None
    with srv as gw:
        if args.metrics_jsonl:
            from repro_torch.obs import Sampler

            # the primary registry: router counters when replicated, else the
            # lone gateway's — one JSONL line per interval while load runs
            sampler = Sampler(gw.metrics.registry, args.metrics_jsonl,
                              interval_s=0.25)
            sampler.start()
        evaluator = None
        if args.slo:
            from repro_torch.obs import BurnRule, SLOEvaluator, serving_slos

            # CLI-lifetime burn windows: the SRE-workbook 60s/300s ladder is
            # scaled down so a seconds-long smoke run can both FIRE and CLEAR
            rules = (BurnRule("page", long_window_s=2.0, short_window_s=0.5,
                              burn_threshold=10.0),
                     BurnRule("warn", long_window_s=6.0, short_window_s=1.5,
                              burn_threshold=3.0))
            specs = serving_slos("router" if use_router else "gateway",
                                 p99_ms=args.slo_p99_ms,
                                 replicated=use_router, rules=rules)
            evaluator = SLOEvaluator(gw.metrics.registry, specs,
                                     interval_s=0.05, clear_after_s=0.5,
                                     jsonl_path=args.alerts_jsonl or None)
            if use_router:
                # the closed loop (§14): availability alerts tighten
                # admission, generation-lag alerts trigger replica re-sync
                evaluator.subscribe(gw.handle_alert)
            evaluator.start()
            print(f"[slo] evaluating {len(specs)} SLOs "
                  f"({', '.join(s.name for s in specs)}) "
                  f"p99 objective {args.slo_p99_ms:g} ms")
        if args.supervise and not use_router:   # the router supervises itself
            supervisor = WorkerSupervisor(gw)
        # a minimal closed-loop client: launch/ is importable as
        # repro_torch.launch.* and depends on no repo-root package
        rejected = {"n": 0}
        crashed = {"n": 0}
        expired = {"n": 0}
        latencies, generations = [], set()
        lock = threading.Lock()

        def client(indices):
            for i in indices:
                try:
                    resp = gw.submit(baskets[i % len(baskets)],
                                     deadline_ms=args.deadline_ms).result(timeout=120)
                except AdmissionRejected:
                    with lock:
                        rejected["n"] += 1
                    continue
                except WorkerCrashed:
                    # the request was in flight inside the dead worker: failed
                    # explicitly, safe to retry — matching is read-only
                    with lock:
                        crashed["n"] += 1
                    continue
                except DeadlineExceeded:
                    with lock:
                        expired["n"] += 1
                    continue
                with lock:
                    latencies.append(resp.latency_s)
                    generations.add(resp.generation)

        def fire(n_requests, offset, pool):
            shards = [range(offset + w, offset + n_requests, args.concurrency)
                      for w in range(args.concurrency)]
            for w in [pool.submit(client, s) for s in shards]:
                w.result()

        half = args.requests // 2
        print(f"[serve] firing {args.requests} requests from {args.concurrency} "
              f"closed-loop clients ...")
        if args.crash_worker_mid_load:
            # one-shot injected worker death: arms at half load below
            def _arm_crash():
                once = {"armed": True}

                def hook(batch):
                    if once["armed"]:
                        once["armed"] = False
                        gw._batcher._crash_hook = None
                        # SystemExit in a thread dies without a stderr traceback
                        raise SystemExit("injected dispatch-worker death")
                gw._batcher._crash_hook = hook
        mid_load = (args.crash_worker_mid_load or args.kill_replica_mid_load
                    or args.hot_swap_mid_load or refresh_swap)
        ctl = None
        refresh_summary = None
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=args.concurrency) as pool:
            if mid_load:
                miner = None
                if legacy_swap:
                    # full path: re-mine WHILE the first half of the load is
                    # live, swap, then drive the rest on the new generation
                    swap_ms = (2 * args.min_support if args.swap_min_support is None
                               else args.swap_min_support)
                    rb2_box = {}
                    miner = threading.Thread(
                        target=lambda: rb2_box.update(rb=mine_rulebook(swap_ms)))
                    miner.start()
                elif refresh_swap:
                    ctl = RefreshController(
                        store_dir, gw, base_cfg,
                        device=device, chunk_rows=args.stream_chunk_rows,
                        min_confidence=args.min_confidence,
                        score=args.rule_score, max_rules=args.max_rules,
                        mode=refresh_mode, poll_interval_s=0.05,
                    ).start()
                fire(half, 0, pool)
                if args.crash_worker_mid_load:
                    _arm_crash()
                    print("[serve] armed a dispatch-worker crash; continuing load ...")
                if args.kill_replica_mid_load:
                    gw.fault_injection.kill_replica(0)
                    print("[serve] armed a replica-0 worker kill; continuing load ...")
                if miner is not None:
                    miner.join()
                    gen = gw.hot_swap(rb2_box["rb"])
                    kind = "coordinated two-phase" if use_router else "hot"
                    print(f"[serve] {kind}-swapped to generation {gen} with traffic live")
                if ctl is not None:
                    # append new rows into the LIVE store, then let the
                    # controller notice the watermark, delta-mine, and swap —
                    # the second half of the load runs on the new generation
                    age_gauge = getattr(gw.metrics, "generation_age", None)
                    age_before = age_gauge.value if age_gauge is not None else None
                    append_n = max(1, int(args.append_mid_load
                                          * store.num_transactions))
                    aq = QuestConfig(num_transactions=append_n,
                                     num_items=args.items,
                                     avg_len=args.avg_len, seed=args.seed + 1)
                    append_chunks(
                        gen_transactions_chunked(aq, args.stream_chunk_rows),
                        store_dir)
                    print(f"[serve] appended {append_n} rows mid-load; waiting "
                          f"for the {refresh_mode} refresh ...")
                    deadline = time.perf_counter() + 300.0
                    while not ctl.history and time.perf_counter() < deadline:
                        time.sleep(0.02)
                    if not ctl.history:
                        raise RuntimeError(
                            f"mid-load refresh did not complete: {ctl.last_error!r}")
                    age_after = age_gauge.value if age_gauge is not None else None
                    last = ctl.history[-1]
                    kind = "coordinated two-phase" if use_router else "hot"
                    print(f"[serve] refresh {kind}-swapped to generation "
                          f"{last['generation']} ({last['mode']}, "
                          f"{last['delta_rows']} rows, {last['seconds']:.2f}s) "
                          f"with traffic live")
                    refresh_summary = {
                        "mode": last["mode"],
                        "reason": last["reason"],
                        "latency_s": last["seconds"],
                        "delta_rows": last["delta_rows"],
                        "novel_candidates": last["novel_candidates"],
                        "appended_rows": append_n,
                        "generation": last["generation"],
                        "rules": last["rules"],
                        "age_before_s": age_before,
                        "age_after_s": age_after,
                    }
                fire(args.requests - half, half, pool)
            else:
                fire(args.requests, 0, pool)
        wall = time.perf_counter() - t0
        if ctl is not None:
            ctl.stop()

        if supervisor is not None:
            supervisor.close()
        if use_router:
            # let the health monitor finish reviving killed replicas so the
            # summary reports the RECOVERED replica set
            settle_until = time.perf_counter() + 5.0
            while time.perf_counter() < settle_until:
                states = [r["state"] for r in gw.stats()["replicas"]]
                if all(s == "healthy" for s in states):
                    break
                time.sleep(0.02)
        slo_status, alert_events = None, []
        if evaluator is not None:
            # alerts clear only once the bad samples age out of the long
            # burn window + hysteresis — give them time to resolve so the
            # summary (and the CI chaos gate) sees fire AND clear
            clear_until = time.perf_counter() + 10.0
            while time.perf_counter() < clear_until:
                if all(s == "ok" for s in evaluator.states().values()):
                    break
                time.sleep(0.05)
            evaluator.stop()
            slo_status = evaluator.status()
            alert_events = [e.to_json() for e in evaluator.alert_history()]
            fired = sum(1 for e in alert_events if e["severity"] != "ok")
            print(f"[slo] {len(alert_events)} alert transitions "
                  f"({fired} fired, {len(alert_events) - fired} cleared); "
                  f"final states: {evaluator.states()}")
        stats = gw.stats()
        if sampler is not None:
            sampler.stop()
            print(f"[obs] sampled {sampler.samples_written} registry snapshots "
                  f"-> {args.metrics_jsonl}", file=sys.stderr)
        if args.metrics_out:
            if use_router:
                registries = {
                    "router": gw.metrics.registry.snapshot(),
                    "replicas": [rep.gateway.metrics.registry.snapshot()
                                 for rep in gw.replicas],
                }
            else:
                registries = {"gateway": gw.metrics.registry.snapshot()}
            with open(args.metrics_out, "w") as f:
                json.dump(registries, f, indent=2)
            print(f"[obs] wrote metrics registry -> {args.metrics_out}",
                  file=sys.stderr)
        if tracer is not None:
            tracer.save_chrome(args.trace_out)
            print(f"[obs] wrote {len(tracer.spans())} spans "
                  f"({tracer.sampled_roots} sampled roots) -> {args.trace_out} "
                  "(load in ui.perfetto.dev)", file=sys.stderr)

    lat = np.asarray(sorted(latencies))
    pct = lambda q: float(np.percentile(lat, q)) * 1e3 if lat.size else 0.0
    # gated percentiles come from the REGISTRY histogram (conservative
    # bucket-upper-edge quantiles — the same numbers stats()/Prometheus/the
    # SLO evaluator see); the raw client-side np.percentile view is kept as
    # client_p*_ms so the two sources can be compared, never confused
    hist = stats["latency"]
    if use_router:
        # aggregate the per-replica gateway views into the single-gateway
        # summary shape (CI reads the same fields either way)
        gws = [r["gateway"] for r in stats["replicas"]]
        rows_real = sum(g["batch_rows_real"] for g in gws)
        rows_padded = sum(g["batch_rows_padded"] for g in gws)
        hits = sum(g["cache_hits"] for g in gws)
        misses = sum(g["cache_misses"] for g in gws)
        agg = {
            "batch_occupancy": rows_real / rows_padded if rows_padded else 0.0,
            "cache_hit_rate": hits / (hits + misses) if hits + misses else 0.0,
            "swaps": stats["coordinated_swaps"],
            "worker_restarts": sum(g["worker_restarts"] for g in gws),
        }
    else:
        agg = {k: stats[k] for k in
               ("batch_occupancy", "cache_hit_rate", "swaps", "worker_restarts")}
    summary = {
        "requests": args.requests,
        "responses": int(lat.size),
        "rejected": rejected["n"],
        "generations": sorted(int(g) for g in generations),
        "qps": lat.size / wall if wall > 0 else 0.0,
        "p50_ms": hist["p50_ms"], "p95_ms": hist["p95_ms"],
        "p99_ms": hist["p99_ms"],
        "client_p50_ms": pct(50), "client_p95_ms": pct(95),
        "client_p99_ms": pct(99),
        **agg,
        "crashed_requests": crashed["n"],
        "deadline_expired_requests": expired["n"],
        "wall_s": wall,
    }
    if use_router:
        terminal = lat.size + rejected["n"] + crashed["n"] + expired["n"]
        summary.update({
            "replicas": args.replicas,
            "replica_states": [r["state"] for r in stats["replicas"]],
            "replica_generations": [r["generation"] for r in stats["replicas"]],
            "failovers": stats["failovers"],
            "shed": stats["shed"],
            "resyncs": stats["resyncs"],
            "max_generation_lag": stats["max_generation_lag"],
            "kills_fired": srv.fault_injection.kills_fired,
            "availability": lat.size / terminal if terminal else 0.0,
            "brownout_level": stats["brownout_level"],
        })
    if refresh_summary is not None:
        summary["refresh"] = refresh_summary
    if slo_status is not None:
        summary["slo"] = slo_status
        summary["alerts"] = alert_events
        summary["alerts_fired"] = sum(
            1 for e in alert_events if e["severity"] != "ok")
        summary["alerts_cleared"] = sum(
            1 for e in alert_events if e["severity"] == "ok")
        from repro_torch.launch.status import render_status

        print(render_status(
            metrics=None, slo_status=slo_status, alerts=alert_events,
            replicas=stats.get("replicas"), title="final SLO status"))
    print(f"[serve] {summary['responses']} responses (+{summary['rejected']} rejected, "
          f"{summary['crashed_requests']} crashed, "
          f"{summary['deadline_expired_requests']} expired) "
          f"in {wall:.2f}s = {summary['qps']:,.0f} qps | "
          f"p50={summary['p50_ms']:.2f}ms p95={summary['p95_ms']:.2f}ms "
          f"p99={summary['p99_ms']:.2f}ms | occupancy={summary['batch_occupancy']:.2f} "
          f"hit_rate={summary['cache_hit_rate']:.2f} | generations={summary['generations']} "
          f"worker_restarts={summary['worker_restarts']}")
    if use_router:
        print(f"[serve] router: states={summary['replica_states']} "
              f"gens={summary['replica_generations']} "
              f"failovers={summary['failovers']} shed={summary['shed']} "
              f"resyncs={summary['resyncs']} kills={summary['kills_fired']} "
              f"availability={summary['availability']:.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"[serve] wrote {args.json}", file=sys.stderr)
    if tmp is not None:
        tmp.cleanup()


if __name__ == "__main__":
    main()
