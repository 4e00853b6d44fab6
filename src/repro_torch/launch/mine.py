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
  # incremental: seed the count cache once, then each later run folds ONLY
  # the rows appended since it (dict-identical to a full re-mine):
  PYTHONPATH=src python -m repro_torch.launch.mine ... --store DIR --count-cache
  PYTHONPATH=src python -m repro_torch.launch.mine ... --store DIR --delta
  # live per-level progress, job counters (with the count step's static
  # roofline, ``static_cost``, for a streamed mine) and a perfetto-loadable
  # trace on torch.profiler's clock, of a streamed or an in-memory mine:
  PYTHONPATH=src python -m repro_torch.launch.mine ... --store DIR \
      --progress --trace-out mine-trace.json --metrics-out mine-metrics.json
  # on a 2 x 2 data x model mesh of 4 local ranks (gloo), as the JAX CLI's
  # --host-devices 4 --mesh 2x2; or one rank a process under torchrun:
  PYTHONPATH=src python -m repro_torch.launch.mine ... --host-devices 4 --mesh 2x2 --device cpu
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.mine ... --mesh 2x2

Level-wise, SON and the paper's all-subsets map, over dense or packed
transactions, in memory or (``--store``) streamed from an on-disk store
that either package may have written.  The last line is the same JSON object the
JAX package's mine CLI prints (``seconds``, ``total_frequent``,
``levels``), so the two can be diffed.  On a mesh every rank mines, rank 0
alone prints and writes files, and the last line is the same.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def static_count_cost(cfg, mesh, rows: int, num_items: int, k_cands: int, *, chip=None) -> dict:
    """Static roofline of ONE streamed count dispatch at the mined shapes.

    Walks the plain dense count step (a shape-faithful proxy for whatever
    representation and kernel actually ran, as the JAX CLI lowers its jnp
    step) on meta tensors (``launch.op_analysis``): (rows x num_items)
    transactions against the LARGEST candidate bucket the mine dispatched.
    On a mesh it walks this rank's blocks, (rows / data shards) x (k_cands /
    model shards), through the mesh engine, whose collective it counts.
    The roofline is ``chip``'s (``launch.roofline``; the SXM part by
    default), the operations at the rate of ``cfg.operand_dtype``.  Paired
    with the measured ``count_kernel`` phase seconds this turns padding and
    dispatch overhead into a reported ratio, not a kernel's efficiency: on a
    card those seconds are the device span of each chunk's launches by CUDA
    events, the device's waits for the host between them included (a
    streamed mine is launch-bound); on the CPU, host time.
    """
    import torch

    from repro_torch.core.apriori import make_count_step
    from repro_torch.launch import op_analysis, roofline

    # the plain route by name: the walk never runs the card's kernels
    proxy = dataclasses.replace(cfg, count_impl="ref", representation="dense")
    step = make_count_step(proxy, mesh)
    data = mesh.shard(tuple(cfg.data_axes))[1] if mesh is not None else 1
    model = mesh.shape[cfg.model_axis] if mesh is not None and cfg.model_axis else 1
    kb = k_cands // model
    costs = op_analysis.analyze(
        step, op_analysis.meta((-(-rows // data), num_items), torch.int8),
        op_analysis.meta((kb, num_items), torch.int8), op_analysis.meta((kb,), torch.int32))
    ranks = {r for g in costs.collective_groups for r in g}
    rl = roofline.roofline_terms(costs.flops, costs.hbm_bytes, costs.collective_bytes, chip=chip,
                                 dtype=cfg.operand_dtype,
                                 link_bytes_per_s=roofline.link_bytes_per_s(ranks, chip))
    # the miner's useful-FLOPs model: K containment tests per row, each a
    # words-per-row AND+popcount pass over packed uint32 bitsets
    useful_flops = 2.0 * rows * num_items * k_cands / 256
    return {
        "rows_per_dispatch": rows,
        "candidate_rows": k_cands,
        "flops_per_dispatch": costs.flops,
        "hbm_bytes_per_dispatch": costs.hbm_bytes,
        "roofline_s_per_dispatch": rl.bound_s,
        "roofline_dominant": rl.dominant,
        "useful_flops_per_dispatch": useful_flops,
        "useful_flops_ratio": useful_flops / max(costs.flops, 1.0),
    }


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
    ap.add_argument("--device", default="cuda",
                    help="cuda (a mesh puts local rank r on card r %% cards), cuda:N, or cpu")
    ap.add_argument("--mesh", default="", metavar="DxM",
                    help="mine on a data x model mesh of D*M ranks: spawned here with "
                         "--host-devices D*M, else one rank a process under torchrun")
    ap.add_argument("--host-devices", type=int, default=0, metavar="N",
                    help="with --mesh: spawn the N = D*M ranks on this host")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="the mesh's collective backend (nccl: one card a rank)")
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
    ap.add_argument("--count-cache", action="store_true",
                    help="SON streamed mine that also persists the pre-prune phase-2 "
                         "union counts into the store manifest as the incremental "
                         "count cache (the seed for --delta); needs --store")
    ap.add_argument("--delta", action="store_true",
                    help="incremental mine: fold rows appended since the count cache "
                         "generation into it and re-verify only novel candidates "
                         "(core.incremental.mine_delta; full-scan fallback on a "
                         "cold/invalid cache or an oversized delta, the report says "
                         "which); needs --store")
    ap.add_argument("--progress", action="store_true",
                    help="live per-level progress lines (with rows/s throughput and "
                         "ETA when streamed; stderr)")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write a Chrome trace-event JSON of the mining phase spans, "
                         "on torch.profiler's clock (load in ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="write the Hadoop-style job counters as JSON")
    args = ap.parse_args(argv)

    if (args.checkpoint_every or args.resume) and not args.store:
        ap.error("--checkpoint-every/--resume need the streamed miner: add --store DIR")
    if (args.count_cache or args.delta) and not args.store:
        ap.error("--count-cache/--delta need the on-disk store: add --store DIR")
    if args.max_partition_retries is not None and not (
        args.store and (args.algo == "son" or args.count_cache or args.delta)
    ):
        ap.error("--max-partition-retries needs --store DIR and --algo son "
                 "(or --count-cache/--delta, which run SON phase 1 inside)")
    if (args.progress or args.trace_out or args.metrics_out) and not args.store and args.algo == "son":
        ap.error("--progress/--trace-out/--metrics-out instrument the level-wise "
                 "mine or the streamed drivers: add --store DIR, or drop --algo son")
    shape = None
    if args.mesh:
        try:
            shape = tuple(int(x) for x in args.mesh.split("x"))
        except ValueError:
            shape = ()
        if len(shape) != 2 or min(shape) < 1:
            ap.error(f"--mesh takes DxM, got {args.mesh!r}")
        if args.host_devices and args.host_devices != shape[0] * shape[1]:
            ap.error(f"--host-devices {args.host_devices} cannot hold a {args.mesh} mesh")

    if shape is None:
        return run(args, None)
    from repro_torch.launch import mesh as mesh_mod

    if args.host_devices:
        mesh_mod.spawn(_rank, shape, MESH_AXES, device=args.device, backend=args.backend,
                       timeout_s=RANK_TIMEOUT_S, args=(args,))
        return None
    mesh = mesh_mod.make_mesh(shape, MESH_AXES, device=args.device, backend=args.backend,
                              timeout_s=RANK_TIMEOUT_S)
    try:
        return _rank(mesh, args)
    finally:
        mesh_mod.close_mesh()


MESH_AXES = ("data", "model")
RANK_TIMEOUT_S = 3600.0


def _rank(mesh, args):
    """One rank of a mesh mine: only rank 0 prints and writes files."""
    if mesh.rank != 0:
        with open(os.devnull, "w") as quiet:
            sys.stdout = sys.stderr = quiet
            try:
                return run(args, mesh)
            finally:
                sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__
    return run(args, mesh)


def run(args, mesh):
    """The mine the parsed ``args`` ask for, on ``mesh`` (or one device)."""
    from repro_torch.core.apriori import AprioriConfig, mine
    from repro_torch.core.rules import extract_rules
    from repro_torch.core.son import mine_son
    from repro_torch.data.synthetic import QuestConfig, gen_transactions
    from repro_torch.device import resolve_device

    device = resolve_device(args.device) if mesh is None else mesh.device
    writer = mesh is None or mesh.rank == 0
    qcfg = QuestConfig(num_transactions=args.transactions, num_items=args.items,
                       avg_len=args.avg_len, seed=args.seed)
    db = store = None
    if args.store:
        from repro_torch.data.store import MANIFEST_NAME, ingest_quest, open_store

        if writer and (args.ingest or not os.path.exists(os.path.join(args.store, MANIFEST_NAME))):
            print(f"[mine] ingesting {args.transactions} x {args.items} (chunked) -> {args.store} ...")
            store = ingest_quest(qcfg, args.store, shard_rows=args.shard_rows,
                                 chunk_rows=args.stream_chunk_rows)
        if mesh is not None:
            mesh.barrier()   # rank 0's ingest is on disk
        if store is None:
            store = open_store(args.store)
        print(f"[mine] store: n={store.num_transactions} items={store.num_items} "
              f"shards={store.num_partitions}")
    else:
        print(f"[mine] generating {args.transactions} transactions x {args.items} items ...")
        db = gen_transactions(qcfg)
    cfg = AprioriConfig(min_support=args.min_support, max_k=args.max_k, count_impl=args.impl,
                        representation=args.representation, use_naive_paper_map=(args.algo == "naive_paper"),
                        model_axis="model" if mesh is not None else None)

    obs = tracer = None
    if args.progress or args.trace_out or args.metrics_out:
        from repro_torch.obs import MetricsRegistry, MiningObs, MiningProgress, Tracer

        tracer = Tracer(sample_rate=1.0) if args.trace_out else None
        total = store.num_transactions if store is not None else args.transactions
        progress = MiningProgress(total_rows=total) if args.progress else None
        obs = MiningObs(registry=MetricsRegistry(), tracer=tracer, progress=progress)

    t0 = time.time()
    if store is not None:
        from repro_torch.core import incremental as inc
        from repro_torch.core.streaming import mine_son_streamed, mine_streamed

        fault = None
        if args.max_partition_retries is not None:
            from repro_torch.distributed.fault_tolerance import FaultConfig

            fault = FaultConfig(max_retries=args.max_partition_retries)
        if args.delta:
            res, rep = inc.mine_delta(store, cfg, device, chunk_rows=args.stream_chunk_rows,
                                      fault=fault, checkpoint=True, resume=args.resume, obs=obs,
                                      mesh=mesh)
            print(f"[mine] delta report: {json.dumps(dataclasses.asdict(rep))}")
        elif args.count_cache:
            res, cache = inc.build_count_cache(store, cfg, device, chunk_rows=args.stream_chunk_rows,
                                               fault=fault, obs=obs, mesh=mesh)
            print(f"[mine] count cache seq={cache.seq} covering n={cache.n} "
                  f"({cache.candidate_total()} cached candidates over levels "
                  f"{sorted(cache.levels)}) -> {store.path}")
        elif args.algo == "son":
            res = mine_son_streamed(store, cfg, device=device, mesh=mesh,
                                    chunk_rows=args.stream_chunk_rows, fault=fault, obs=obs)
            if res.fault_report is not None:
                print(f"[mine] SON fault report: {json.dumps(res.fault_report.to_json())}")
        else:
            use_ckpt = bool(args.checkpoint_every) or args.resume
            if args.resume:
                print(f"[mine] resuming from {store.checkpoint_path} (if a committed checkpoint exists)")
            res = mine_streamed(store, cfg, device=device, mesh=mesh, chunk_rows=args.stream_chunk_rows,
                                checkpoint=True if use_ckpt else None,
                                checkpoint_every_chunks=args.checkpoint_every, resume=args.resume,
                                obs=obs)
    elif args.algo == "son":
        res = mine_son(db, cfg, device=device, mesh=mesh, num_partitions=args.partitions)
    else:
        res = mine(db, cfg, device=device, mesh=mesh, obs=obs)
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
    if args.rulebook and writer:
        from repro_torch.serving.rulebook import compile_rulebook

        rb = compile_rulebook(
            res, min_confidence=args.min_confidence, score=args.rule_score,
            max_rules=args.max_rules, num_items=store.num_items if store else args.items, obs=obs,
        )
        rb.save(args.rulebook)
        print(f"[rulebook] {rb.num_rules} rules ({rb.num_rows} padded rows, "
              f"score={rb.score_kind}) -> {args.rulebook}")

    if obs is not None:
        obs.finish()
        if args.trace_out and writer:
            tracer.save_chrome(args.trace_out)
            print(f"[obs] wrote {len(tracer.spans())} spans -> {args.trace_out} "
                  "(load in ui.perfetto.dev)", file=sys.stderr)
        if args.metrics_out and writer:
            counters = obs.counters()
            out = {"seconds": dt, "counters": counters}
            k_cands = int(counters.get("mine_max_candidate_bucket", 0))
            measured = counters.get('mine_phase_seconds{phase="count_kernel"}', 0.0)
            dispatches = int(counters.get("mine_chunks_streamed", 0))
            if k_cands > 0:
                from repro_torch.launch.roofline import detect_chip

                chip = detect_chip(device) if device.type == "cuda" else None
                rows = min(args.stream_chunk_rows, store.num_transactions)
                try:
                    static = static_count_cost(cfg, mesh, rows, store.num_items, k_cands, chip=chip)
                except Exception as e:  # noqa: BLE001 — the estimate is advisory, as in the JAX CLI
                    static = {"error": f"{type(e).__name__}: {e}"}
                else:
                    static["count_dispatches"] = dispatches
                    # each chunk's launches' span on the device (CUDA events),
                    # host launch gaps included; host time on the CPU
                    static["measured_count_kernel_s"] = measured
                    ideal = static["roofline_s_per_dispatch"] * max(dispatches, 1)
                    # padding and dispatch overhead against the roofline, not
                    # kernel efficiency: the interesting signal is its TREND as
                    # padding and bucketing knobs move, not its absolute value
                    static["measured_vs_roofline"] = measured / max(ideal, 1e-12)
                out["static_cost"] = static
            with open(args.metrics_out, "w") as f:
                json.dump(out, f, indent=2)
            print(f"[obs] wrote job counters -> {args.metrics_out}", file=sys.stderr)

    print(json.dumps({"seconds": dt, "total_frequent": res.total_frequent,
                      "levels": {k: int(v[0].shape[0]) for k, v in res.levels.items()}}))


if __name__ == "__main__":
    main()
