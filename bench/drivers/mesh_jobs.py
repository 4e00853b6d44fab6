"""Mining jobs on a mesh of cards, each rank holding only its own split.

The paper's deployment: a transaction log held by the nodes of a cluster in
blocks, each node counting its own blocks and one reduce a pass summing
their counts.  The data set is the configuration's ``num_transactions``
rows in blocks of ``block_rows``; block ``b`` is ``bench/data/quest.py``'s
stream ``b`` of the data set's pattern pool, so block 0 is the data set of
the same generator settings at ``block_rows`` rows.  The traffic's mesh is
spawned one rank a card (``repro_torch.launch.mesh.spawn``); the ranks of
data shard ``d`` of ``D`` generate only blocks ``d·B/D`` to
``(d+1)·B/D - 1``, the only rows their processes ever hold, and prepare
``orders`` row orders of them from the seed, which jobs take in turn.

A job is every rank's ``apriori.mine(..., mesh=, split=True)`` of its split,
in lockstep, then ``compile_rulebook`` and ``place_rulebook`` on rank 0
(the rulebook of a one-card gateway there), synchronised.  Before each job
rank 0 tells the others whether the window goes on.  ``rulebook_s`` is, on
rank 0's clock, the window's start to the end of its last job over the jobs
(the job that runs past ``seconds`` counts), as on the ``jobs`` driver.

Set-up spawns the ranks from a thread of this process; they build the mesh,
generate their blocks, run a warm job and wait for the window's signal (a
file), so ``setup_s`` covers all of that.  Meanwhile worker processes
generate every block again for the check (``quest.generate`` alone, no
program), held in this process until then.  Each rank keeps
``bench/ranks.py``'s record: its probe starts at its window's start and
stops at its end, and the window returns the records as ``devices``.  A
traced run hands every rank's jobs a ``MiningObs``; a job's ``phases`` are
the mean over the ranks of each rank's phase seconds.

The check works the itemsets and rules out again with
``bench/reference/blocks.py`` from those blocks, once, since every job
mines the same rows, and compares every rank's itemsets and rank 0's
rulebook of every job with them.
"""

from __future__ import annotations

import concurrent.futures
import inspect
import json
import multiprocessing as mp
import os
import threading
import time
import types

import numpy as np

from bench import checks, common, ranks
from bench.data import blocks as data_blocks
from bench.data import quest
from bench.drivers.jobs import ref_candidates
from bench.reference import blocks as ref_blocks
from bench.reference import rules as ref_rules

POLL_S = 0.01


# ------------------------------------------------------------------- data --
def block(data: dict, b: int) -> np.ndarray:
    """Block ``b`` of the data set: ``block_rows`` dense {0,1} int8 rows."""
    return quest.generate(quest.Quest.from_config(data), data["data_seed"], int(data["block_rows"]), b)


def layout(config: dict, traffic: dict) -> tuple[int, int]:
    """``(blocks, data shards)``; raises where the configuration's blocks,
    its deployment and the traffic's mesh do not fit each other."""
    data, nodes = config["data"], int(config["deployment"]["nodes"])
    rows, per = int(data["num_transactions"]), int(data["block_rows"])
    shards = int(np.prod([traffic["mesh"][traffic["axes"].index(a)] for a in traffic["data_axes"]]))
    if rows % per or (rows // per) % shards or shards != nodes or int(np.prod(traffic["mesh"])) != nodes:
        raise ValueError(f"{rows} rows in blocks of {per} over a {traffic['mesh']} mesh do not make "
                         f"{nodes} nodes of whole blocks")
    return rows // per, shards


def _held(levels: dict) -> dict:
    return {tuple(int(x) for x in row): int(s) for sets, sup in levels.values() for row, s in zip(sets, sup)}


# ------------------------------------------------------------------ ranks --
def _job(mesh, db, cfg, config, obs):
    import torch

    from repro_torch.core import apriori

    res = apriori.mine(db, cfg, device=mesh.device, mesh=mesh, split=True, obs=obs)
    placed, compile_s = None, 0.0
    if mesh.rank == 0:
        t = time.perf_counter()
        placed = common.compile_and_place(res, config, mesh.device)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        compile_s = time.perf_counter() - t
    return res, placed, compile_s


def _phases(obs) -> dict:
    c = obs.counters()
    return {k.split('"')[1]: v for k, v in c.items() if k.startswith("mine_phase_seconds{")}


def rank_main(mesh, config, traffic, seed, seconds, trace, signal):
    """One rank: its blocks, the warm job, the window's jobs; returns its
    ``bench/ranks.py`` record and, per job, its times, phases and results
    (rank 0's with its rulebook)."""
    import torch

    from repro_torch.core.apriori import AprioriConfig
    from repro_torch.obs.mining import MiningObs

    data, m = config["data"], config["mining"]
    n_blocks, shards = layout(config, traffic)
    d = mesh.shard(tuple(traffic["data_axes"]))[0]
    per = n_blocks // shards
    split = np.concatenate([block(data, b) for b in range(d * per, (d + 1) * per)])
    rng = np.random.default_rng([seed % (1 << 63), 1, d])
    orders = [split[rng.permutation(split.shape[0])] for _ in range(int(traffic["orders"]))]
    del split
    cfg = AprioriConfig(min_support=m["min_support"], max_k=m["max_k"], representation=traffic["representation"],
                        operand_dtype=traffic["operand_dtype"], data_axes=tuple(traffic["data_axes"]),
                        model_axis=traffic["model_axis"])
    t = time.perf_counter()
    obs = MiningObs()
    _job(mesh, orders[0], cfg, config, obs)
    warm_s = time.perf_counter() - t
    split_rows = obs.counters()["mine_split_rows"]
    ready = os.path.join(signal, f"ready.{mesh.rank}")
    with open(ready + ".tmp", "w") as f:
        json.dump(dict(warm_s=warm_s, split_rows=split_rows), f)
    os.replace(ready + ".tmp", ready)
    while not os.path.exists(os.path.join(signal, "go")):
        time.sleep(POLL_S)

    probe = ranks.start(trace, mesh.device)
    mesh.barrier()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    jobs = []
    go = torch.zeros(1, dtype=torch.int64)
    while True:
        if mesh.rank == 0:
            go[0] = int(time.perf_counter() < deadline)
        if not int(mesh.broadcast(go, 0)):
            break
        obs = MiningObs() if trace else None
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.job"):
            res, placed, compile_s = _job(mesh, orders[len(jobs) % len(orders)], cfg, config, obs)
        t1 = time.perf_counter()
        jobs.append(dict(t0=t0, t1=t1, wall_s=t1 - t0, compile_s=compile_s, result=res, rulebook=placed,
                         phases=_phases(obs) if obs is not None else None))
    t_end = jobs[-1]["t1"] if jobs else time.perf_counter()
    probe.stop()

    for j in jobs:   # after the window: the results as the check reads them
        j["levels"] = j.pop("result").levels
        placed = j.pop("rulebook")
        j["book"] = placed.to_host() if placed is not None else None
    return dict(record=probe.report(), jobs=jobs, t_start=t_start, t_end=t_end, warm_s=warm_s,
                split_rows=split_rows)


def _spawn(state, args, device):
    from repro_torch.launch.mesh import spawn

    tr = args[1]
    try:
        state["ranks"] = spawn(rank_main, tuple(tr["mesh"]), tuple(tr["axes"]), device=device,
                               backend=tr["backend"], timeout_s=float(tr["timeout_s"]), args=args)
    except BaseException as e:  # noqa: BLE001 — set-up or the window raises it
        state["error"] = e


# ----------------------------------------------------------------- driver --
def setup(ctx):
    from repro_torch.core import apriori

    if "split" not in inspect.signature(apriori.mine).parameters:
        raise RuntimeError("the program's apriori.mine takes no split: it cannot mine a DB held in splits")
    tr = ctx.traffic
    if tr["route"] != "memory":
        raise ValueError(f"mesh_jobs: the splits are mined in memory; route must be memory, got {tr['route']!r}")
    layout(ctx.config, tr)
    signal = os.path.join(ctx.tmp, "signal")
    os.makedirs(signal)
    state = dict(signal=signal, world=int(np.prod(tr["mesh"])))
    args = (ctx.config, tr, ctx.seed, ctx.seconds, ctx.trace, signal)
    state["thread"] = threading.Thread(target=_spawn, args=(state, args, ctx.device), daemon=True)
    state["thread"].start()
    t = time.perf_counter()
    state["blocks"], state["generate_workers"] = dataset_blocks(ctx.config)
    state["generate_s"] = time.perf_counter() - t
    ready = [os.path.join(signal, f"ready.{r}") for r in range(state["world"])]
    deadline = time.monotonic() + float(tr["setup_timeout_s"])
    while not all(os.path.exists(p) for p in ready):
        if not state["thread"].is_alive():
            raise RuntimeError("the mesh's ranks ended in set-up") from state.get("error")
        if time.monotonic() > deadline:
            raise TimeoutError(f"the mesh's ranks were not ready within {tr['setup_timeout_s']} s")
        time.sleep(POLL_S)
    state["ready"] = []
    for p in ready:
        with open(p) as f:
            state["ready"].append(json.load(f))
    ctx.log(f"[setup] {state['world']} ranks ready; warm job {max(r['warm_s'] for r in state['ready']):.3f} s")
    return state


def window(state, ctx):
    with open(os.path.join(state["signal"], "go"), "w"):
        pass
    state["thread"].join()
    if "error" in state:
        raise state["error"]
    out = state["ranks"]
    lead = out[0]
    jobs = lead["jobs"]
    if ctx.trace:
        for i, job in enumerate(jobs):
            names = set().union(*(r["jobs"][i]["phases"] for r in out))
            job["phases"] = {p: sum(r["jobs"][i]["phases"].get(p, 0.0) for r in out) / len(out) for p in names}
    done = len(jobs)
    metrics = {"rulebook_s": ((lead["t_end"] - lead["t_start"]) / done, "s")} if done else {}
    walls = [j["wall_s"] for j in jobs]
    first = jobs[0]["levels"] if done else {}
    detail = dict(jobs=done, failed=0, window_s=lead["t_end"] - lead["t_start"],
                  warm_job_s=[r["warm_s"] for r in out], split_rows=[r["split_rows"] for r in out],
                  job_wall_min=min(walls, default=0.0), job_wall_max=max(walls, default=0.0),
                  compile_s_mean=sum(j["compile_s"] for j in jobs) / max(1, done),
                  levels={int(k): int(v[0].shape[0]) for k, v in sorted(first.items())},
                  rules=jobs[0]["book"].num_rules if done else 0)
    return dict(metrics=metrics, attempted=done, failed=0, jobs=jobs, devices=[r["record"] for r in out],
                ranks=out, detail=detail)


def dataset_blocks(config: dict) -> tuple[list, int]:
    """``(blocks, workers)``: every block of the data set, generated in
    worker processes (``bench/data/blocks.py``, bit-packed on the way back:
    dense blocks through the pool's pipes took 185 s for 10M rows on a
    card's host)."""
    data = config["data"]
    n_blocks = int(data["num_transactions"]) // int(data["block_rows"])
    workers = max(1, min(n_blocks, len(os.sched_getaffinity(0)), 16))
    q = quest.Quest.from_config(data)
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as pool:
        futures = [pool.submit(data_blocks.packed, q, data["data_seed"], int(data["block_rows"]), b)
                   for b in range(n_blocks)]
        return [data_blocks.unpacked(f.result(), q.num_items) for f in futures], workers


def control_numbers(config: dict, device: str, blocks: list | None = None) -> dict:
    """The check's numbers with the control (supports summed into bfloat16)
    in the program's place."""
    m, num_items = config["mining"], config["data"]["num_items"]
    blocks = dataset_blocks(config)[0] if blocks is None else blocks
    ref = ref_blocks.frequent_itemsets(blocks, m["min_support"], m["max_k"], device=device)
    low = ref_blocks.frequent_itemsets(blocks, m["min_support"], m["max_k"], device=device, low_precision=True)
    book = ref_rules.rules(ref, m["min_confidence"], num_items)
    low_book = ref_rules.rules(low, m["min_confidence"], num_items)
    order = np.argsort(-low_book["score"], kind="stable")   # as a placed rulebook holds its rows
    host = types.SimpleNamespace(ante_packed=low_book["ante"][order], cons_packed=low_book["cons"][order],
                                 ante_len=low_book["ante_len"][order], scores=low_book["score"][order])
    return dict(itemsets_differing=checks.itemsets_differing(low, ref),
                rules_differing=checks.rules_differing(host, book))


def check(state, result, ctx):
    """Every rank's itemsets of every job, and rank 0's placed rulebook of
    every job, against the reference's, worked out from the blocks."""
    import torch

    config, m = ctx.config, ctx.config["mining"]
    t = time.perf_counter()
    ref = ref_blocks.frequent_itemsets(state.pop("blocks"), m["min_support"], m["max_k"], device=ctx.device)
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    num_items = config["data"]["num_items"]
    book = ref_rules.rules(ref, m["min_confidence"], num_items)
    result["reference"] = dict(candidates=ref_candidates(ref, num_items, m["max_k"]), rules=len(book["score"]))
    differing = max((checks.itemsets_differing(_held(j["levels"]), ref) for r in result["ranks"] for j in r["jobs"]),
                    default=0)
    rules_bad = max((checks.rules_differing(j["book"], book) for j in result["jobs"]), default=0)
    result["detail"].update(reference_s=time.perf_counter() - t, reference_generate_s=state["generate_s"],
                            reference_generate_workers=state["generate_workers"],
                            candidates=result["reference"]["candidates"])
    return [("itemsets_differing", differing, ctx.limits["itemsets_differing"]),
            ("rules_differing", rules_bad, ctx.limits["rules_differing"]),
            ("jobs_failed", result["failed"], 0)]
