"""Jobs run back to back: a transaction DB becomes a servable rulebook.

A job hands the program the configuration's data set under a row order of
its own, drawn from the seed (the same supports, other bytes), and runs the
traffic's route to a rulebook placed on the device, synchronised:

* ``memory``: ``apriori.mine`` over the dense rows, then ``compile_rulebook``
  and ``place_rulebook``;
* ``stream``: ``streaming.mine_streamed`` over an on-disk store of
  ``shard_rows`` shards at ``chunk_rows`` chunks, then the same.  Set-up
  writes ``stores`` stores of the rows in as many orders; jobs take them in
  turn.

Set-up makes the row orders of as many jobs as the window is expected to
hold, so the window spends its time on jobs alone.  ``rulebook_s`` is the
time from the window's start to the end of its last job over the jobs: the
window closes when a job ends past ``seconds``.

A traced run wraps ``candidates.generate_candidates`` and
``apriori._place_candidates`` with the benchmark's clock and annotations,
and hands ``mine_streamed`` a ``MiningObs``.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np

from bench import checks, common
from bench.reference import mine as ref_mine
from bench.reference import rules as ref_rules


class _Clock:
    """Seconds spent in a wrapped function, and a profiler annotation."""

    def __init__(self, module, attr: str, label: str):
        self.module, self.attr, self.label = module, attr, label
        self.orig = getattr(module, attr)
        self.seconds = 0.0

    def __enter__(self):
        import torch

        orig = self.orig

        def timed(*args, **kwargs):
            t = time.perf_counter()
            with torch.profiler.record_function(self.label):
                out = orig(*args, **kwargs)
            self.seconds += time.perf_counter() - t
            return out

        setattr(self.module, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def setup(ctx):
    tr = ctx.traffic
    dense = common.dataset(ctx.config)
    n = dense.shape[0]
    cfg = common.apriori_config(ctx.config, tr)
    rng = np.random.default_rng(ctx.rng_seed(1))
    state = dict(dense=dense, cfg=cfg, rng=rng, jobs=[])
    if tr["route"] == "stream":
        state["stores"] = []
        for s in range(int(tr["stores"])):
            path = os.path.join(ctx.tmp, f"store{s}")
            state["stores"].append(common.write_store(dense[rng.permutation(n)], path, int(tr["shard_rows"])))
    elif tr["route"] != "memory":
        raise ValueError(f"jobs: route must be memory or stream, got {tr['route']!r}")
    t = time.perf_counter()
    _job(state, ctx, _input(state, ctx, 0))          # the warm job: builds the kernels, fills the caches
    warm_s = time.perf_counter() - t
    expect = min(int(tr.get("max_prepared", 64)), max(4, math.ceil(1.5 * ctx.seconds / max(warm_s, 1e-3)) + 2))
    if tr["route"] == "memory":
        state["inputs"] = [dense[rng.permutation(n)] for _ in range(expect)]
    state["warm_s"] = warm_s
    ctx.log(f"[setup] warm job {warm_s:.3f} s" + (f"; {expect} job inputs prepared" if "inputs" in state else ""))
    return state


def _input(state, ctx, i: int):
    if ctx.traffic["route"] == "stream":
        stores = state["stores"]
        return stores[i % len(stores)]
    inputs = state.get("inputs")
    if inputs is None:
        return state["dense"][state["rng"].permutation(state["dense"].shape[0])]
    return inputs[i % len(inputs)]


def _job(state, ctx, db, obs=None):
    from repro_torch.core import apriori, streaming

    tr = ctx.traffic
    if tr["route"] == "memory":
        res = apriori.mine(db, state["cfg"], device=ctx.device)
    else:
        res = streaming.mine_streamed(db, state["cfg"], device=ctx.device, chunk_rows=int(tr["chunk_rows"]),
                                      obs=obs)
    t_compile = time.perf_counter()
    placed = common.compile_and_place(res, ctx.config, ctx.device)
    common.sync(ctx.device)
    return res, placed, time.perf_counter() - t_compile


def window(state, ctx):
    import torch

    from repro_torch.core import apriori, candidates
    from repro_torch.kernels import ops

    jobs = []
    clocks = []
    if ctx.trace:
        clocks = [_Clock(candidates, "generate_candidates", "bench.candidate_gen"),
                  _Clock(apriori, "_place_candidates", "bench.place_candidates")]
        for c in clocks:
            c.__enter__()
        ctx.profiler.start()
    launches0 = ops.launch_counts()
    failed = 0
    try:
        t_start = time.perf_counter()
        deadline = t_start + ctx.seconds
        i = 1
        while time.perf_counter() < deadline:
            db = _input(state, ctx, i)
            i += 1
            obs = None
            if ctx.trace and ctx.traffic["route"] == "stream":
                from repro_torch.obs.mining import MiningObs

                obs = MiningObs()
            before = {c.label: c.seconds for c in clocks}
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function("bench.job"):
                    res, placed, compile_s = _job(state, ctx, db, obs)
            except Exception as e:  # noqa: BLE001 — a job that raises never answers: counted, and not correct
                failed += 1
                ctx.log(f"[window] job {i - 1} raised {type(e).__name__}: {e}")
                continue
            t1 = time.perf_counter()
            job = dict(t0=t0, t1=t1, wall_s=t1 - t0, compile_s=compile_s, result=res, rulebook=placed,
                       clocks={c.label: c.seconds - before[c.label] for c in clocks})
            if obs is not None:
                job["phases"] = _phases(obs)
            jobs.append(job)
        t_end = jobs[-1]["t1"] if jobs else time.perf_counter()
    finally:
        if ctx.profiler is not None:
            ctx.profiler.stop()
        for c in clocks:
            c.__exit__()
    launches = {k: v - launches0[k] for k, v in ops.launch_counts().items()}
    done = len(jobs)
    metrics = {}
    if done:
        metrics["rulebook_s"] = ((t_end - t_start) / done, "s")
    walls = [j["wall_s"] for j in jobs]
    detail = dict(jobs=done, failed=failed, window_s=t_end - t_start, warm_job_s=state["warm_s"],
                  job_wall_min=min(walls, default=0.0), job_wall_max=max(walls, default=0.0),
                  launches=launches, levels=_levels(jobs[0]["result"]) if jobs else {},
                  rules=jobs[0]["rulebook"].num_rules if jobs else 0)
    return dict(metrics=metrics, attempted=done + failed, failed=failed, jobs=jobs, launches=launches,
                detail=detail)


PHASES = ("candidate_gen", "prefetch_stall", "count_kernel", "host_sync")


def _phases(obs) -> dict:
    """The streamed miner's phase seconds (its ``MiningObs`` gauges)."""
    return {p: obs.registry.gauge("mine_phase_seconds", {"phase": p}).value for p in PHASES}


def _levels(res) -> dict:
    return {int(k): int(v[0].shape[0]) for k, v in sorted(res.levels.items())}


def check(state, result, ctx):
    """Every job's itemsets and supports, and its placed rulebook, against
    the reference's, worked out from the data set itself."""
    jobs = result["jobs"]
    ports = []
    for j in jobs:
        ports.append((j["result"].as_dict(), j["rulebook"].to_host()))
        j["result"] = j["rulebook"] = None
    state.pop("inputs", None)
    if ctx.device == "cuda":
        import torch

        torch.cuda.empty_cache()
    t = time.perf_counter()
    m = ctx.config["mining"]
    ref = ref_mine.frequent_itemsets(state["dense"], m["min_support"], m["max_k"], device=ctx.device)
    book = ref_rules.rules(ref, m["min_confidence"], ctx.config["data"]["num_items"])
    result["reference"] = dict(candidates=ref_candidates(ref, state["dense"].shape[1], m["max_k"]),
                               rules=len(book["score"]))
    differing = max((checks.itemsets_differing(p, ref) for p, _ in ports), default=0)
    rules_bad = max((checks.rules_differing(rb, book) for _, rb in ports), default=0)
    result["detail"].update(reference_s=time.perf_counter() - t, candidates=result["reference"]["candidates"])
    return [("itemsets_differing", differing, ctx.limits["itemsets_differing"]),
            ("rules_differing", rules_bad, ctx.limits["rules_differing"]),
            ("jobs_failed", result["failed"], 0)]


def ref_candidates(ref: dict, num_items: int, max_k: int) -> dict:
    """Each level's candidate count as the reference generates them (the
    work the kernels' bounds count)."""
    out = {1: num_items}
    frequent = sorted(s for s in ref if len(s) == 1)
    for k in range(2, max_k + 1):
        if not frequent:
            break
        out[k] = len(ref_mine.candidates(frequent, k, list(range(num_items))))
        frequent = sorted(s for s in ref if len(s) == k)
    return out
