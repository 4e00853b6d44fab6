"""The program's own spans on the benchmark's cells, beside the benchmark's
outside timers.

    python3 tools/trace_readings.py <cell> --seeds 1 2 3 [--seconds 51]

It makes the cell's traced run (``torch.profiler`` on) with a
``MiningObs`` handed to every job's miner, rule compile and placement (the
in-memory route and the compile included, which the benchmark's jobs
driver leaves unobserved), and prints one JSON line a run: the line's
per-layer metrics, the same layers read from the program's phases and
spans, the share of each level's joined candidates the prune keeps, the
rows each level's prune checked by its path, the device's longest idle
gaps, and on a serving cell the checks of the
``gateway.batch`` spans against the profiler (K2's kernel seconds, the
share of each batch its ``cycle.*`` stages cover, the mean cycle against
the window over its batches).

It reaches the jobs by wrapping the benchmark driver's ``jobs._job`` and
``jobs.window``, and the program's ``apriori.mine``, ``compile_rulebook``
and ``place_rulebook``, in its own process; once ``bench/drivers/jobs.py``
hands its jobs an observer itself, the benchmark reads these layers and
this tool goes.

``--device cpu`` rehearses it at the tests' tiny size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:0] = [ROOT, os.path.join(ROOT, "src")]

from bench import harness  # noqa: E402
from bench.drivers import _serve, closed_loop, jobs  # noqa: E402

STASH: dict = {}
MINE_PHASES = ("candidate_gen", "candidate_join", "candidate_prune", "cand_place", "count_kernel", "host_sync",
               "prefetch_stall", "rules_extract", "rules_sort", "rules_pad", "rulebook_place")
COMPILE = ("rules_extract", "rules_sort", "rules_pad", "rulebook_place")
CYCLE = ("cycle.collect", "cycle.assemble", "cycle.h2d", "cycle.match", "cycle.topk", "cycle.d2h", "cycle.demux")
K2 = ("compact_rules_kernel", "rule_match_kernel")


def _patch(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    return module, name, orig


def _observe_jobs(tracer: bool) -> list:
    """Hand every job a ``MiningObs`` (kept in ``STASH["obs"]`` once the
    window starts): its miner, the in-memory one too, its compile and its
    placement."""
    from repro_torch.core import apriori
    from repro_torch.obs import MiningObs, Tracer
    from repro_torch.serving import rulebook

    def job(orig):
        def observed(state, ctx, db, obs=None):
            obs = obs if obs is not None else MiningObs(tracer=Tracer(sample_rate=1.0) if tracer else None)
            STASH["current"] = obs
            out = orig(state, ctx, db, obs)
            if STASH.get("window"):
                STASH["obs"].append(obs)
            return out
        return observed

    def observed(orig):
        return lambda *a, obs=None, **kw: orig(*a, obs=obs if obs is not None else STASH["current"], **kw)

    def window(orig):
        def stashed(state, ctx):
            STASH.update(window=True, obs=[], ctx=ctx)
            out = orig(state, ctx)
            STASH.update(window=False, result=out)
            return out
        return stashed

    # common.compile_and_place imports the rulebook's functions when called
    return [_patch(jobs, "_job", job), _patch(apriori, "mine", observed),
            _patch(rulebook, "compile_rulebook", observed), _patch(rulebook, "place_rulebook", observed),
            _patch(jobs, "window", window)]


def _observe_gateway() -> list:
    """Stash the serving window's result, context and sampled spans."""
    def spans(orig):
        def stashed(tracer, t0, t1):
            STASH["spans"] = [s for s in tracer.spans() if s.t1 is not None and t0 <= s.t1 <= t1]
            STASH["span_window"] = t1 - t0
            return orig(tracer, t0, t1)
        return stashed

    def window(orig):
        def stashed(state, ctx):
            STASH["ctx"] = ctx
            out = orig(state, ctx)
            STASH["result"] = out
            return out
        return stashed

    return [_patch(_serve, "window_spans", spans), _patch(closed_loop, "window", window)]


def _unpatch(patches) -> None:
    for module, name, orig in reversed(patches):
        setattr(module, name, orig)


def _run(cell, seed, seconds, trace, device):
    over = None
    if device == "cpu":
        from bench.tests import tiny

        over = harness._merge(tiny.OVERRIDES, tiny.T40) if cell.startswith("quest-t40") else tiny.OVERRIDES
    return harness.run_cell(cell, seed, seconds, trace, device=device, overrides=over, log=lambda m: None)


def _mine_readings(line) -> dict:
    result, ctx = STASH["result"], STASH["ctx"]
    walls = [j["wall_s"] for j in result["jobs"]]
    observed = STASH["obs"][-len(walls):]
    sec = {p: sum(o.registry.gauge("mine_phase_seconds", {"phase": p}).value for o in observed) for p in MINE_PHASES}
    wall = sum(walls)
    c = observed[0].counters()
    keep = {}
    for k in sorted(int(x.split('"')[1]) for x in c if x.startswith("mine_candidates_joined{")):
        joined = c[f'mine_candidates_joined{{level="{k}"}}']
        kept = c.get(f'mine_candidates{{level="{k}"}}', 0)
        keep[k] = [int(joined), int(kept), round(100.0 * kept / joined, 3) if joined else None]
    prune_rows = {x.split("{")[1][:-1]: int(v) for x, v in c.items() if x.startswith("mine_prune_rows{")}
    kernels = ctx.profiler.summary()["kernel_s"]
    return dict(jobs=len(walls), job_wall_s=wall / len(walls),
                phase_share={p: 100.0 * s / wall for p, s in sec.items()},
                phase_s_per_job={p: s / len(walls) for p, s in sec.items()},
                candgen_obs_share=100.0 * sec["candidate_gen"] / wall,
                prune_obs_share=100.0 * sec["candidate_prune"] / wall,
                cand_place_obs_share=100.0 * sec["cand_place"] / wall,
                compile_obs_s=sum(sec[p] for p in COMPILE) / len(walls),
                count_kernel_s=sec["count_kernel"], count_kernels_profiler_s=sum(kernels.values()),
                k3_profiler_s=kernels.get("support_count_kernel", 0.0),
                joined_kept_keep_pct=keep, prune_rows=prune_rows)


def _serve_readings(line) -> dict:
    result, ctx = STASH["result"], STASH["ctx"]
    spans = STASH["spans"]
    batches = [s for s in spans if s.name == "gateway.batch"]
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent_id, []).append(s)
    cover = []
    for b in batches:
        stages = [s for s in kids.get(b.span_id, []) if s.name in CYCLE]
        if len(stages) == len(CYCLE):
            cover.append(sum(s.t1 - s.t0 for s in stages) / (b.t1 - b.t0))
    mean = lambda name: (1e3 * sum(s.t1 - s.t0 for s in spans if s.name == name)  # noqa: E731
                         / max(1, sum(1 for s in spans if s.name == name)))
    ordered = sorted(batches, key=lambda s: s.t0)
    gaps = sorted(1e3 * (b.t0 - a.t1) for a, b in zip(ordered, ordered[1:]))
    traced = result["traced_batches"]
    kernels = ctx.profiler.summary()["kernel_s"]
    k2 = sum(kernels.get(n, 0.0) for n in K2)
    gpu_match = mean("gpu.match")
    return dict(traced_batches=traced, batch_spans=len(batches), window_s=STASH["span_window"],
                stage_ms={n: mean(n) for n in CYCLE + ("gpu.match", "gpu.topk", "gateway.batch", "device.dispatch")},
                k2_profiler_s=k2, gpu_match_x_batches_s=gpu_match * traced / 1e3,
                gpu_match_vs_k2=gpu_match * traced / 1e3 / k2 if k2 else None,
                batch_cover_mean=sum(cover) / len(cover) if cover else None,
                cycle_ms=mean("gateway.batch"), window_ms_per_batch=1e3 * STASH["span_window"] / traced,
                batch_spans_s=sum(b.t1 - b.t0 for b in batches), between_batches_s=sum(gaps) / 1e3,
                between_batches_ms_median=gaps[len(gaps) // 2] if gaps else None, between_batches_ms_top=gaps[-5:])


def traced(cell, seeds, seconds, device):
    serve = cell.startswith("quest-t40") or cell.endswith(".serve")
    patches = _observe_gateway() if serve else _observe_jobs(tracer=True)
    try:
        for seed in seeds:
            STASH.clear()
            t = time.perf_counter()
            line = _run(cell, seed, seconds, True, device)
            out = dict(cell=cell, seed=seed, trace=1, correct=line["correct"], run_s=time.perf_counter() - t,
                       metrics={k: v["value"] for k, v in line["metrics"].items()},
                       idle_gaps=line["breakdown"]["idle_gaps"], device_ops=line["breakdown"]["device_ops"],
                       busy_s=line["device"]["busy_s"], window_s=line["device"]["window_s"])
            out["program"] = _serve_readings(line) if serve else _mine_readings(line)
            print("READING " + json.dumps(out, default=float), flush=True)
    finally:
        _unpatch(patches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("trace_readings: needs a CUDA card (or --device cpu)", file=sys.stderr)
            return 2
    traced(args.cell, args.seeds, args.seconds, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
