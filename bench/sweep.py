"""Find the knee of an open-loop serving cell: the highest offered rate at
and below which every step's 99th percentile is at most the serve CLI's SLO
(50 ms), with no request rejected and no backlog growing through the step,
in every repeat of the ladder.

    python3 bench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 2000,4000,... --repeats 2

One process, one set-up: the cell's gateway and rulebook, then the ladder of
rates ``--repeats`` times, each step over fresh baskets of its own on a
collected heap, as a run's window starts.  Give ``--seconds`` the cell's
window, so that a step sees as many of the interpreter's pauses as a run
does.  Not run by the benchmark; its result is written into the cell's
``params`` by hand.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))

import argparse  # noqa: E402
import json  # noqa: E402
import gc  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

from bench import common, harness  # noqa: E402
from bench.drivers import _serve, open_loop  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    rates = [float(r) for r in args.rates.split(",")]
    piece = harness.load_cell(args.workload)
    tmp = tempfile.mkdtemp(prefix="bench-sweep-")
    try:
        ctx = harness.Context(cell=args.workload, config=piece["config"],
                              traffic=harness._merge(piece["traffic"], piece["cell"].get("params")),
                              seed=args.seed, seconds=args.seconds, trace=False, device="cuda", tmp=tmp)
        state = _serve.setup(ctx, 1)
        print(f"set-up {time.perf_counter() - T0:.3f} s, {state['rules']} rules", flush=True)
        rows = []
        for rep in range(args.repeats):
            for r in rates:
                rng = np.random.default_rng([args.seed, 99, rep, int(r)])
                due = np.cumsum(rng.exponential(1.0 / r, int(r * args.seconds * 1.2 + 200)))
                due = due[due < args.seconds]
                baskets = common.pack(common.fresh_baskets(ctx.config, [args.seed, 98, rep, int(r)], due.size))
                gc.collect()
                st = open_loop.run_schedule(state["gateway"], due, baskets, args.seconds, 10.0)["stats"]
                ok = st["p99_ms"] <= args.slo_ms and st["rejected"] == 0 and st["backlog"][-1] <= 2 * 64
                rows.append(dict(repeat=rep, rate_per_s=r, meets=ok, **st))
                print("sweep " + json.dumps(rows[-1], default=float), flush=True)
        knee = None
        for r in rates:
            if not all(x["meets"] for x in rows if x["rate_per_s"] == r):
                break
            knee = r
        print(json.dumps(dict(knee_per_s=knee, rate_at_0_8=None if knee is None else 0.8 * knee)), flush=True)
        state["gateway"].close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
