"""The control of each cell's check: the reference put in the program's
place, computed one precision below what the configuration states, has to
come out not correct.

    python3 bench/control.py --workload <cell> --seeds 1,2,3

* mining cells: supports summed into bfloat16 instead of exact integers
  (``reference.mine.count(low_precision=True)``), compared as a run's jobs
  are: itemsets and supports, and the rules compiled from them;
* serving cells: rule scores rounded to bfloat16 and summed in bfloat16
  (``reference.rules.item_scores(low_precision=True)``) for the baskets a
  run of that seed would compare, compared as a run's answers are.

Prints one line a seed with the numbers the check compares.  The benchmark's
own runs never run it; it is how each limit's upper reading was taken.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402

from bench import checks, common, harness  # noqa: E402
from bench.reference import mine as ref_mine  # noqa: E402
from bench.reference import rules as ref_rules  # noqa: E402


class _Host:
    """A reference rulebook's columns in the shape of the program's host
    rulebook, sorted by descending score, as ``checks.rules_differing``
    reads them."""

    def __init__(self, book: dict):
        order = np.argsort(-book["score"], kind="stable")
        self.ante_packed, self.cons_packed = book["ante"][order], book["cons"][order]
        self.ante_len, self.scores = book["ante_len"][order], book["score"][order]


def control_numbers(config: dict, traffic: dict, seed: int, device: str, dense=None) -> dict:
    """The check's numbers with the control in the program's place."""
    m = config["mining"]
    dense = common.dataset(config) if dense is None else dense
    ref = ref_mine.frequent_itemsets(dense, m["min_support"], m["max_k"], device=device)
    num_items = config["data"]["num_items"]
    book = ref_rules.rules(ref, m["min_confidence"], num_items)
    if traffic["driver"] == "jobs":
        low = ref_mine.frequent_itemsets(dense, m["min_support"], m["max_k"], device=device, low_precision=True)
        low_book = ref_rules.rules(low, m["min_confidence"], num_items)
        return dict(itemsets_differing=checks.itemsets_differing(low, ref),
                    rules_differing=checks.rules_differing(_Host(low_book), book))
    n = int(traffic.get("check_sample", 4096)) + int(traffic.get("check_longest", 64))
    baskets = common.fresh_baskets(config, [seed % (1 << 63), 2], n)
    want = ref_rules.item_scores(book, baskets, num_items, device=device).cpu().numpy()
    low = ref_rules.item_scores(book, baskets, num_items, device=device, low_precision=True)
    items, scores = ref_rules.top_items(low, int(config["serving"]["top_k"]))
    score_gap, rank_gap, malformed = checks.answer_gaps(items, scores.astype(np.float32), want)
    return dict(answer_gap=max(score_gap, rank_gap), score_gap=score_gap, rank_gap=rank_gap, malformed=malformed)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    piece = harness.load_cell(args.workload)
    traffic = harness._merge(piece["traffic"], piece["cell"].get("params"))
    dense = common.dataset(piece["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = control_numbers(piece["config"], traffic, seed, "cuda", dense)
        print("control " + json.dumps(dict(workload=args.workload, seed=seed, seconds=time.perf_counter() - t,
                                           **out), default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
