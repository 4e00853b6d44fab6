"""Check and time versions of the K2 CUDA kernel side by side on one card.

    python3 tools/k2_variants.py [--profile] [--reps 20] tree [NAME=SOURCE ...]

``tree`` is the kernel in ``src/repro_torch/kernels/csrc/rule_match.cu``
through the port's wrapper.  Any other variant is a CUDA source with K2's C
interface (``rule_match_launch`` and ``rule_match_scratch_bytes``), built
with ``nvcc`` into ``build/k2_variants/`` (``tools/variants.py``).  For example, against the
kernel of commit ffc206a:

    mkdir -p build/parent && git archive ffc206a | tar -x -C build/parent
    python3 tools/k2_variants.py tree old=build/parent/src/repro_torch/kernels/csrc/rule_match.cu

Every variant is timed with CUDA events on the smoke's main-path batch: the
first 1,024 rows of the FIMI T10I4D100K shape against the rulebook the
packed mine compiles there (43,520 rule rows, 1,024 items), on the same
number of baskets holding every item, and on the smoke's ``[k2-wide]``
problems (8 baskets, 300 rules, 42,528 and 70,000 items), in the order
A B .. B A; each output is bit for bit ``ref.rule_match_ordered``.
``--profile`` then prints the device time of each CUDA kernel of every
variant (``torch.profiler``) on each problem.  The last line is a JSON object
of the mean times in ms.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch
from variants import alternate, build, card, profile, smoke

from repro_torch.kernels import ops, ref


def variant(spec: str):
    """(name, run) for ``tree`` or NAME=SOURCE; run(b, a, lengths, c, scores) -> scores."""
    if spec == "tree":
        return "tree", lambda *args: ops.rule_match(*args, impl="kernel")
    name, source = spec.split("=", 1)
    lib = build("k2", name, source)
    fn = lib.rule_match_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rule_match_scratch_bytes.argtypes = [ctypes.c_int]
    lib.rule_match_scratch_bytes.restype = ctypes.c_longlong

    def run(b, a, lengths, c, scores):
        nb, w = b.shape
        nr = a.shape[0]
        out = torch.empty((nb, 32 * w), dtype=torch.float32, device=b.device)
        scratch = torch.empty(lib.rule_match_scratch_bytes(nr), dtype=torch.uint8, device=b.device)
        err = fn(b.data_ptr(), a.data_ptr(), lengths.data_ptr(), c.data_ptr(), scores.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), nb, nr, w, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        return out

    return name, run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true", help="device time of each CUDA kernel")
    args = ap.parse_args()
    line = card("k2_variants")
    if line is None:
        return 2
    from repro_torch.core.apriori import AprioriConfig, mine
    from repro_torch.core.itemsets import pack_bits
    from repro_torch.data.synthetic import QuestConfig, gen_transactions
    from repro_torch.serving.rulebook import compile_rulebook, place_rulebook

    dev = torch.device("cuda")
    runs = dict(variant(spec) for spec in args.variants)
    db = gen_transactions(QuestConfig(num_transactions=100_000, num_items=1_000, avg_len=10.0, seed=0))
    res = mine(db, AprioriConfig(min_support=0.002, max_k=4, representation="packed"), device=dev)
    rb = place_rulebook(compile_rulebook(res, min_confidence=0.4, score="confidence", num_items=1_000), dev)
    rules = (rb.ante_packed, rb.ante_len, rb.cons_packed, rb.scores)
    problems = {"main": (smoke.words(pack_bits(db[:1024]), dev), rules),
                "all_match": (smoke.words(pack_bits(np.ones((1024, 1_000), np.int8)), dev), rules)}
    for i in (42_528, 70_000):
        bk, a, ln, c, s = smoke.rule_problem(8, i, 300, seed=i)
        problems[f"wide_{i}"] = (smoke.words(bk, dev), (smoke.words(a, dev), torch.from_numpy(ln).to(dev),
                                                        smoke.words(c, dev), torch.from_numpy(s).to(dev)))
    result = {}
    for what, (b, rules) in problems.items():
        want = ref.rule_match_ordered(b, *rules)
        calls = {name: (lambda run=run: run(b, *rules)) for name, run in runs.items()}
        times = alternate(calls, want, args.reps, what)
        for name, ts in times.items():
            ms = sum(ts) / len(ts)
            result[f"{name}_{what}"] = ms
            print(f"[time] {name} {what} B={b.shape[0]} R={rules[0].shape[0]} W={b.shape[1]}: bit for bit "
                  f"rule_match_ordered; {' / '.join(f'{x:.4f}' for x in ts)} ms, mean {ms:.4f} ms [{line}]",
                  flush=True)
        if args.profile:
            for name, run in runs.items():
                profile(lambda run=run: run(b, *rules), args.reps, f"{name} {what}", line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
