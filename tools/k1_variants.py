"""Check and time versions of the K1 CUDA kernel side by side on one card.

    python3 tools/k1_variants.py [--check] [--profile] [--reps 5] tree [NAME=SOURCE ...]

``tree`` is the kernel in ``src/repro_torch/kernels/csrc/support_count_packed.cu``
through the port's wrapper.  Any other variant is a CUDA source with the C
interface of the row-layout K1 (``support_count_packed_launch`` taking t, c,
lengths, out, n, k, w, mode, the transaction splits of its (candidate tile,
split) grid and a stream), built with ``nvcc`` into ``build/k1_variants/``
(``tools/variants.py``).  For example, against the row-layout design of
commit ffc206a:

    mkdir -p build/parent && git archive ffc206a | tar -x -C build/parent
    python3 tools/k1_variants.py --check tree \\
        rows=build/parent/src/repro_torch/kernels/csrc/support_count_packed.cu

``--check`` holds every variant to the plain version on the smoke's sweep
and K1's edges (``chip_smoke.k1_edge_problem``).  Then every variant is
timed with CUDA events at the packed mine's level-2 pass of the FIMI
T10I4D100K shape (N = 100,000, 41,616 candidates in a bucket of 65,536,
W = 32) in both modes, in the order A B .. B A; each variant is exact there
too.  ``--profile`` then prints the device time of each CUDA kernel of
every variant (``torch.profiler``) in and_cmp mode.  The last line is a JSON
object of the mean times in ms.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch
from variants import alternate, build, card, profile, smoke

from repro_torch.kernels import ops

MODES = ("and_cmp", "popcount")
SWEEP = [(8, 16, 4), (100, 64, 33), (256, 128, 128), (300, 130, 257), (512, 512, 300), (200, 1100, 70)]


def row_layout_splits(n: int, k: int) -> int:
    """The row-layout K1's grid: 128 candidates a block, enough transaction splits for
    132 x 8 blocks, never a split below one 32-row tile."""
    k_tiles = max(1, -(-k // 128))
    return max(1, min(max(1, -(-n // 32)), -(-(132 * 8) // k_tiles), 65535))


def variant(spec: str):
    """(name, run) for ``tree`` or NAME=SOURCE; run(t, c, lengths, mode) -> counts."""
    if spec == "tree":
        return "tree", lambda t, c, ln, mode: ops.support_count_packed(t, c, ln, mode=mode, impl="kernel")
    name, source = spec.split("=", 1)
    fn = build("k1", name, source).support_count_packed_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(t, c, ln, mode):
        n, w = t.shape
        k = c.shape[0]
        out = torch.zeros(k, dtype=torch.int32, device=t.device)
        err = fn(t.data_ptr(), c.data_ptr(), ln.data_ptr(), out.data_ptr(), n, k, w, MODES.index(mode),
                 row_layout_splits(n, k), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        return out

    return name, run


def check(name, run, dev):
    cases = [(str(s), smoke.count_problem(*s, seed=sum(s))) for s in SWEEP]
    cases += [(f"edges N={n}", smoke.k1_edge_problem(n, seed=n)) for n in (1, 77, 1000)]
    for mode in MODES:
        for what, (tp, cp, ln) in cases:
            t, c, l_ = smoke.words(tp, dev), smoke.words(cp, dev), torch.from_numpy(ln).to(dev)
            if not torch.equal(run(t, c, l_, mode), ops.support_count_packed(t, c, l_, mode=mode, impl="ref")):
                raise AssertionError(f"{name} {mode} {what}: counts differ from the plain version")
    print(f"[check] {name}: {2 * len(cases)} cases exactly equal to the plain version", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true", help="device time of each CUDA kernel")
    args = ap.parse_args()
    line = card("k1_variants")
    if line is None:
        return 2
    from repro_torch.core import apriori
    from repro_torch.core.candidates import generate_candidates
    from repro_torch.data.synthetic import QuestConfig, gen_transactions

    dev = torch.device("cuda")
    runs = dict(variant(spec) for spec in args.variants)
    if args.check:
        for name, run in runs.items():
            check(name, run, dev)

    db = gen_transactions(QuestConfig(num_transactions=100_000, num_items=1_000, avg_len=10.0, seed=0))
    freq1 = np.flatnonzero(db.sum(0, dtype=np.int64) >= 200).astype(np.int32)[:, None]  # min_support 0.002
    cands = generate_candidates(freq1)
    cfg = apriori.AprioriConfig(representation="packed")
    kp = apriori._pad_bucket(cands.shape[0], apriori._candidate_quantum(cfg))
    t = apriori.place_db(db, cfg, dev)
    c, l_ = apriori._place_candidates(cands, kp, db.shape[1], cfg, dev)
    want = ops.support_count_packed(t, c, l_, impl="ref")
    result = {}
    for mode in MODES:
        calls = {name: (lambda run=run: run(t, c, l_, mode)) for name, run in runs.items()}
        times = alternate(calls, want, args.reps, f"{mode} at the level-2 pass")
        for name, ts in times.items():
            ms = sum(ts) / len(ts)
            result[f"{name}_{mode}"] = ms
            print(f"[time] {name} {mode} N={t.shape[0]} Kp={kp} W={t.shape[1]}: exact; "
                  f"{' / '.join(f'{x:.4f}' for x in ts)} ms, mean {ms:.4f} ms [{line}]", flush=True)
    if args.profile:
        for name, run in runs.items():
            profile(lambda run=run: run(t, c, l_, "and_cmp"), args.reps, f"{name} and_cmp", line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
