"""Check and time versions of the K3 CUDA kernel side by side on one card.

    python3 tools/k3_variants.py [--check] [--reps 5] tree [NAME=SOURCE[:ENTRY[:splits]] ...]

``tree`` is the kernel in ``src/repro_torch/kernels/csrc/support_count.cu``
through the port's wrapper.  Any other variant is a CUDA source with K3's C
interface (``support_count_launch``, or ``ENTRY``, taking t, c, lengths,
out, n, k, ip, dtype, an int and a stream), built with ``nvcc`` into
``build/k3_variants/`` (``tools/variants.py``).  A source whose int argument
is the transaction splits of a (candidate tile, split) grid, as the ``wmma``
K3 of commit 2ce1b52 takes it, is named with a ``splits`` suffix in ENTRY:
``wmma=old.cu:support_count_launch:splits``.  For example, against that
commit's kernel:

    git show 2ce1b52:src/repro_torch/kernels/csrc/support_count.cu > build/old_k3.cu
    python3 tools/k3_variants.py --check tree wmma=build/old_k3.cu:support_count_launch:splits

``--check`` holds every variant to the plain version on the smoke's sweep
and edge shapes and an empty candidate.  Then every variant is timed with
CUDA events at the dense mine's level-2 pass of the FIMI T10I4D100K shape
(N = 100,000, 41,616 candidates in a bucket of 65,536, 1,024 items) in bf16
and int8, in the order A B .. B A, beside ``torch.matmul`` of the same bf16
operands; each variant is exact there too.  The last line is a JSON object
of the mean times in ms.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import sys

import numpy as np
import torch
from variants import alternate, build, card, smoke

from repro_torch.kernels import ops
k3 = importlib.import_module("repro_torch.kernels.support_count")

SWEEP = [(8, 16, 4), (100, 64, 33), (256, 128, 128), (300, 130, 257), (512, 512, 300), (200, 1100, 70),
         (1000, 130, 600), (1000, 1100, 600), (20000, 1000, 3000), (300, 64, 70000)]


def variant(spec: str):
    """(name, run) for ``tree`` or NAME=SOURCE[:ENTRY[:splits]]; run(t, c,
    lengths, operand_dtype) -> counts."""
    if spec == "tree":
        return "tree", lambda t, c, ln, dt: ops.support_count(t, c, ln, operand_dtype=dt, impl="kernel")
    name, rest = spec.split("=", 1)
    source, _, tail = rest.partition(":")
    entry, _, mode = tail.partition(":")
    entry, splits = entry or "support_count_launch", mode == "splits"
    fn = getattr(build("k3", name, source), entry)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run(t, c, ln, operand_dtype):
        n, ip = t.shape
        k = c.shape[0]
        # the wmma K3's grid: enough (candidate tile, split) blocks for four
        # waves of two blocks per SM, never a split below one 128-row tile
        arg = max(1, min(-(-n // 128), -(-(8 * sms) // max(1, -(-k // 128))), 65535)) if splits else sms
        out = torch.zeros(k, dtype=torch.int32, device=t.device)
        err = fn(t.data_ptr(), c.data_ptr(), ln.data_ptr(), out.data_ptr(), n, k, ip,
                 k3.DTYPES[operand_dtype][0], arg, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        return out

    return name, run


def check(name, run, dev):
    for operand_dtype in k3.DTYPES:
        cases = [(s, smoke.dense_problem(*s, seed=sum(s))) for s in SWEEP]
        t, c, ln = smoke.dense_problem(1000, 130, 600, seed=3)
        c[5], ln[5] = 0, 0
        cases.append(("empty candidate", (t, c, ln)))
        for what, (t, c, ln) in cases:
            dt = k3.DTYPES[operand_dtype][1]
            pad = ((0, 0), (0, k3.item_width(t.shape[1]) - t.shape[1]))
            tt = torch.from_numpy(np.pad(t, pad)).to(dev).to(dt)
            tc = torch.from_numpy(np.pad(c, pad)).to(dev).to(dt)
            l_ = torch.from_numpy(ln).to(dev)
            got = run(tt, tc, l_, operand_dtype)
            if not torch.equal(got, ops.support_count(tt, tc, l_, impl="ref")):
                raise AssertionError(f"{name} {operand_dtype} {what}: counts differ from the plain version")
            if what == "empty candidate" and int(got[5]) != 1000:
                raise AssertionError(f"{name} {operand_dtype}: the empty candidate counts {int(got[5])}")
    print(f"[check] {name}: {2 * (len(SWEEP) + 1)} cases exactly equal to the plain version", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    line = card("k3_variants")
    if line is None:
        return 2
    from repro_torch.core import apriori
    from repro_torch.core.candidates import generate_candidates
    from repro_torch.data.synthetic import QuestConfig, gen_transactions

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    runs = dict(variant(spec) for spec in args.variants)
    if args.check:
        for name, run in runs.items():
            check(name, run, dev)

    db = gen_transactions(QuestConfig(num_transactions=100_000, num_items=1_000, avg_len=10.0, seed=0))
    min_count = 200  # min_support 0.002 of 100,000 rows, as the smoke mines
    freq1 = np.flatnonzero(db.sum(0, dtype=np.int64) >= min_count).astype(np.int32)[:, None]
    cands = generate_candidates(freq1)
    kp = apriori._pad_bucket(cands.shape[0], apriori._candidate_quantum(apriori.AprioriConfig()))
    op_count = 2 * db.shape[0] * cands.shape[0] * db.shape[1]
    result = {}
    for operand_dtype in k3.DTYPES:
        cfg = apriori.AprioriConfig(operand_dtype=operand_dtype)
        t = apriori.place_db(db, cfg, dev)
        c, l_ = apriori._place_candidates(cands, kp, db.shape[1], cfg, dev)
        want = ops.support_count(t, c, l_, impl="ref")
        calls = {name: (lambda run=run: run(t, c, l_, operand_dtype)) for name, run in runs.items()}
        times = alternate(calls, want, args.reps, f"{operand_dtype} at the level-2 pass")
        if operand_dtype == "bf16":
            prod = lambda: torch.matmul(t, c.T)  # noqa: E731  (the product alone, never on the port's path)
            prod()
            torch.cuda.synchronize()
            result["gemm_ms"] = smoke.cuda_ms(prod, 3)
            print(f"[time] bf16 torch.matmul of the same operands {result['gemm_ms']:.3f} ms [{line}]", flush=True)
        for name, ts in times.items():
            ms = sum(ts) / len(ts)
            result[f"{name}_{operand_dtype}"] = ms
            print(f"[time] {name} {operand_dtype} N={t.shape[0]} Kp={kp} Ip={t.shape[1]}: exact; "
                  f"{' / '.join(f'{x:.3f}' for x in ts)} ms, mean {ms:.3f} ms = "
                  f"{op_count / (ms * 1e-3) / 1e12:.1f} T op/s over the real work, "
                  f"{ms / result['gemm_ms']:.3f}x the bare bf16 product [{line}]", flush=True)
        del t, c
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
