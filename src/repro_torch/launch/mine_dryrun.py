"""Roofline dry run of the paper's own workload: the distributed support-count
step at production scale (N = 2^20 transactions x I = 2,048 items x K = 2^16
candidates) on the 16 x 16 layout, one rank's block walked on meta tensors.

  PYTHONPATH=src python -m repro_torch.launch.mine_dryrun [--variant all]
      [--n 1048576] [--k 65536] [--out dryrun.json]

Variants (the JAX package's ``launch/mine_dryrun.py``, same keys):
  paper_1d : the paper's decomposition — transactions row-sharded over ALL
             ranks, candidates replicated (Hadoop map tasks are 1-D);
  ours_2d  : transactions over 'data', candidates over 'model' (2-D);
  ours_2d_blocked : the same with the count blocked over candidates
             (``ref.support_count_blocked``): no (rows, K) intermediate.

Each variant is the mesh engine (``core/mapreduce.py``) around the plain
dense count on a :class:`launch.mesh.MeshLayout` (shapes only: no rank is
started, no device is touched), walked by ``launch.op_analysis``.  The
collective is the step's one all-reduce of the rank's counts over the data
axes: K·4 bytes on ``paper_1d``, K/M·4 on ``ours_2d``, whose output stays
split over 'model' (as the JAX package's ``out_specs=P("model")``; the
blocks are assembled outside the step).  Blocks here are slices with no
padding row, so the blocked flops equal ``ours_2d``'s (the JAX package pads
K per rank to a 512-row block).

The three terms are the H100 SXM part's (``launch.roofline``; ``--part``
names another): the count at the bf16 tensor-core rate, bytes at its HBM
rate, and the collective at NDR's 50 GB/s, since every group of the 16 x 16
layout spans more than one node of 8.  They model NCCL at link rate, not
the gloo backend the one-card runs use.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core.apriori import AprioriConfig
from repro_torch.core.mapreduce import MapReduceJob, mapreduce
from repro_torch.kernels import ref
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import MeshLayout, production_mesh_shape
from repro_torch.launch.roofline import detect_chip, link_bytes_per_s, roofline_terms

VARIANTS = {
    # name -> (data axes, model axis, the count every rank runs on its block)
    "paper_1d": (("data", "model"), None, ref.support_count_ref),
    "ours_2d": (("data",), "model", ref.support_count_ref),
    "ours_2d_blocked": (("data",), "model", ref.support_count_blocked),
}


def run(variant: str, n=1 << 20, items=2048, k_cands=1 << 16, *, part: str = "sxm"):
    if variant not in VARIANTS:
        raise ValueError(variant)
    data_axes, model_axis, count = VARIANTS[variant]
    mesh = MeshLayout(*production_mesh_shape())
    cfg = AprioriConfig(data_axes=data_axes, model_axis=model_axis)
    step = mapreduce(MapReduceJob(map_fn=count, reduce_axes=cfg.data_axes), mesh)
    rows = n // mesh.shard(data_axes)[1]
    kb = k_cands // (mesh.shape[model_axis] if model_axis else 1)
    c = op_analysis.analyze(
        step, op_analysis.meta((rows, items), torch.int8), op_analysis.meta((kb, items), torch.int8),
        op_analysis.meta((kb,), torch.int32))
    chip = detect_chip(part=part)
    link = link_bytes_per_s({r for g in c.collective_groups for r in g}, chip)
    rl = roofline_terms(c.flops, c.hbm_bytes, c.collective_bytes, chip=chip, link_bytes_per_s=link)
    model_flops = 2.0 * n * items * k_cands / mesh.size
    return {
        "variant": variant,
        "temp_gb_per_dev": c.temp_bytes / 1e9,
        "flops_per_dev": c.flops,
        "hbm_per_dev": c.hbm_bytes,
        "coll_per_dev": c.collective_bytes,
        "compute_s": rl.compute_s,
        "memory_s": rl.memory_s,
        "collective_s": rl.collective_s,
        "dominant": rl.dominant,
        "useful_flops_ratio": model_flops / max(c.flops, 1.0),
        "collective_counts": c.collective_counts,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="all")
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--k", type=int, default=1 << 16)
    ap.add_argument("--part", default="sxm", help="the H100 part to cost: sxm | pcie | nvl")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    variants = list(VARIANTS) if args.variant == "all" else [args.variant]
    recs = [run(v, n=args.n, k_cands=args.k, part=args.part) for v in variants]
    js = json.dumps(recs, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)
    print(js)
    return recs


if __name__ == "__main__":
    main()
