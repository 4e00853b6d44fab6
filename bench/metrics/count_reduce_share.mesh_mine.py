"""Counting passes on a mesh: the share of job wall in each pass's all-reduce of its counts (MiningObs phase count_reduce, CUDA events), mean over ranks."""

from bench.readers import phase_share

UNIT = "%"


def read(run):
    return phase_share(run, "count_reduce")
