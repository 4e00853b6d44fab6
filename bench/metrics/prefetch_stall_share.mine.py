"""Chunk pipeline: the share of job wall in the streamed miner's prefetch_stall phase (its MiningObs)."""

from bench.readers import phase_share

UNIT = "%"


def read(run):
    return phase_share(run, "prefetch_stall")
