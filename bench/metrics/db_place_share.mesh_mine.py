"""Counting passes in memory: the share of job wall in placing each rank's split on its card (MiningObs phase db_place), mean over ranks."""

from bench.readers import phase_share

UNIT = "%"


def read(run):
    return phase_share(run, "db_place")
