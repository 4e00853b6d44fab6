"""Counting passes in memory: the share of job wall inside apriori._place_candidates (the benchmark's wrap)."""

from bench.readers import job_share

UNIT = "%"


def read(run):
    return job_share(run, "bench.place_candidates")
