"""Level loop: the share of job wall inside candidates.generate_candidates (the benchmark's wrap)."""

from bench.readers import job_share

UNIT = "%"


def read(run):
    return job_share(run, "bench.candidate_gen")
