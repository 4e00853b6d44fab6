"""Level loop: the share of job wall in the miner's own candidate_gen phase (its MiningObs), the program's twin of candgen_share.mine."""

from bench.readers import phase_share

UNIT = "%"


def read(run):
    return phase_share(run, "candidate_gen")
