"""Device: the share of the traced window with nothing running on the card (torch.profiler)."""

from bench.readers import idle_pct

UNIT = "%"


def read(run):
    return idle_pct(run)
