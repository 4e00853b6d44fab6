"""Device: the share of the traced window with nothing running on a card, each card's busy time averaged over the cards (torch.profiler on every rank)."""

from bench.readers import idle_pct

UNIT = "%"


def read(run):
    return idle_pct(run)
