"""Gateway and batcher: real rows a batch over the traced window (GatewayMetrics counters)."""

from bench.readers import batch_rows

UNIT = "rows"


def read(run):
    return batch_rows(run)
