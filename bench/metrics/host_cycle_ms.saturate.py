"""Gateway and batcher: the dispatch thread's own work a batch, the mean gateway.batch span less the mean cycle.d2h span (the wait for the device and the copy back)."""

from bench.readers import span_ms

UNIT = "ms"


def read(run):
    cycle, d2h = span_ms(run, "gateway.batch"), span_ms(run, "cycle.d2h")
    return cycle - d2h if cycle is not None and d2h is not None else None
