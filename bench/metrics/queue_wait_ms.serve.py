"""Gateway and batcher: the mean queue.wait span of the gateway's tracer in the traced window."""

from bench.readers import span_ms

UNIT = "ms"


def read(run):
    return span_ms(run, "queue.wait")
