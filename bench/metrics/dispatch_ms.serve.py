"""Gateway and batcher: the mean device.dispatch span (a batch's match, top-k and copies) of the gateway's tracer in the traced window."""

from bench.readers import span_ms

UNIT = "ms"


def read(run):
    return span_ms(run, "device.dispatch")
