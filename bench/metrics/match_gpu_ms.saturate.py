"""K2: the mean gpu.match span of the gateway's tracer in the traced window, a traced batch's compaction and match by the program's CUDA events."""

from bench.readers import span_ms

UNIT = "ms"


def read(run):
    return span_ms(run, "gpu.match")
