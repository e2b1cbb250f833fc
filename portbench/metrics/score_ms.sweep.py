"""Device ms a sweep under `repro.score` (core.throughput: the deadline
rule over every strategy's loads)."""
from portbench.metrics import span


def read(ctx):
    return span(ctx, "score", "device_ms")
