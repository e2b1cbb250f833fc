"""Device ms a sweep under `repro.allocate` (core.lea: ranks, B1, the
argmax prefix and the loads)."""
from portbench.metrics import span


def read(ctx):
    return span(ctx, "allocate", "device_ms")
