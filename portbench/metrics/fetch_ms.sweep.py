"""Device ms a sweep under `repro.fetch` (the blocks' successes joined
and copied to the host)."""
from portbench.metrics import span


def read(ctx):
    return span(ctx, "fetch", "device_ms")
