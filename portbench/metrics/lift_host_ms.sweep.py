"""Host ms a sweep under `repro.lift` (a call's inputs lifted to the
device)."""
from portbench.metrics import span


def read(ctx):
    return span(ctx, "lift", "host_ms")
