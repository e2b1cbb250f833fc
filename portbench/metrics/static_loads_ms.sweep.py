"""Device ms a sweep under `repro.static_loads` (the static strategies'
loads: every try of the resampler, the static_single draw, the stack of
every strategy's loads)."""
from portbench.metrics import span


def read(ctx):
    return span(ctx, "static_loads", "device_ms")
