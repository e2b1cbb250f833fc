"""Device ms a sweep under the fault engine's `repro.decode`: per-packet
on-time masks and counts of both decode modes."""
from portbench.metrics import span


def read(ctx):
    return span(ctx, "decode", "device_ms")
