"""Device ms a sweep under the fault engine's `repro.channel` (the fault
trace: its cut-offs, the `keep` mask and their draws)."""
from portbench.metrics import span


def read(ctx):
    return span(ctx, "channel", "device_ms")
