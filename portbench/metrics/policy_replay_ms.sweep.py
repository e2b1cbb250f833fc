"""Device ms a sweep under `repro.policy_replay` (policies: every
allocator strategy's predicted p_good for every round)."""
from portbench.metrics import span


def read(ctx):
    return span(ctx, "policy_replay", "device_ms")
