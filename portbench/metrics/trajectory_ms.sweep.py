"""Device ms a sweep of the work launched under `repro.trajectory`
(core.markov: the worker trajectories)."""
from portbench.metrics import span


def read(ctx):
    return span(ctx, "trajectory", "device_ms")
