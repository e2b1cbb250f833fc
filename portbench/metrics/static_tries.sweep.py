"""The static resampler's host reads a sweep: calls of `repro.static_wait`,
one a try and one more a block for the read that ends it."""
from portbench.metrics import span


def read(ctx):
    return span(ctx, "static_wait", "calls")
