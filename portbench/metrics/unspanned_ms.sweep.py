"""Device ms a sweep launched outside every `repro.*` span: the static
resampler, the input lifting and the executor's copies."""


def read(ctx):
    return ctx["trace"]["unspanned_ms"] / ctx["jobs"]
