"""Host waits on the device a sweep, counted from the trace (stream,
event and device synchronizes and blocking copies)."""


def read(ctx):
    return ctx["trace"]["syncs"] / ctx["jobs"]
