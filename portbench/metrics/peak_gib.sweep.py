"""The run's peak device memory, GiB (`torch.cuda.max_memory_allocated`)."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30 if ctx["peak_bytes"] else None
