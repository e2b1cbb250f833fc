"""Per-layer metric readers, one file a metric, named as in BENCHMARK.json.

Each file defines ``read(ctx) -> float | None``.  ``ctx`` holds the traced
part of the window: ``trace`` (:func:`portbench.work.trace.read`),
``window_s`` (its length), ``jobs`` (sweeps in it),
``work`` (the driver's least bytes and operations a job) and
``peak_bytes``.  A reader that finds nothing to read returns None, and the
metric is left out of the line.  The helpers below are shared.
"""

from __future__ import annotations


def span(ctx, name: str, field: str):
    """``field`` of the program's span ``repro.<name>`` a job, or None."""
    s = ctx["trace"]["spans"].get(f"repro.{name}")
    return None if s is None or s["calls"] == 0 else s[field] / ctx["jobs"]


def kernel_ms(ctx, *fragments: str) -> float:
    """Device ms of the operations whose names hold any of ``fragments``."""
    return sum(ms for name, ms in ctx["trace"]["by_kernel"].items()
               if any(f in name for f in fragments))


def idle_percent(ctx):
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / ctx["window_s"])


def roofline_percent(ctx, work: str, ops_per_s: float, *fragments: str):
    """The least time of the traced jobs' ``work`` over the device time of
    the kernels named by ``fragments``, in percent; None if they never ran."""
    from portbench.work.peaks import bound_s

    spent_ms = kernel_ms(ctx, *fragments)
    if spent_ms <= 0:
        return None
    moved, ops = ctx["work"][work]
    return 100.0 * bound_s(moved, ops, ops_per_s) * ctx["jobs"] / (spent_ms / 1e3)
