"""Profiling hooks: named phase spans, host spans, REPRO_PROFILE traces.

Three layers, as in the JAX package:

  * :func:`phase` — a span around one engine phase (``trajectory`` ->
    ``policy_replay`` -> ``allocate`` -> ``score`` -> ``decode``):
    ``torch.profiler.record_function("repro.<name>")`` on the host, plus
    an NVTX range when the phase runs on a CUDA device.  Where the JAX
    package's ``named_scope`` costs nothing at run time, a span here costs
    a few microseconds of host time a call, so the engines wrap whole
    phases, never per-round work;
  * :func:`annotate` — a host span of the caller's own name (e.g. around
    one benchmark step);
  * :func:`profile_trace` — the collection gate: when ``REPRO_PROFILE``
    names a directory, the context manager collects a ``torch.profiler``
    trace (CPU and, with a card, CUDA activity) of its body and writes it
    there as Chrome-trace JSON (Perfetto / ``chrome://tracing``); unset, it
    is a no-op.  The phase spans land in the trace as ``repro.<name>``
    events, and the kernels each launched beside them.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Iterator

import torch

PROFILE_ENV = "REPRO_PROFILE"

# engine phases, in execution order
ENGINE_PHASES = ("trajectory", "policy_replay", "allocate", "score", "decode")

_TRACES = itertools.count()


def profile_dir() -> str | None:
    """The REPRO_PROFILE trace directory, or None when profiling is off."""
    return os.environ.get(PROFILE_ENV) or None


@contextlib.contextmanager
def phase(name: str, device=None) -> Iterator[None]:
    """Span ``repro.<name>`` around one engine phase running on ``device``
    (an NVTX range too when that is a CUDA device)."""
    nvtx = device is not None and torch.device(device).type == "cuda"
    label = f"repro.{name}"
    with torch.profiler.record_function(label):
        if nvtx:
            torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Host span under the caller's name; inert unless a trace is collected."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_trace(label: str = "repro") -> Iterator[str | None]:
    """Collect a ``torch.profiler`` trace into $REPRO_PROFILE, if set.

    Yields the trace directory (or None when profiling is off).  The
    directory is created if missing; the profiler stops and the trace
    (``<label>.<pid>.<n>.trace.json``) is written even when the body
    raises, so a crashing run still leaves a usable trace.
    """
    out = profile_dir()
    if out is None:
        yield None
        return
    os.makedirs(out, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        with torch.profiler.record_function(label):
            yield out
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(out, f"{label}.{os.getpid()}.{next(_TRACES)}.trace.json"))
