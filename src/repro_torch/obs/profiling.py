"""Profiling hooks: named phase spans and REPRO_PROFILE traces.

Two layers (the JAX package's, without its ``annotate``):

  * :func:`phase` — a span around one engine phase running on a device:
    ``torch.profiler.record_function("repro.<name>")`` on the host, plus
    an NVTX range when the phase runs on a CUDA device.  Where the JAX
    package's ``named_scope`` costs nothing at run time, a span here costs
    a few microseconds of host time a call, so the engines wrap whole
    phases and blocks, never per-round or per-row work, and a span adds
    no host read, synchronize or copy of its own.  :data:`ENGINE_PHASES`
    lists every name the engines open;
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

# every span the engines open, in execution order (``repro.<name>``):
#   lift          host -> device lifting of a call's inputs
#   trajectory    the worker trajectories
#   policy_replay every allocator strategy's predicted p_good
#   allocate      LEA's allocation (rank sort, tails, argmax), a block
#   static_loads  the static strategies' loads, a block: every resampler
#                 try, the static_single draw, the stack of all loads
#   static_wait   inside static_loads: the resampler's one host read a try
#                 (its calls count the tries)
#   score         the deadline rule over every strategy's loads, a block
#   channel       the fault trace: base_trace and the channel's injectors
#   decode        per-packet decodes (faults), the coded round's decode
#   fetch         the result assembled and copied to the host
ENGINE_PHASES = ("lift", "trajectory", "policy_replay", "allocate", "static_loads",
                 "static_wait", "score", "channel", "decode", "fetch")

_TRACES = itertools.count()


def profile_dir() -> str | None:
    """The REPRO_PROFILE trace directory, or None when profiling is off."""
    return os.environ.get(PROFILE_ENV) or None


@contextlib.contextmanager
def phase(name: str, device=None) -> Iterator[None]:
    """Span ``repro.<name>`` around one engine phase running on ``device``
    (an NVTX range too when that is a CUDA device).  The profiler's range
    opens only while a profiler collects: an idle ``record_function``
    still costs several microseconds a call."""
    nvtx = device is not None and torch.device(device).type == "cuda"
    label = f"repro.{name}"
    collecting = torch.autograd._profiler_enabled()
    with torch.profiler.record_function(label) if collecting else contextlib.nullcontext():
        if nvtx:
            torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


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
