"""Reading a ``torch.profiler`` trace of the measured window.

:class:`Tracer` profiles host and device activity around a part of the
window and writes the Chrome trace into the run's temporary directory;
:func:`read` reduces its events to what the per-layer metrics read:

  * ``spans``: each ``repro.*`` span of the program (host ms, calls) with
    the device ms and count of the operations launched inside it, matched
    to their launch through the correlation id;
  * ``unspanned_ms`` / ``unspanned_ops``: device work launched outside
    every ``repro.*`` span;
  * ``busy_s``: the union of the intervals in which a device operation ran;
  * ``ops``: device operations (kernels, copies, sets); ``by_kernel``:
    device ms by operation name;
  * ``syncs``: host calls that wait for the device (stream, event and
    device synchronizes, and blocking copies);
  * ``idle_gaps``: the longest gaps between device operations, named by
    the outermost host operation running at the gap's middle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    """Context manager: profile CPU and CUDA activity; ``events`` and
    ``window_s`` once it has closed.  The body's device work is waited
    for before the trace stops."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        fd, path = tempfile.mkstemp(suffix=".trace.json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return False


def _union_us(ivals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(ivals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _inside(starts: list[float], ivals: list[tuple[float, float]], ts: float) -> bool:
    """Is ``ts`` inside one of the sorted, non-nested intervals?"""
    i = bisect.bisect_right(starts, ts) - 1
    return i >= 0 and ts <= ivals[i][1]


def read(events: list[dict]) -> dict:
    spans: dict[str, list[tuple[float, float]]] = {}
    host_ops: list[tuple[float, float, str]] = []
    launch_ts: dict[int, float] = {}
    device: list[tuple[int, float, float, str]] = []
    syncs = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args, name = e.get("cat", ""), e.get("args") or {}, e.get("name", "")
        if cat == "user_annotation" and name.startswith("repro."):
            spans.setdefault(name, []).append((e["ts"], e["ts"] + e["dur"]))
        elif cat == "cpu_op":
            host_ops.append((e["ts"], e["ts"] + e["dur"], name))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launch_ts[args["correlation"]] = e["ts"]
            if name in SYNC_CALLS:
                syncs += 1
        elif cat in DEVICE_CATS:
            device.append((args.get("correlation", -1), e["ts"], e["ts"] + e["dur"], name))

    out_spans = {}
    for name, ivals in spans.items():
        ivals.sort()
        starts = [a for a, _ in ivals]
        dev_us, ops = 0.0, 0
        for corr, a, b, _ in device:
            ts = launch_ts.get(corr)
            if ts is not None and _inside(starts, ivals, ts):
                dev_us += b - a
                ops += 1
        out_spans[name] = {"calls": len(ivals),
                           "host_ms": sum(b - a for a, b in ivals) / 1e3,
                           "device_ms": dev_us / 1e3, "device_ops": ops}

    every = sorted(iv for ivals in spans.values() for iv in ivals)
    merged: list[list[float]] = []
    for a, b in every:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    unspanned_us, unspanned_ops = 0.0, 0
    by_kernel: dict[str, float] = {}
    for corr, a, b, name in device:
        by_kernel[name] = by_kernel.get(name, 0.0) + (b - a) / 1e3
        ts = launch_ts.get(corr)
        if ts is None or not _inside(starts, merged, ts):
            unspanned_us += b - a
            unspanned_ops += 1

    return {"spans": out_spans, "unspanned_ms": unspanned_us / 1e3,
            "unspanned_ops": unspanned_ops,
            "busy_s": _union_us([(a, b) for _, a, b, _ in device]) / 1e6,
            "ops": len(device), "by_kernel": by_kernel, "syncs": syncs,
            "idle_gaps": _idle_gaps(device, host_ops)}


def _idle_gaps(device, host_ops, top: int = 10) -> list[tuple[str, float]]:
    """The ``top`` longest gaps between device operations, in seconds, each
    named by the outermost host operation at its middle."""
    ivals = sorted((a, b) for _, a, b, _ in device)
    gaps, end = [], None
    for a, b in ivals:
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    gaps.sort(reverse=True)
    host_ops = sorted(host_ops)
    starts = [a for a, _, _ in host_ops]
    named = []
    for length, a, b in gaps[:top]:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        covering = [op for op in host_ops[:i] if op[1] >= mid]
        named.append((covering[0][2] if covering else "host, outside any operation",
                      length / 1e6))
    return named


def top_ops(trace: dict, top: int = 10) -> list[tuple[str, float]]:
    """The device operations that took most time, in seconds."""
    ranked = sorted(trace["by_kernel"].items(), key=lambda kv: -kv[1])[:top]
    return [(name, ms / 1e3) for name, ms in ranked]
