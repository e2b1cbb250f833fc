"""Host metrics registry: named counters/gauges/histograms + sinks.

The host-side half of the live tier (:mod:`repro_torch.obs.taps` delivers
the engines' block aggregates): a process-local registry of named metrics
fed by tap events and by host-side phases (kernel builds, block
wall-clock — the per-phase attribution hooks next to the engines'
:func:`repro_torch.obs.profiling.phase` spans), with three sinks:

  * :class:`JsonlSink`      — append-only JSONL event log (one tap event
    or metric snapshot per line; the never-raise convention);
  * :meth:`MetricsRegistry.exposition` — Prometheus-style text exposition
    snapshot (``# TYPE`` lines, dot-separated names flattened to
    underscores);
  * :class:`ProgressLine`   — periodic stderr progress line (rounds/sec,
    ETA) driven by tap events or host ``update()`` calls; used by
    ``repro_torch.launch.serve``.

Naming convention (enforced): ``<component>.<subject>[.<detail>...]`` —
lower-case, digits and underscores per segment, at least two dot-separated
segments (``tap.engine_pool.events``, ``phase.sweeps_run_group.seconds``,
``compile.serving_sweep.events``).  The convention keeps exposition names
collision-free after the dot->underscore flattening.

Everything here is plain host Python: no torch import, no effect on the
engines' tensors, safe to call from several threads (mutations take the
registry lock).  A copy of the JAX package's module with its behaviour
unchanged.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import sys
import threading
import time
from typing import Any, Iterator

import numpy as np

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")

_KINDS = ("counter", "gauge", "histogram")


def valid_name(name: str) -> bool:
    """Does ``name`` follow the metric naming convention?"""
    return bool(_NAME_RE.match(name))


def _check_name(name: str) -> str:
    if not valid_name(name):
        raise ValueError(
            f"metric name {name!r} violates the convention "
            "<component>.<subject>[.<detail>...] (lower-case segments, "
            ">= 2 dot-separated)"
        )
    return name


class Metric:
    """One named metric; ``kind`` selects the update semantics.

    counter   — monotone float accumulator (``inc``);
    gauge     — last-value wins (``set``);
    histogram — running count/sum/min/max over ``observe`` values (no
                buckets: the sinks need summaries, not quantile sketches).
    """

    __slots__ = ("name", "kind", "help", "value", "count", "total",
                 "vmin", "vmax")

    def __init__(self, name: str, kind: str, help: str = ""):
        self.name = _check_name(name)
        if kind not in _KINDS:
            raise ValueError(f"metric kind must be one of {_KINDS}: {kind!r}")
        self.kind = kind
        self.help = help
        self.value = 0.0           # counter / gauge current value
        self.count = 0             # histogram observations
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def snapshot(self) -> dict[str, Any]:
        if self.kind == "histogram":
            return {
                "kind": self.kind, "count": self.count, "sum": self.total,
                "min": self.vmin if self.count else None,
                "max": self.vmax if self.count else None,
            }
        return {"kind": self.kind, "value": self.value}


class MetricsRegistry:
    """Get-or-create registry of named metrics (kind conflicts are errors)."""

    def __init__(self) -> None:
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind: str, help: str) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Metric(name, kind, help)
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}"
                )
            return m

    def counter(self, name: str, inc: float = 1.0, *, help: str = "") -> float:
        """Increment (and create if needed) a counter; returns its value."""
        if inc < 0:
            raise ValueError(f"counter {name!r}: negative increment {inc}")
        m = self._get(name, "counter", help)
        with self._lock:
            m.value += float(inc)
            return m.value

    def gauge(self, name: str, value: float, *, help: str = "") -> float:
        """Set (and create if needed) a gauge; returns the new value."""
        m = self._get(name, "gauge", help)
        with self._lock:
            m.value = float(value)
            return m.value

    def histogram(self, name: str, value: float, *, help: str = "") -> None:
        """Observe one value into a histogram (create if needed)."""
        m = self._get(name, "histogram", help)
        v = float(value)
        with self._lock:
            m.count += 1
            m.total += v
            m.vmin = min(m.vmin, v)
            m.vmax = max(m.vmax, v)

    def names(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._metrics))

    def get(self, name: str) -> dict[str, Any]:
        with self._lock:
            if name not in self._metrics:
                raise KeyError(f"no metric {name!r}; registered: "
                               f"{tuple(sorted(self._metrics))}")
            return self._metrics[name].snapshot()

    def snapshot(self) -> dict[str, dict[str, Any]]:
        """JSON-able {name: snapshot} of every registered metric."""
        with self._lock:
            return {n: m.snapshot() for n, m in sorted(self._metrics.items())}

    def exposition(self) -> str:
        """Prometheus-style text exposition of the current snapshot.

        Dots flatten to underscores; histograms render the summary series
        ``_count``/``_sum``/``_min``/``_max``.  Ends with a newline (the
        text-format convention).
        """
        lines: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            flat = name.replace(".", "_")
            if m.help:
                lines.append(f"# HELP {flat} {m.help}")
            if m.kind == "histogram":
                lines.append(f"# TYPE {flat} summary")
                lines.append(f"{flat}_count {m.count}")
                lines.append(f"{flat}_sum {m.total}")
                if m.count:
                    lines.append(f"{flat}_min {m.vmin}")
                    lines.append(f"{flat}_max {m.vmax}")
            else:
                lines.append(f"# TYPE {flat} {m.kind}")
                lines.append(f"{flat} {m.value}")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        """Drop every metric (test isolation)."""
        with self._lock:
            self._metrics.clear()


#: the process-default registry (the executors, the serving CLI)
DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return DEFAULT


class JsonlSink:
    """Append-only JSONL event log; usable directly as a tap handler.

    Each call appends one line.  Numpy scalars/arrays are converted to
    JSON-able python values; writes never raise (a full disk must not kill
    a run) — ``errors`` counts the drops instead.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self.written = 0
        self.errors = 0
        self._lock = threading.Lock()

    def __call__(self, event: dict) -> None:
        try:
            # allow_nan=False: drop (count) the event rather than emit
            # non-RFC JSON into a log other tooling will parse
            line = json.dumps({k: _jsonable(v) for k, v in event.items()},
                              allow_nan=False)
            with self._lock, open(self.path, "a") as f:
                f.write(line + "\n")
            self.written += 1
        except Exception:
            self.errors += 1


def _jsonable(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


class ProgressLine:
    """Periodic stderr progress line: rounds/sec and ETA.

    Drive it as a tap handler (it reads ``rounds_done`` from events) or
    host-side via :meth:`update`.  Lines are rewritten in place (``\\r``)
    at most every ``min_interval`` seconds; :meth:`close` ends the line.
    ``enabled=False`` (the ``--quiet`` path) makes every call a no-op.

    Out-of-order folding: async pipelined executors complete blocks out of
    order ACROSS rows (row 3's block 2 can land before row 0's block 1), so
    a single max-watermark over ``rounds_done`` would jump to the fastest
    row and report a finished-looking ETA while most rows still run.  Tap
    events are instead folded as a per-``row`` watermark — max
    ``rounds_done`` per row, immune to event reordering within a row — and
    the line reports the MEAN across rows seen, which matches the true
    per-row progress when rows advance together and degrades gracefully
    when they don't.  Host-side :meth:`update` (no row structure) keeps the
    plain single-watermark semantics.
    """

    def __init__(self, total: int | None = None, *, stream=None,
                 min_interval: float = 0.25, enabled: bool = True,
                 label: str = "progress"):
        self.total = total
        self.stream = stream if stream is not None else sys.stderr
        self.min_interval = float(min_interval)
        self.enabled = enabled
        self.label = label
        self.rounds_done = 0
        self.events = 0
        self._row_rounds: dict[int, int] = {}
        self._t0: float | None = None
        self._last_write = 0.0
        self._lock = threading.Lock()

    def __call__(self, event: dict) -> None:
        rd = event.get("rounds_done")
        if rd is None:
            return
        row = event.get("row")
        if row is None:
            self.update(int(np.asarray(rd)))
            return
        if not self.enabled:
            return
        now = time.perf_counter()
        with self._lock:
            row, rd = int(np.asarray(row)), int(np.asarray(rd))
            self._row_rounds[row] = max(self._row_rounds.get(row, 0), rd)
            self.rounds_done = int(
                sum(self._row_rounds.values()) / len(self._row_rounds)
            )
            if not self._tick(now):
                return
            line = self._render(now)
        self._write(line)

    def update(self, rounds_done: int) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        with self._lock:
            self.rounds_done = max(self.rounds_done, int(rounds_done))
            if not self._tick(now):
                return
            line = self._render(now)
        self._write(line)

    def _tick(self, now: float) -> bool:
        """Event bookkeeping under the lock; True when a line is due."""
        self.events += 1
        if self._t0 is None:
            self._t0 = now
        if now - self._last_write < self.min_interval:
            return False
        self._last_write = now
        return True

    def _write(self, line: str) -> None:
        try:
            self.stream.write("\r" + line)
            self.stream.flush()
        except Exception:
            pass

    def _render(self, now: float) -> str:
        elapsed = max(now - (self._t0 or now), 1e-9)
        rate = self.rounds_done / elapsed
        msg = f"[{self.label}] {self.rounds_done} rounds, {rate:.0f} rounds/s"
        if self.total:
            remaining = max(self.total - self.rounds_done, 0)
            eta = remaining / rate if rate > 0 else float("inf")
            msg += f", ETA {eta:.1f}s ({self.rounds_done}/{self.total})"
        return msg

    def close(self) -> None:
        if not self.enabled or self._t0 is None:
            return
        try:
            self.stream.write("\r" + self._render(time.perf_counter()) + "\n")
            self.stream.flush()
        except Exception:
            pass


def tap_to_registry(registry: MetricsRegistry | None = None):
    """A tap handler that folds every event into ``registry``.

    Per engine (ids sanitized dot->underscore to stay one name segment):
    ``tap.<engine>.events`` counter, ``tap.<engine>.rounds_done`` gauge
    (max so far), scalar numeric streams as gauges
    (``tap.<engine>.<stream>``), and ``tap.<engine>.block_seconds`` — a
    histogram of inter-event host-time deltas, the block wall-clock
    attribution alongside the ``phase`` spans.
    """
    reg = registry or DEFAULT
    last_time: dict[str, float] = {}
    lock = threading.Lock()

    def handler(event: dict) -> None:
        engine = str(event.get("engine", "unknown")).replace(".", "_")
        prefix = f"tap.{engine}"
        reg.counter(f"{prefix}.events")
        rd = event.get("rounds_done")
        if rd is not None:
            prev = 0.0
            try:
                prev = reg.get(f"{prefix}.rounds_done")["value"]
            except KeyError:
                pass
            reg.gauge(f"{prefix}.rounds_done",
                      max(prev, float(np.asarray(rd))))
        for k, v in event.items():
            if k in ("engine", "host_time", "rounds_done"):
                continue
            a = np.asarray(v)
            if a.ndim == 0 and np.issubdtype(a.dtype, np.number):
                reg.gauge(f"{prefix}.{k}", float(a))
        ht = event.get("host_time")
        if ht is not None:
            with lock:
                prev_t = last_time.get(engine)
                last_time[engine] = float(ht)
            if prev_t is not None and float(ht) > prev_t:
                reg.histogram(f"{prefix}.block_seconds", float(ht) - prev_t)

    return handler


@contextlib.contextmanager
def timed(name: str, registry: MetricsRegistry | None = None) -> Iterator[None]:
    """Observe the block's wall-clock into histogram ``<name>.seconds``.

    The host-side phase-attribution hook: ``with timed("phase.sweeps_run_group")``
    around an engine call records its wall-clock next to the compile counters
    (see ``repro_torch.sweeps.executor``).
    """
    reg = registry or DEFAULT
    t0 = time.perf_counter()
    try:
        yield
    finally:
        reg.histogram(f"{name}.seconds", time.perf_counter() - t0)


def record_compile(family: str, compiles: int, seconds: float,
                   registry: MetricsRegistry | None = None) -> None:
    """Attribute a call's compile events + wall-clock to ``family``.

    Called by the executors around their group entry points: the compile
    counter delta goes to ``compile.<family>.events`` and — only when the
    call actually compiled — the wall-clock to ``compile.<family>.seconds``
    (warm calls land in ``phase.<family>.seconds`` via :func:`timed`).
    """
    reg = registry or DEFAULT
    fam = family.replace(".", "_")
    if compiles > 0:
        reg.counter(f"compile.{fam}.events", compiles)
        reg.histogram(f"compile.{fam}.seconds", seconds)
