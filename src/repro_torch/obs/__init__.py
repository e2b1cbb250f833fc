"""repro_torch.obs — observability: telemetry streams, taps, provenance, profiling.

The engines (:mod:`repro_torch.core.throughput`, :mod:`repro_torch.faults.engine`,
:mod:`repro_torch.serving.engine`) take an optional ``telemetry=`` flag that
returns extra per-round streams computed from the same tensors as their
primary outputs — estimator error vs. the genie's true p_good,
allocated-load totals, allocator prefix sizes, queue occupancy, admission
decisions, fault-event counts — and a ``tap=`` flag that delivers block
aggregates to host handlers during the run.  With both off (the default)
an engine runs its pre-existing code path; with either on its primary
outputs stay bit-identical.  This package owns everything on top:

  * :mod:`~repro_torch.obs.counters`   — compile events (the port's are
    ``nvcc`` runs of its kernel sources) behind
    ``sweeps.compile_cache_size`` / ``faults.fault_compile_cache_size`` /
    ``serving.serving_compile_cache_size``, persistent-cache hits
    (libraries loaded already built), and every kernel wrapper's launch
    count in one place;
  * :mod:`~repro_torch.obs.telemetry`  — :class:`TelemetryFrame` /
    :class:`FaultTelemetry` / :class:`ServingTelemetry` NamedTuples of
    tensors plus host-side exporters: flat metric tables
    (:func:`metric_streams`, :func:`metric_table`) and Chrome trace-event
    JSON (:func:`serving_trace`);
  * :mod:`~repro_torch.obs.provenance` — :func:`provenance`: git sha +
    dirty flag, torch / CUDA versions, backend, the card's name and power
    limit, caller-supplied timestamp — stamped into every manifest by
    :func:`repro_torch.sweeps.results.write_manifest`;
  * :mod:`~repro_torch.obs.profiling`  — ``record_function`` + NVTX phase
    spans inside the engines (``ENGINE_PHASES``: lift -> trajectory ->
    policy replay -> allocate -> static loads -> score -> channel ->
    decode -> fetch) and a ``REPRO_PROFILE=<dir>``-gated
    ``torch.profiler`` trace context manager;
  * :mod:`~repro_torch.obs.taps`       — the ``tap=`` flag's host side:
    handler registry (:func:`add_tap` / :func:`capture_taps`), event
    schema validation;
  * :mod:`~repro_torch.obs.metrics`    — host metrics registry (named
    counters / gauges / histograms) with JSONL, Prometheus-exposition and
    stderr progress-line sinks, plus per-phase wall-clock and compile
    attribution (:func:`timed`, :func:`record_compile`);
  * :mod:`~repro_torch.obs.history`    — ``BENCH_history.jsonl``: every
    :func:`~repro_torch.sweeps.results.write_manifest` appends a compact
    provenance-stamped record, and :func:`trend_report` flags robust
    slowdowns across the trajectory.

The public names are the JAX package's ``repro.obs`` names but
``annotate``, which the port does not have.  The
persistent compile cache is the kernel library directory
(:mod:`repro_torch.launch.cache` moves it); :func:`counters.persistent_cache_hits`
counts libraries found already built plus the hits noted by
``counters.note_persistent_cache_hits``.  This package imports ``torch``,
``numpy`` and the standard library only.
"""

from .counters import compile_events, counter_names, register_compiled
from .history import (HISTORY_BASENAME, HISTORY_ENV, append_record,
                      history_path, read_history, record_from_manifest,
                      trend_report)
from .metrics import (DEFAULT as default_metrics, JsonlSink, MetricsRegistry,
                      ProgressLine, record_compile, tap_to_registry, timed)
from .profiling import PROFILE_ENV, phase, profile_dir, profile_trace
from .provenance import provenance
from .taps import (EVENT_STREAMS, TAP_ENGINES, add_tap, capture_taps,
                   remove_tap, tap_names, validate_event)
from .telemetry import (FaultTelemetry, ServingTelemetry, TelemetryFrame,
                        metric_streams, metric_table, serving_trace,
                        validate_trace, write_trace)

__all__ = [
    "EVENT_STREAMS", "FaultTelemetry", "HISTORY_BASENAME", "HISTORY_ENV",
    "JsonlSink", "MetricsRegistry", "PROFILE_ENV", "ProgressLine",
    "ServingTelemetry", "TAP_ENGINES", "TelemetryFrame", "add_tap",
    "append_record", "capture_taps", "compile_events",
    "counter_names", "default_metrics", "history_path", "metric_streams",
    "metric_table", "phase", "profile_dir", "profile_trace", "provenance",
    "read_history", "record_compile", "record_from_manifest",
    "register_compiled", "remove_tap", "serving_trace", "tap_names",
    "tap_to_registry", "timed", "trend_report", "validate_event",
    "validate_trace", "write_trace",
]
