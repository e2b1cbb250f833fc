"""Telemetry frames + host-side exporters (tables, Chrome traces).

The engines return these NamedTuples of tensors beside their primary
outputs when called with ``telemetry=True``, computed from the same
tensors (so the primary outputs are bit-identical either way):

  * :class:`TelemetryFrame`   — :func:`repro_torch.core.throughput
    .simulate_strategies_pool` (and ``sweep_pool`` / the sweeps executor
    with a leading batch axis): per-round estimator error vs. the genie's
    true p_good, allocator prefix sizes, allocated-load totals, received
    evaluations, feasibility;
  * :class:`FaultTelemetry`   — :func:`repro_torch.faults.engine
    .sweep_faults`: per-round fault-event counts (preempted workers,
    dropped packets) and the binding per-packet received counts of both
    decode modes;
  * :class:`ServingTelemetry` — :func:`repro_torch.serving.engine
    .sweep_serving`: per-round arrivals, queue occupancy and admission
    decisions.

Field names, dtypes and axes are the JAX package's.  Axis convention:
``M`` = rounds, ``S`` = strategies (request order), ``A`` = allocator
(policy) strategies only, in
:func:`repro_torch.core.throughput.allocator_strategies` order.  Batched
sweeps prepend a ``(B,)`` axis to every leaf; the exporters below take ONE
row — select it with ``type(frame)(*(x[i] for x in frame))``.

Exporters (on numpy copies of the leaves; the same dicts and JSON as the
JAX package's):

  * :func:`metric_streams` / :func:`metric_table` — flat metric names
    (``"est_err/lea"``) to per-round vectors / summary rows;
  * :func:`serving_trace` — a serving run as Chrome trace-event JSON
    (one process per strategy, one thread per queue slot, one complete
    event per request residency), viewable in Perfetto or
    ``chrome://tracing``.  Timestamps are DETERMINISTIC (round index x
    ``round_us``), so the trace is a committable artifact;
  * :func:`validate_trace` — structural validation + disposition counts
    (the conservation side of the exporter round-trip tests).
"""

from __future__ import annotations

import json
import os
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

# mirrors repro_torch.serving.engine EVENT_* (kept literal: obs must not
# import the engines; the tests cross-check the two stay in sync)
_EVENT_NAMES = {1: "on_time", 2: "late", 3: "expired"}


class TelemetryFrame(NamedTuple):
    """Offline-engine telemetry, one leaf per stream (axes: see module doc).

    ``est_err`` (M, A) float32  — mean |predicted - true| p_good per policy
    (the genie's one-step conditional is the truth; the ``oracle`` policy's
    column is exactly zero);
    ``prefix_size`` (M, A) int32 — the allocator's chosen prefix i* per
    policy (how many workers receive load);
    ``load_total`` (M, S) int32 — total allocated load per strategy;
    ``received`` (M, S) int32   — on-time evaluations received;
    ``feasible`` (M, S) bool    — the engine's explicit feasibility flag.
    """

    est_err: Any
    prefix_size: Any
    load_total: Any
    received: Any
    feasible: Any


class FaultTelemetry(NamedTuple):
    """Fault-engine telemetry (axes: see module doc).

    ``preempted`` (M,) int32   — workers whose compute window was cut short
    (``t_cut < deadline``) this round;
    ``packets_lost`` (M,) int32 — packet deliveries erased by the channel;
    ``received_aon`` / ``received_conserve`` (M, S) int32 — the BINDING
    (min-over-packet-index) received count per decode mode — the margin to
    K* that decides full decode.
    """

    preempted: Any
    packets_lost: Any
    received_aon: Any
    received_conserve: Any


class ServingTelemetry(NamedTuple):
    """Serving-engine telemetry (axes: see module doc; Q = queue slots).

    ``arrivals_t`` (M,) int32 — requests arriving each round (shared across
    strategies: one arrival stream per simulation);
    ``occupancy`` (S, M) int32 — queue slots still occupied AFTER the
    round's departures;
    ``admitted_t`` / ``rejected_t`` (S, M) int32 — the round's admission
    decisions (``admitted_t + rejected_t == arrivals_t`` pointwise —
    conservation, property-tested).
    """

    arrivals_t: Any
    occupancy: Any
    admitted_t: Any
    rejected_t: Any


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _strategy_names(n: int, names: Sequence[str] | None, kind: str) -> list[str]:
    if names is None:
        return [f"{kind}{j}" for j in range(n)]
    if len(names) != n:
        raise ValueError(
            f"{kind} axis has {n} columns but {len(names)} names: {names!r}"
        )
    return list(names)


def metric_streams(
    frame: TelemetryFrame | FaultTelemetry | ServingTelemetry,
    *,
    strategies: Sequence[str] | None = None,
    alloc_strategies: Sequence[str] | None = None,
) -> dict[str, np.ndarray]:
    """Flatten ONE frame (no batch axis) to ``{"stream/strategy": (M,)}``.

    Strategy-resolved leaves fan out per column (``"est_err/lea"``);
    per-round scalars keep their leaf name (``"preempted"``).  ``frame``
    may be any of the three telemetry classes; pass the matching name
    lists to label columns (defaults to positional ``s0``/``a0`` labels).
    """
    per_alloc = {"est_err", "prefix_size"}
    strategy_major = {"occupancy", "admitted_t", "rejected_t"}
    out: dict[str, np.ndarray] = {}
    for name, leaf in frame._asdict().items():
        arr = _np(leaf)
        if arr.ndim == 1:
            out[name] = arr
            continue
        if arr.ndim != 2:
            raise ValueError(
                f"leaf {name!r} has rank {arr.ndim}; exporters take ONE "
                "frame — select a batch row first (type(frame)(*(x[i] for "
                "x in frame)))"
            )
        if name in strategy_major:
            arr = arr.T                               # (S, M) -> (M, S)
        names = _strategy_names(
            arr.shape[1],
            alloc_strategies if name in per_alloc else strategies,
            "a" if name in per_alloc else "s",
        )
        for j, s in enumerate(names):
            out[f"{name}/{s}"] = arr[:, j]
    return out


def metric_table(
    frame,
    *,
    strategies: Sequence[str] | None = None,
    alloc_strategies: Sequence[str] | None = None,
) -> list[dict[str, Any]]:
    """Summary rows (one per stream): mean / min / max / final value.

    The flat-table shape ``obs_report`` embeds in ``BENCH_obs.json`` —
    floats only, JSON-safe.
    """
    rows = []
    for name, vec in metric_streams(
        frame, strategies=strategies, alloc_strategies=alloc_strategies
    ).items():
        v = vec.astype(np.float64)
        rows.append({
            "metric": name,
            "rounds": int(v.size),
            "mean": float(v.mean()) if v.size else 0.0,
            "min": float(v.min()) if v.size else 0.0,
            "max": float(v.max()) if v.size else 0.0,
            "last": float(v[-1]) if v.size else 0.0,
        })
    return rows


def serving_trace(
    events,
    sojourn,
    *,
    strategies: Sequence[str] | None = None,
    telemetry: ServingTelemetry | None = None,
    round_us: float = 1000.0,
) -> dict[str, Any]:
    """One serving run as a Chrome trace-event document.

    ``events`` / ``sojourn`` are the (S, M, Q) per-slot streams of ONE
    :class:`repro_torch.serving.engine.ServingOutcomes` row.  Each request
    residency becomes a complete ("X") event on (pid=strategy,
    tid=queue slot) spanning its sojourn, named by its disposition;
    with ``telemetry`` the queue-occupancy stream rides along as counter
    ("C") events.  Timestamps are round-deterministic (``round_us``
    microseconds per engine round), so identical runs produce identical
    traces.
    """
    ev = _np(events)
    so = _np(sojourn)
    if ev.ndim != 3 or ev.shape != so.shape:
        raise ValueError(
            f"expected matching (S, rounds, Q) events/sojourn, got "
            f"{ev.shape} / {so.shape}"
        )
    n_s, rounds, q = ev.shape
    names = _strategy_names(n_s, strategies, "s")
    out: list[dict[str, Any]] = []
    for s in range(n_s):
        out.append({
            "name": "process_name", "ph": "M", "pid": s, "tid": 0,
            "args": {"name": f"strategy:{names[s]}"},
        })
        for slot in range(q):
            out.append({
                "name": "thread_name", "ph": "M", "pid": s, "tid": slot,
                "args": {"name": f"slot{slot}"},
            })
        for t, slot in zip(*np.nonzero(ev[s])):
            code = int(ev[s, t, slot])
            dur = max(int(so[s, t, slot]), 1)
            out.append({
                "name": _EVENT_NAMES.get(code, f"event{code}"),
                "ph": "X", "pid": s, "tid": int(slot),
                "ts": float((int(t) - dur + 1) * round_us),
                "dur": float(dur * round_us),
                "args": {"round": int(t), "sojourn_rounds": dur,
                         "disposition": _EVENT_NAMES.get(code, str(code))},
            })
        if telemetry is not None:
            occ = _np(telemetry.occupancy)[s]
            for t in range(min(rounds, occ.shape[0])):
                out.append({
                    "name": "queue_occupancy", "ph": "C", "pid": s, "tid": 0,
                    "ts": float(t * round_us),
                    "args": {"occupied": int(occ[t])},
                })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def validate_trace(doc: dict[str, Any]) -> dict[str, Any]:
    """Structurally validate a trace document; returns disposition counts.

    Raises ``ValueError`` on malformation; on success returns
    ``{"events", "complete", "dispositions": {name: count}}`` — the counts
    the conservation tests reconcile against ``ServingOutcomes``.
    """
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        raise ValueError("trace document must be a dict with a traceEvents list")
    dispositions: dict[str, int] = {}
    complete = 0
    for i, e in enumerate(doc["traceEvents"]):
        for k in ("name", "ph", "pid", "tid"):
            if k not in e:
                raise ValueError(f"traceEvents[{i}] missing {k!r}: {e!r}")
        if e["ph"] == "X":
            if "ts" not in e or "dur" not in e or e["dur"] <= 0:
                raise ValueError(f"traceEvents[{i}] malformed X event: {e!r}")
            complete += 1
            d = e.get("args", {}).get("disposition", e["name"])
            dispositions[d] = dispositions.get(d, 0) + 1
        elif e["ph"] not in ("M", "C", "B", "E", "i"):
            raise ValueError(f"traceEvents[{i}] unknown phase {e['ph']!r}")
    json.dumps(doc, allow_nan=False)     # must round-trip as strict JSON
    return {"events": len(doc["traceEvents"]), "complete": complete,
            "dispositions": dispositions}


def write_trace(path: str | os.PathLike, doc: dict[str, Any]) -> None:
    """Validate + write a trace document (strict JSON, trailing newline)."""
    validate_trace(doc)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, allow_nan=False)
        f.write("\n")
