"""Benchmark history: an append-only trajectory behind every manifest.

``BENCH_*.json`` files are single snapshots: the softgate can only diff
against the ONE committed baseline (``git show HEAD:``), so a slow
regression spread over several PRs — each within tolerance of its
immediate predecessor — is invisible.  This module turns the baseline
into a trajectory:

  * every :func:`repro_torch.sweeps.results.write_manifest` call appends a
    compact, provenance-stamped record to ``BENCH_history.jsonl``
    (co-located with the manifest; ``REPRO_BENCH_HISTORY`` overrides the
    path, which is how tests and CI redirect it);
  * :func:`trend_report` computes per-(bench, metric) time series across
    the history and flags robust changepoints: the median of the
    ``recent`` newest points is compared against a
    median ± max(tolerance·|median|, z·1.4826·MAD) envelope of the older
    committed points — single noisy runs cannot move the reference, and
    the detector needs several points before it says anything;
  * the records keep the JAX package's format (its provenance subset
    names ``torch`` where that one names ``jax``), so the JAX package's
    ``benchmarks/run.py --check`` gate reads a port history as it reads
    its own.

Only PERF-ish metrics are trended (``*_per_sec``, ``speedup_*``,
``*_s`` wall-clocks, ``us_per_*`` latencies — see :func:`metric_direction`);
deterministic result metrics are snapshot-diffed by the softgate already
and would only add noise here.

Append/read never raise (the ``repro_torch.obs`` convention): a read-only
checkout or a full disk degrades to an empty history, not a dead bench.
A copy of the JAX package's module; only the provenance subset differs.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Any, Iterable

HISTORY_ENV = "REPRO_BENCH_HISTORY"
HISTORY_BASENAME = "BENCH_history.jsonl"

SCHEMA_VERSION = 1

# keys every history record must carry (the hygiene test's contract)
RECORD_KEYS = ("schema", "bench", "manifest", "written_at", "provenance",
               "metrics", "warnings")

# provenance fields carried per record (a compact subset of the full stamp)
_PROV_KEYS = ("git_sha", "git_dirty", "torch", "backend", "device", "timestamp")

# robust-envelope constant: 1.4826 * MAD estimates sigma for normal data
_MAD_TO_SIGMA = 1.4826


def history_path(manifest_path: str | os.PathLike) -> str:
    """Where the history lives for a manifest at ``manifest_path``.

    Default: ``BENCH_history.jsonl`` next to the manifest (so repo-root
    manifests share the committed history and tmp-dir test manifests write
    to tmp).  ``REPRO_BENCH_HISTORY`` overrides everything — the hook CI
    and tests use to redirect or doctor the trajectory.
    """
    env = os.environ.get(HISTORY_ENV)
    if env:
        return env
    return os.path.join(
        os.path.dirname(os.path.abspath(os.fspath(manifest_path))),
        HISTORY_BASENAME,
    )


def record_from_manifest(
    manifest_path: str | os.PathLike, doc: dict[str, Any]
) -> dict[str, Any]:
    """The compact history record for one just-written manifest.

    ``metrics`` keeps every numeric non-bool TOP-LEVEL field of the
    manifest (its flat summary surface); per-row results
    stay in the manifest — history is a trajectory of summaries, not a
    second copy of the data.
    """
    prov = doc.get("provenance") or {}
    metrics = {
        k: float(v) for k, v in doc.items()
        if isinstance(v, (int, float)) and not isinstance(v, bool)
    }
    return {
        "schema": SCHEMA_VERSION,
        "bench": doc.get("bench"),
        "manifest": os.path.basename(os.fspath(manifest_path)),
        "written_at": float(time.time()),
        "provenance": {k: prov.get(k) for k in _PROV_KEYS},
        "metrics": metrics,
        "warnings": len(doc.get("warnings") or []),
    }


def append_record(path: str | os.PathLike, record: dict[str, Any]) -> bool:
    """Append one record (one JSON line); False (never an exception) on
    failure — history must never be the reason a manifest write dies."""
    try:
        line = json.dumps(record, allow_nan=False)
        with open(path, "a") as f:
            f.write(line + "\n")
        return True
    except Exception:
        return False


def read_history(path: str | os.PathLike) -> list[dict[str, Any]]:
    """Every well-formed record at ``path``, in file order.

    Malformed lines are skipped (a torn concurrent append must not poison
    the whole trajectory); a missing file is an empty history.
    """
    records: list[dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and rec.get("bench"):
                    records.append(rec)
    except OSError:
        pass
    return records


def valid_record(rec: dict[str, Any]) -> bool:
    """Does ``rec`` carry the full history-record schema?"""
    return (
        all(k in rec for k in RECORD_KEYS)
        and isinstance(rec.get("metrics"), dict)
        and isinstance(rec.get("provenance"), dict)
        and all(k in rec["provenance"] for k in _PROV_KEYS)
    )


def metric_direction(metric: str) -> str | None:
    """Which way is better for ``metric``: "higher", "lower", or None.

    None means "not trended": deterministic result metrics (counts, flags,
    thresholds) are the softgate's job; only perf-ish metrics carry
    machine-noise trajectories worth a robust envelope.
    """
    m = metric.lower()
    if "per_sec" in m or m.startswith("speedup"):
        return "higher"
    if m.endswith(("_s", "_seconds")) or "us_per" in m or m.endswith("_us"):
        return "lower"
    return None


def _series(records: Iterable[dict[str, Any]]) -> dict[str, dict[str, list[float]]]:
    """{bench: {metric: [values in history order]}} for trended metrics."""
    out: dict[str, dict[str, list[float]]] = {}
    for rec in records:
        bench = rec.get("bench")
        metrics = rec.get("metrics")
        if not bench or not isinstance(metrics, dict):
            continue
        for k, v in metrics.items():
            if metric_direction(k) is None:
                continue
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out.setdefault(bench, {}).setdefault(k, []).append(float(v))
    return out


def trend_report(
    records: list[dict[str, Any]],
    *,
    recent: int = 2,
    tolerance: float = 0.30,
    z: float = 3.0,
    min_points: int = 5,
) -> dict[str, Any]:
    """Per-metric trajectories + robust slowdown/changepoint records.

    For each (bench, metric) series with at least ``min_points`` points:
    baseline = the points BEFORE the ``recent`` newest; the envelope half-
    width is ``max(tolerance * |median|, z * 1.4826 * MAD)``; a regression
    record (kind="trend", severity="hard") fires when the median of the
    recent points leaves the envelope on the WORSE side for the metric's
    direction.  Improvements are reported as severity="info" (visible, not
    gating).  Returns ``{"entries", "benches", "series", "regressions"}``
    — ``regressions`` is what a trend gate reads.
    """
    if recent < 1:
        raise ValueError(f"recent must be >= 1, got {recent}")
    if min_points < recent + 2:
        raise ValueError(
            f"min_points must be >= recent + 2 (a baseline needs >= 2 "
            f"points), got {min_points} with recent={recent}"
        )
    series = _series(records)
    regressions: list[dict[str, Any]] = []
    summary: dict[str, Any] = {}
    for bench, metrics in sorted(series.items()):
        bench_summary = {}
        for metric, values in sorted(metrics.items()):
            info: dict[str, Any] = {"points": len(values), "last": values[-1]}
            if len(values) >= min_points:
                base = values[:-recent]
                med = statistics.median(base)
                mad = statistics.median(abs(v - med) for v in base)
                half = max(tolerance * abs(med), z * _MAD_TO_SIGMA * mad)
                recent_med = statistics.median(values[-recent:])
                info.update(baseline_median=med, envelope=half,
                            recent_median=recent_med)
                direction = metric_direction(metric)
                worse = (recent_med > med + half if direction == "lower"
                         else recent_med < med - half)
                better = (recent_med < med - half if direction == "lower"
                          else recent_med > med + half)
                if worse or better:
                    regressions.append({
                        "kind": "trend",
                        "severity": "hard" if worse else "info",
                        "bench": bench,
                        "metric": metric,
                        "value": recent_med,
                        "baseline": med,
                        "envelope": half,
                        "direction": direction,
                        "points": len(values),
                        "message": (
                            f"{bench} {metric} trend "
                            f"{'regressed' if worse else 'improved'}: "
                            f"median of last {recent} runs {recent_med:.4g} "
                            f"vs committed envelope {med:.4g} ± {half:.4g} "
                            f"over {len(base)} runs"
                        ),
                    })
            bench_summary[metric] = info
        summary[bench] = bench_summary
    return {
        "entries": len(records),
        "benches": sorted(series),
        "series": summary,
        "regressions": regressions,
    }


def hard_regressions(report: dict[str, Any]) -> list[dict[str, Any]]:
    """The gating subset of a :func:`trend_report`'s regression records."""
    return [r for r in report.get("regressions", [])
            if r.get("severity") == "hard"]
