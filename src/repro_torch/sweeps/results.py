"""Results layer: per-scenario throughputs, baseline ratios, CIs, regret, manifests.

Takes the (B, rounds, S) success arrays the executor produces per group and
folds them back onto scenarios: mean timely throughput per strategy
(averaged over Monte-Carlo repeats), the ratio against the scenario's
baseline strategy (the paper's headline LEA/static numbers), and a 95%
confidence interval — across repeats when ``seeds > 1``, else the per-round
Bernoulli normal approximation (rounds are not independent under a mixing
chain, so the single-seed CI is a lower bound on the true width).

Regret axis: whenever a scenario's strategies include the genie
``"oracle"``, every other strategy also gets its final cumulative
timely-throughput regret vs the oracle (:mod:`repro_torch.policies.regret`)
as ``regret_<strategy>`` columns plus paired 95% CIs (``regret_ci95_<s>``).

:func:`manifest` renders results as a JSON document in the ``BENCH_*.json``
shape (a ``bench`` name, run metadata, a flat ``results`` list) stamped
with the run's provenance (:func:`repro_torch.obs.provenance`) and a
``warnings`` list; :func:`write_manifest` writes it where the caller says
and appends a history record beside it (``REPRO_BENCH_HISTORY``
redirects the record).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Sequence

import numpy as np

from repro_torch.core.throughput import float32_mean
from repro_torch.obs import history as _history
from repro_torch.obs.provenance import provenance as _provenance_fn
from repro_torch.policies import regret as regret_mod

from .registry import Scenario, SweepGroup

_Z95 = 1.959963984540054  # two-sided 95% normal quantile


@dataclasses.dataclass(frozen=True)
class ScenarioResult:
    """Aggregated Monte-Carlo outcome for one scenario."""

    scenario: Scenario
    seeds: int
    throughput: dict[str, float]             # strategy -> mean R(d, eta)
    per_seed: dict[str, tuple[float, ...]]   # strategy -> per-repeat R
    ci95: dict[str, tuple[float, float]]     # strategy -> (lo, hi)
    ratio: dict[str, float]                  # strategy -> R_s / R_baseline
    # strategy -> mean final cumulative regret vs the oracle (empty when the
    # scenario does not simulate the oracle)
    regret: dict[str, float] = dataclasses.field(default_factory=dict)
    # strategy -> paired 95% CI on the mean final regret (same keys as regret)
    regret_ci95: dict[str, tuple[float, float]] = dataclasses.field(
        default_factory=dict
    )

    @property
    def name(self) -> str:
        return self.scenario.name

    @property
    def baseline_ratio(self) -> float:
        """The headline number: best non-baseline strategy vs the baseline."""
        others = [r for s, r in self.ratio.items() if s != self.scenario.baseline]
        return max(others) if others else 1.0

    def row(self) -> dict[str, Any]:
        """Flat JSON-able record for manifests.

        Non-finite ratios (a baseline that never succeeds) become ``None`` —
        ``json.dump`` would otherwise emit the literal ``Infinity``, which is
        not valid JSON (RFC 8259) and breaks non-Python consumers.
        """
        return {
            "scenario": self.scenario.name,
            "family": self.scenario.family,
            "rounds": self.scenario.rounds,
            "seeds": self.seeds,
            "kstar": self.scenario.lp.kstar,
            "n": self.scenario.lp.n,
            "baseline": self.scenario.baseline,
            "meta": self.scenario.meta_dict(),
            **{f"R_{s}": v for s, v in self.throughput.items()},
            **{f"ci95_{s}": list(v) for s, v in self.ci95.items()},
            **{
                f"ratio_{s}": (v if math.isfinite(v) else None)
                for s, v in self.ratio.items()
                if s != self.scenario.baseline
            },
            **{f"regret_{s}": v for s, v in self.regret.items()},
            **{f"regret_ci95_{s}": list(v) for s, v in self.regret_ci95.items()},
        }


def _half_across_seeds(per_seed: np.ndarray) -> float:
    """z * s / sqrt(n): the across-repeats half-width both CIs share."""
    return _Z95 * float(per_seed.std(ddof=1)) / math.sqrt(per_seed.size)


def _ci95(per_seed: np.ndarray, rounds: int) -> tuple[float, float]:
    """95% CI of the mean throughput (see module docstring)."""
    m = float(per_seed.mean())
    if per_seed.size > 1:
        half = _half_across_seeds(per_seed)
    else:
        half = _Z95 * math.sqrt(max(m * (1.0 - m), 0.0) / max(rounds, 1))
    return (max(m - half, 0.0), min(m + half, 1.0))


def _regret_ci95(
    finals: np.ndarray, per_round: np.ndarray | None
) -> tuple[float, float]:
    """Paired 95% CI of the mean final cumulative regret.

    ``finals`` is the (seeds,) per-repeat final regret, ``per_round`` the
    (1, rounds) paired per-round differences it sums (only materialised —
    and only needed — for single-seed runs).  With repeats the CI is the
    usual normal interval across seeds (the same machinery as the
    throughput :func:`_ci95`); a single seed falls back to the CLT width of
    the summed per-round differences, z * s_diff * sqrt(rounds) — paired
    per-round variation, with the same serial-correlation caveat as the
    single-seed throughput CI.  Regret is unbounded, so no clamping.
    """
    m = float(finals.mean())
    if finals.size > 1:
        half = _half_across_seeds(finals)
    else:
        rounds = per_round.shape[-1]
        sd = float(per_round[0].std(ddof=1)) if rounds > 1 else 0.0
        half = _Z95 * sd * math.sqrt(rounds)
    return (m - half, m + half)


def summarize_group(group: SweepGroup, succ: np.ndarray) -> list[ScenarioResult]:
    """Fold one group's (B, rounds, S) successes onto its scenarios."""
    b = len(group.rows)
    if succ.shape[0] != b:
        raise ValueError(f"expected {b} result rows, got {succ.shape[0]}")
    # per-row throughput as the engine reduces it (throughput.timely_throughput:
    # exact counts below 2^24 rounds times the float32 reciprocal of the round
    # count — the JAX package's bits)
    counts = np.asarray(succ).sum(axis=1)                        # (B, S)
    per_round = float32_mean(counts, succ.shape[1]).astype(np.float64)
    results = []
    has_oracle = regret_mod.REFERENCE in group.strategies
    for si, sc in enumerate(group.scenarios):
        rows = [ri for ri, rm in enumerate(group.rows) if rm.scenario_index == si]
        seed_tp = per_round[rows]                            # (seeds, S)
        throughput, per_seed, ci95 = {}, {}, {}
        for j, strat in enumerate(group.strategies):
            vals = seed_tp[:, j]
            throughput[strat] = float(vals.mean())
            per_seed[strat] = tuple(float(v) for v in vals)
            ci95[strat] = _ci95(vals, group.rounds)
        base = throughput[sc.baseline]
        ratio = {
            s: (throughput[s] / base if base > 0 else float("inf"))
            for s in group.strategies
        }
        regret: dict[str, float] = {}
        regret_ci95: dict[str, tuple[float, float]] = {}
        if has_oracle:
            # (seeds, rounds, S) -> per-strategy mean final cumulative regret
            # plus a paired 95% CI from the same per-seed finals
            finals = regret_mod.final_regret(succ[rows], group.strategies)
            for s, v in finals.items():
                if s == regret_mod.REFERENCE:
                    continue
                regret[s] = float(v.mean())
                # the (seeds, rounds) diffs are only consumed by the
                # single-seed CLT fallback; across-seeds CIs never touch them
                diffs = None
                if v.size == 1:
                    diffs = np.asarray(
                        regret_mod.per_round_regret(succ[rows], group.strategies, s),
                        np.float64,
                    )                                    # (1, rounds)
                regret_ci95[s] = _regret_ci95(np.asarray(v, np.float64), diffs)
        results.append(ScenarioResult(
            scenario=sc, seeds=seed_tp.shape[0], throughput=throughput,
            per_seed=per_seed, ci95=ci95, ratio=ratio, regret=regret,
            regret_ci95=regret_ci95,
        ))
    return results


def summarize(
    groups: Sequence[SweepGroup],
    succs: Sequence[np.ndarray],
    *,
    scenario_order: Sequence[Scenario] | None = None,
) -> list[ScenarioResult]:
    """Fold every group; optionally reorder to the original expansion order."""
    results: list[ScenarioResult] = []
    for group, succ in zip(groups, succs):
        results.extend(summarize_group(group, succ))
    if scenario_order is not None:
        # key on the scenario VALUE, not its name: distinct scenarios may
        # share a name across concatenated expansions (e.g. the same family
        # expanded twice with different rounds), and names must not alias
        by_scenario = {r.scenario: r for r in results}
        results = [by_scenario[sc] for sc in scenario_order]
    return results


def manifest(
    results: Sequence[ScenarioResult],
    *,
    bench: str,
    extra: dict[str, Any] | None = None,
    timestamp: float | None = None,
    device=None,
) -> dict[str, Any]:
    """BENCH_*.json-shaped document: bench name, metadata, flat result rows.

    Every manifest is stamped with run ``provenance`` (git sha + dirty
    flag, torch / CUDA versions, backend, the card's name and power limit;
    ``device`` is the device the results came from) and a ``warnings``
    list (``extra`` may supply it).  ``timestamp`` is passed through to
    the provenance record — ``time.time()`` when the caller does not care
    about determinism.
    """
    doc: dict[str, Any] = {
        "bench": bench,
        "scenarios": len(results),
        "families": sorted({r.scenario.family for r in results}),
        "results": [r.row() for r in results],
    }
    if extra:
        doc.update(extra)
    doc.setdefault("warnings", [])
    doc.setdefault(
        "provenance",
        _provenance_fn(time.time() if timestamp is None else timestamp, device=device),
    )
    return doc


def write_manifest(path: str | os.PathLike, doc: dict[str, Any]) -> None:
    """Write a manifest (RFC-8259 strict JSON, trailing newline).

    The provenance / warnings stamps are backstopped here too, so a
    document assembled by hand still carries them.  Every write also
    appends a compact history record to ``BENCH_history.jsonl`` next to
    the manifest — ``REPRO_BENCH_HISTORY`` redirects it (see
    :mod:`repro_torch.obs.history`; tests and ``chip_smoke.py`` point it
    at a temporary file).  The append never raises.
    """
    doc.setdefault("warnings", [])
    doc.setdefault("provenance", _provenance_fn(time.time()))
    with open(path, "w") as f:
        # allow_nan=False: fail loudly rather than emit non-RFC JSON
        json.dump(doc, f, indent=2, allow_nan=False)
        f.write("\n")
    _history.append_record(
        _history.history_path(path), _history.record_from_manifest(path, doc)
    )
