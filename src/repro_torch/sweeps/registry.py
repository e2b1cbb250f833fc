"""Scenario registry — named, composable Monte-Carlo scenario families.

A *scenario* is one fully-specified simulation cell: a two-state Markov
worker model (per-worker ``p_gg``/``p_bb``), speeds, a deadline, a static
:class:`~repro_torch.core.lea.LoadParams`, the strategies to run and the
baseline strategy that ratios are reported against.  A *family* is a
registered function expanding keyword parameters into a tuple of scenarios
(:mod:`repro_torch.sweeps.scenarios`).

:func:`build_groups` flattens (scenarios x seeds) into :class:`SweepGroup`s:
one flat :class:`ScenarioBatch` of tensors per ``(rounds, strategies,
scheduled)`` signature.  Load parameters are per-row leaves (``kstar``,
``ell_g``, ``ell_b``) and pools of different sizes are padded to the
group's widest scenario with a (B, n_max) ``worker_mask``: padded workers
carry a frozen always-good chain (p_gg = 1, p_bb = 0), receive no load and
never count toward K*.  The whole group then runs as ONE batched engine
call, whatever K*s, loads or pool sizes it spans.

Seed discipline (the port's own; it does not reproduce ``jax.random``
keys).  Every row has a seed pair ``(root, repeat)``: ``root`` is the
scenario's explicit ``seed`` (fig3's 1..4), or ``2**32 +
fallback_seed_base * 2**20 + position`` for a seedless scenario at
``position`` in the scenario list — disjoint from every explicit seed — and
``repeat`` is the Monte-Carlo repeat index.  A group draws all its rows'
numbers from ONE ``torch.Generator`` seeded with
:attr:`SweepGroup.generator_seed`: a hash of the group's rounds, padded
width and the ordered list of its rows' seed pairs.  The same scenario list
and ``seeds`` therefore reproduce a run bit for bit on one device; a row's
numbers depend on the group it runs in (like the JAX package's padded
rows).  Tests replace the generator with draws replayed from ``jax.random``
on the JAX package's keys, which reproduces its results exactly.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Iterable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.lea import LoadParams, PoolLoad
from repro_torch.core.throughput import strategy_known

# a schedule segment: (start_round, p_gg row, p_bb row) — the chain in force
# from start_round until the next segment's start (piecewise-constant)
ScheduleSegment = tuple[int, tuple[float, ...], tuple[float, ...]]

# a dense chain spec: per-round rows, shape (rounds, n) as nested tuples
DenseRows = tuple[tuple[float, ...], ...]


def as_dense_schedule(p_gg, p_bb) -> tuple[DenseRows, DenseRows]:
    """Precomputed (rounds, n) chain arrays -> a hashable ``dense_schedule``.

    The dense counterpart of the piecewise-constant ``schedule`` segments:
    row t is the chain governing the transition into round t (row 0 doubles
    as the initial distribution, exactly the engine's time-varying-chain
    convention).  Use for computed drift curves that change every round.
    """
    p_gg = np.asarray(p_gg, np.float32)
    p_bb = np.asarray(p_bb, np.float32)
    if p_gg.ndim != 2 or p_gg.shape != p_bb.shape:
        raise ValueError(f"dense schedule needs matching (rounds, n) arrays, "
                         f"got {p_gg.shape} vs {p_bb.shape}")
    to_rows = lambda a: tuple(tuple(float(v) for v in row) for row in a)
    return (to_rows(p_gg), to_rows(p_bb))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named simulation cell (hashable: probabilities are tuples).

    ``strategies`` may name any registered policy
    (:mod:`repro_torch.policies`) alongside the engine-native static draws.
    A non-empty ``schedule`` makes the chain non-stationary: piecewise-
    constant segments materialised into (rounds, n) transition arrays at
    batch-build time (``p_gg``/``p_bb`` then hold the round-0 rows, kept
    for display and validation).  ``dense_schedule`` is the second
    materialisation path: a precomputed per-round (rounds, n) chain spec
    (:func:`as_dense_schedule`) for drift curves that move every round —
    mutually exclusive with ``schedule``.
    """

    name: str
    family: str
    lp: LoadParams
    p_gg: tuple[float, ...]          # per-worker, length lp.n (round-0 chain)
    p_bb: tuple[float, ...]
    mu_g: float
    mu_b: float
    deadline: float
    rounds: int
    strategies: tuple[str, ...] = ("lea", "static", "oracle")
    baseline: str = "static"
    seed: int | None = None          # explicit PRNGKey seed (paper replication)
    meta: tuple[tuple[str, Any], ...] = ()
    schedule: tuple[ScheduleSegment, ...] = ()
    dense_schedule: tuple[DenseRows, DenseRows] | None = None

    def __post_init__(self):
        if len(self.p_gg) != self.lp.n or len(self.p_bb) != self.lp.n:
            raise ValueError(f"{self.name}: p_gg/p_bb must have length n={self.lp.n}")
        for s in self.strategies:
            if not strategy_known(s):
                raise ValueError(f"{self.name}: unknown strategy {s!r}")
        if self.baseline not in self.strategies:
            raise ValueError(f"{self.name}: baseline {self.baseline!r} not in strategies")
        if self.schedule:
            starts = [seg[0] for seg in self.schedule]
            if starts[0] != 0:
                raise ValueError(f"{self.name}: schedule must start at round 0")
            if any(b <= a for a, b in zip(starts, starts[1:])):
                raise ValueError(f"{self.name}: schedule starts must increase")
            if starts[-1] >= self.rounds:
                raise ValueError(f"{self.name}: schedule start beyond rounds")
            for start, g, b in self.schedule:
                if len(g) != self.lp.n or len(b) != self.lp.n:
                    raise ValueError(
                        f"{self.name}: schedule rows at {start} must have length n"
                    )
            if (tuple(self.schedule[0][1]) != tuple(self.p_gg)
                    or tuple(self.schedule[0][2]) != tuple(self.p_bb)):
                raise ValueError(
                    f"{self.name}: p_gg/p_bb must equal the schedule's round-0 rows"
                )
        if self.dense_schedule is not None:
            if self.schedule:
                raise ValueError(
                    f"{self.name}: schedule and dense_schedule are mutually exclusive"
                )
            gg, bb = self.dense_schedule
            if len(gg) != self.rounds or len(bb) != self.rounds:
                raise ValueError(
                    f"{self.name}: dense_schedule must have one row per round "
                    f"(got {len(gg)}/{len(bb)} for rounds={self.rounds})"
                )
            for rows in (gg, bb):
                if any(len(row) != self.lp.n for row in rows):
                    raise ValueError(
                        f"{self.name}: dense_schedule rows must have length n={self.lp.n}"
                    )
            if (tuple(gg[0]) != tuple(self.p_gg)
                    or tuple(bb[0]) != tuple(self.p_bb)):
                raise ValueError(
                    f"{self.name}: p_gg/p_bb must equal the dense schedule's round-0 rows"
                )

    @property
    def scheduled(self) -> bool:
        """Does this scenario batch as (rounds, n) chain arrays?"""
        return bool(self.schedule) or self.dense_schedule is not None

    @property
    def group_signature(self) -> tuple:
        """The signature the executor batches rows by (one engine call each).

        Load parameters are per-row batch leaves, so they do NOT appear here
        — only ``(rounds, strategies)`` plus the chain-array rank flag.
        Scheduled scenarios (piecewise OR dense) batch as (rounds, n) chain
        arrays — a different input shape — so they group separately from
        stationary ones.
        """
        return (self.rounds, self.strategies, self.scheduled)

    def chain_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Materialise the chain: (n,) float32 rows, or (rounds, n) when
        scheduled (row t = the chain governing the transition into round t)."""
        if self.dense_schedule is not None:
            return (np.asarray(self.dense_schedule[0], np.float32),
                    np.asarray(self.dense_schedule[1], np.float32))
        if not self.schedule:
            return (np.asarray(self.p_gg, np.float32),
                    np.asarray(self.p_bb, np.float32))
        p_gg = np.empty((self.rounds, self.lp.n), np.float32)
        p_bb = np.empty((self.rounds, self.lp.n), np.float32)
        bounds = [seg[0] for seg in self.schedule] + [self.rounds]
        for (start, g, b), end in zip(self.schedule, bounds[1:]):
            p_gg[start:end] = np.asarray(g, np.float32)
            p_bb[start:end] = np.asarray(b, np.float32)
        return p_gg, p_bb

    def meta_dict(self) -> dict[str, Any]:
        return dict(self.meta)


class ScenarioBatch(NamedTuple):
    """Flat (B, ...) tensors of simulation inputs — one row per (scenario, seed).

    Chain arrays and the worker mask are padded to the group's widest
    scenario (``n_max``); ``kstar``/``ell_g``/``ell_b`` are the per-row load
    parameters; ``seeds`` holds each row's ``(root, repeat)`` seed pair.
    """

    seeds: torch.Tensor        # (B, 2) int64
    p_gg: torch.Tensor         # (B, n_max) float32 — or (B, rounds, n_max)
    p_bb: torch.Tensor         # (B, n_max) float32 — or (B, rounds, n_max)
    mu_g: torch.Tensor         # (B,)   float32
    mu_b: torch.Tensor         # (B,)   float32
    deadline: torch.Tensor     # (B,)   float32
    kstar: torch.Tensor        # (B,)   int32
    ell_g: torch.Tensor        # (B,)   int32
    ell_b: torch.Tensor        # (B,)   int32
    worker_mask: torch.Tensor  # (B, n_max) bool — True = real worker

    @property
    def rows(self) -> int:
        return self.p_gg.shape[0]

    @property
    def n_max(self) -> int:
        return self.worker_mask.shape[-1]

    @property
    def pool(self) -> PoolLoad:
        return PoolLoad(kstar=self.kstar, ell_g=self.ell_g, ell_b=self.ell_b,
                        mask=self.worker_mask)

    def to(self, device) -> "ScenarioBatch":
        return ScenarioBatch(*(t.to(device) for t in self))


class RowMeta(NamedTuple):
    """Provenance of one batch row: which scenario, which Monte-Carlo repeat."""

    scenario_index: int     # into SweepGroup.scenarios
    seed_index: int


@dataclasses.dataclass(frozen=True)
class SweepGroup:
    """All rows sharing one (rounds, strategies, scheduled) signature."""

    rounds: int
    strategies: tuple[str, ...]
    batch: ScenarioBatch
    scenarios: tuple[Scenario, ...]
    rows: tuple[RowMeta, ...]        # aligned with batch rows

    @property
    def n_max(self) -> int:
        return self.batch.n_max

    @property
    def generator_seed(self) -> int:
        """Seed of the group's ``torch.Generator`` (module docstring)."""
        h = hashlib.sha256(
            repr((self.rounds, self.n_max,
                  self.batch.seeds.tolist())).encode()
        )
        return int.from_bytes(h.digest()[:8], "little") & (2**63 - 1)


# ---------------------------------------------------------------------------
# family registration
# ---------------------------------------------------------------------------

_FAMILIES: dict[str, Callable[..., tuple[Scenario, ...]]] = {}


def register(name: str):
    """Decorator: register ``fn(**params) -> tuple[Scenario, ...]`` as a family."""

    def deco(fn):
        if name in _FAMILIES:
            raise ValueError(f"scenario family {name!r} already registered")
        _FAMILIES[name] = fn
        return fn

    return deco


def _ensure_builtins() -> None:
    # built-in families live in scenarios.py; importing it registers them
    from . import scenarios  # noqa: F401


def family_names() -> tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_FAMILIES))


def describe(name: str) -> str:
    _ensure_builtins()
    doc = _FAMILIES[name].__doc__ or ""
    return doc.strip().splitlines()[0] if doc.strip() else ""


def catalogue() -> str:
    """Human-readable one-line-per-family catalogue."""
    _ensure_builtins()
    width = max((len(n) for n in _FAMILIES), default=0)
    return "\n".join(f"{n:<{width}}  {describe(n)}" for n in sorted(_FAMILIES))


def expand(family: str, **params) -> tuple[Scenario, ...]:
    """Expand a named family into its scenarios."""
    _ensure_builtins()
    if family not in _FAMILIES:
        raise KeyError(
            f"unknown scenario family {family!r}; available: {', '.join(sorted(_FAMILIES))}"
        )
    scenarios = tuple(_FAMILIES[family](**params))
    names = [sc.name for sc in scenarios]
    if len(set(names)) != len(names):
        raise ValueError(f"family {family!r} produced duplicate scenario names")
    return scenarios


# ---------------------------------------------------------------------------
# batch building
# ---------------------------------------------------------------------------

def scenario_root_seed(sc: Scenario, fallback_seed_base: int, position: int) -> int:
    """The scenario's seed root: its explicit seed, else one past 2**32."""
    if sc.seed is not None:
        return int(sc.seed)
    return 2**32 + fallback_seed_base * 2**20 + position


# chain values padding a narrower scenario's extra workers: a frozen
# always-good chain, additionally pinned good by the engine's worker mask
_FROZEN_P_GG = 1.0
_FROZEN_P_BB = 0.0


def _pad_chain(arr: np.ndarray, n_max: int, value: float) -> np.ndarray:
    """Pad the worker (last) axis of an (n,) / (rounds, n) chain array."""
    pad = n_max - arr.shape[-1]
    if pad == 0:
        return arr
    widths = [(0, 0)] * (arr.ndim - 1) + [(0, pad)]
    return np.pad(arr, widths, constant_values=np.float32(value))


def build_groups(
    scenarios: Sequence[Scenario] | Iterable[Scenario],
    *,
    seeds: int = 1,
    fallback_seed_base: int = 0,
) -> tuple[SweepGroup, ...]:
    """Flatten (scenarios x seeds) into one SweepGroup per signature.

    Groups preserve first-seen scenario order; within a group rows are laid
    out scenario-major ((sc0, seed0), (sc0, seed1), ..., (sc1, seed0), ...).
    The batch tensors live on the CPU; the executor moves them to the device.
    """
    if seeds < 1:
        raise ValueError("seeds must be >= 1")
    scenarios = tuple(scenarios)
    by_sig: dict[tuple, list[tuple[int, Scenario]]] = {}
    for pos, sc in enumerate(scenarios):
        by_sig.setdefault(sc.group_signature, []).append((pos, sc))

    groups = []
    for (rounds, strategies, _scheduled), entries in by_sig.items():
        scs = [sc for _, sc in entries]
        n_max = max(sc.lp.n for sc in scs)
        cols = {k: [] for k in ScenarioBatch._fields}
        rows = []
        for si, (pos, sc) in enumerate(entries):
            root = scenario_root_seed(sc, fallback_seed_base, pos)
            chain_gg, chain_bb = sc.chain_arrays()
            chain_gg = _pad_chain(chain_gg, n_max, _FROZEN_P_GG)
            chain_bb = _pad_chain(chain_bb, n_max, _FROZEN_P_BB)
            mask_row = np.arange(n_max) < sc.lp.n
            for s in range(seeds):
                cols["seeds"].append((root, s))
                cols["p_gg"].append(chain_gg)
                cols["p_bb"].append(chain_bb)
                cols["mu_g"].append(sc.mu_g)
                cols["mu_b"].append(sc.mu_b)
                cols["deadline"].append(sc.deadline)
                cols["kstar"].append(sc.lp.kstar)
                cols["ell_g"].append(sc.lp.ell_g)
                cols["ell_b"].append(sc.lp.ell_b)
                cols["worker_mask"].append(mask_row)
                rows.append(RowMeta(scenario_index=si, seed_index=s))
        batch = ScenarioBatch(
            seeds=torch.tensor(cols["seeds"], dtype=torch.int64),
            p_gg=torch.from_numpy(np.stack(cols["p_gg"]).astype(np.float32)),
            p_bb=torch.from_numpy(np.stack(cols["p_bb"]).astype(np.float32)),
            mu_g=torch.tensor(cols["mu_g"], dtype=torch.float32),
            mu_b=torch.tensor(cols["mu_b"], dtype=torch.float32),
            deadline=torch.tensor(cols["deadline"], dtype=torch.float32),
            kstar=torch.tensor(cols["kstar"], dtype=torch.int32),
            ell_g=torch.tensor(cols["ell_g"], dtype=torch.int32),
            ell_b=torch.tensor(cols["ell_b"], dtype=torch.int32),
            worker_mask=torch.from_numpy(np.stack(cols["worker_mask"])),
        )
        groups.append(
            SweepGroup(rounds=rounds, strategies=strategies, batch=batch,
                       scenarios=tuple(scs), rows=tuple(rows))
        )
    return tuple(groups)
