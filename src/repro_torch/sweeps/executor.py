"""Grouped, chunked execution of scenario batches (the sync path).

One :class:`~repro_torch.sweeps.registry.SweepGroup` = one batched engine
call: :func:`run_group` moves the group's batch to the device and runs
:func:`repro_torch.core.throughput.sweep_pool` on all its rows at once
(per-row K*, loads and pool masks), drawing from the group's own
``torch.Generator`` unless the caller hands in another
:class:`~repro_torch.random.Draws`.  ``round_chunk`` runs the per-round work
in blocks of rounds to bound peak memory.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from repro_torch.core import throughput
from repro_torch.device import resolve_device
from repro_torch.random import Draws, torch_draws

from .registry import SweepGroup


def run_group(
    group: SweepGroup,
    *,
    round_chunk: int | None = None,
    draws: Draws | None = None,
    device=None,
) -> np.ndarray:
    """Execute one group; returns the host (B, rounds, S) bool success array."""
    if group.rounds < 1:
        names = ", ".join(sc.name for sc in group.scenarios[:3])
        raise ValueError(
            f"group [{names}, ...] has rounds={group.rounds}; catalogue-only "
            "scenario families (e.g. kstar_table) cannot be simulated"
        )
    dev = resolve_device(device)
    if draws is None:
        draws = torch_draws(group.generator_seed, dev)
    batch = group.batch.to(dev)
    succ = throughput.sweep_pool(
        draws, batch.pool, batch.p_gg, batch.p_bb, batch.mu_g, batch.mu_b,
        batch.deadline, group.rounds, group.strategies, round_chunk,
        device=dev,
    )
    return succ.cpu().numpy()


def run_groups(
    groups: Sequence[SweepGroup],
    *,
    round_chunk: int | None = None,
    draws: Callable[[SweepGroup], Draws] | None = None,
    device=None,
) -> list[np.ndarray]:
    """Execute every group; list aligned with ``groups``.  ``draws`` maps a
    group to its :class:`Draws` (default: the group's own generator)."""
    return [run_group(g, round_chunk=round_chunk,
                      draws=None if draws is None else draws(g), device=device)
            for g in groups]


def suggest_round_chunk(group: SweepGroup, *, budget_bytes: int = 8 << 30) -> int | None:
    """A round_chunk that keeps one block's per-round tensors under budget.

    Per (row, round) a block holds the (S + 2) (n,)-wide score and draw
    tensors with temporaries (~8 floats each) and, per allocator strategy,
    the DP's inputs, output and sort indices (~10 words of n).  The
    trajectory and policy replay span all rounds whatever the chunk.
    Returns None when the whole run fits.
    """
    b = group.batch.rows
    n = group.n_max
    s = len(group.strategies)
    a = len(throughput.allocator_strategies(group.strategies))
    per_round = 4 * b * n * (8 * (s + 2) + 10 * a)
    chunk = max(1, budget_bytes // max(per_round, 1))
    return None if chunk >= group.rounds else int(chunk)


def run(
    family_or_scenarios,
    *,
    seeds: int = 1,
    round_chunk: int | None = None,
    draws: Callable[[SweepGroup], Draws] | None = None,
    device=None,
    **params,
):
    """The one-liner: expand -> group -> execute -> summarize.

    ``family_or_scenarios`` is a registered family name (``**params`` go to
    its expansion) or an iterable of
    :class:`~repro_torch.sweeps.registry.Scenario`.  Returns a list of
    :class:`~repro_torch.sweeps.results.ScenarioResult` in scenario order.
    """
    from . import results as results_mod
    from .registry import build_groups, expand

    if isinstance(family_or_scenarios, str):
        scenarios = expand(family_or_scenarios, **params)
    else:
        if params:
            raise TypeError("family params only apply to a named family")
        scenarios = tuple(family_or_scenarios)
    groups = build_groups(scenarios, seeds=seeds)
    succs = run_groups(groups, round_chunk=round_chunk, draws=draws,
                       device=device)
    return results_mod.summarize(groups, succs, scenario_order=scenarios)


__all__ = ["run", "run_group", "run_groups", "suggest_round_chunk"]
