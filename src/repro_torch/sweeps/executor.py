"""Grouped, chunked execution of scenario batches, and row shards over
processes.

One :class:`~repro_torch.sweeps.registry.SweepGroup` = one batched engine
call: :func:`run_group` moves the group's batch to the device and runs
:func:`repro_torch.core.throughput.sweep_pool` on all its rows at once
(per-row K*, loads and pool masks), drawing from the group's own
``torch.Generator`` unless the caller hands in another
:class:`~repro_torch.random.Draws`.  ``round_chunk`` runs the per-round work
in blocks of rounds to bound peak memory.  :func:`run_multihost` splits
every group's rows over the processes of a ``torch.distributed`` group
(:mod:`repro_torch.launch.mesh`), one device each.

``telemetry=`` returns the group's :class:`~repro_torch.obs.TelemetryFrame`
beside its successes, ``tap=`` delivers per-row block aggregates to the
registered tap handlers during the run (:mod:`repro_torch.obs.taps`), and
every call records its wall-clock (``phase.sweeps_run_group.seconds``) and
any kernel builds it triggered (``compile.sweeps_run_group.*``) in the
default metrics registry (:mod:`repro_torch.obs.metrics`).

The JAX package's pipelined path and its loop statistics have no
counterpart: its successes and tap events equal :func:`run_group`'s at the
same ``round_chunk`` and draws.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import throughput
from repro_torch.device import resolve_device
from repro_torch.obs import counters as _obs_counters
from repro_torch.obs import metrics as _metrics
from repro_torch.obs.profiling import phase as _phase
from repro_torch.random import Draws, torch_draws

from .registry import ScenarioBatch, SweepGroup


def compile_cache_size() -> int:
    """Kernel builds the sweep path needed in this process.

    The JAX package counts one compiled computation per group signature;
    the port compiles nothing per signature, so this alias over the
    unified counter (``obs.compile_events("build.poisson_binomial")``)
    counts the ``nvcc`` runs of the Poisson-binomial source the sweep
    engine launches: 0 or 1, whatever the number of groups.
    """
    return _obs_counters.compile_events("build.poisson_binomial")


def run_group(
    group: SweepGroup,
    *,
    round_chunk: int | None = None,
    draws: Draws | None = None,
    device=None,
    telemetry: bool = False,
    tap: bool = False,
    tap_stride: int | None = None,
):
    """Execute one group; returns the host (B, rounds, S) bool success array.

    With ``telemetry=True`` returns ``(succ, TelemetryFrame)``, the frame's
    leaves host arrays with the same leading (B,) rows as ``succ``.  With
    ``tap=True`` the engine delivers per-row block aggregates to the
    registered tap handlers during the run (``row`` = the batch index); the
    successes are the same either way.
    """
    if group.rounds < 1:
        names = ", ".join(sc.name for sc in group.scenarios[:3])
        raise ValueError(
            f"group [{names}, ...] has rounds={group.rounds}; catalogue-only "
            "scenario families (e.g. kstar_table) cannot be simulated"
        )
    dev = resolve_device(device)
    if draws is None:
        draws = torch_draws(group.generator_seed, dev)
    c0 = _obs_counters.compile_events()
    t0 = time.perf_counter()
    with _metrics.timed("phase.sweeps_run_group"):
        with _phase("lift", dev):
            batch = group.batch.to(dev)
        out = throughput.sweep_pool(
            draws, batch.pool, batch.p_gg, batch.p_bb, batch.mu_g, batch.mu_b,
            batch.deadline, group.rounds, group.strategies, round_chunk,
            telemetry, tap, tap_stride, device=dev,
        )
        with _phase("fetch", dev):
            succ = (out[0] if telemetry else out).cpu().numpy()
    _metrics.record_compile("sweeps.run_group", _obs_counters.compile_events() - c0,
                            time.perf_counter() - t0)
    if not telemetry:
        return succ
    b = group.batch.rows
    with _phase("fetch", dev):
        return succ[:b], type(out[1])(*(x[:b].cpu().numpy() for x in out[1]))


def run_groups(
    groups: Sequence[SweepGroup],
    *,
    round_chunk: int | None = None,
    draws: Callable[[SweepGroup], Draws] | None = None,
    device=None,
    tap: bool = False,
    tap_stride: int | None = None,
) -> list[np.ndarray]:
    """Execute every group; list aligned with ``groups``.  ``draws`` maps a
    group to its :class:`Draws` (default: the group's own generator)."""
    return [run_group(g, round_chunk=round_chunk,
                      draws=None if draws is None else draws(g), device=device,
                      tap=tap, tap_stride=tap_stride)
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
    tap: bool = False,
    tap_stride: int | None = None,
    **params,
):
    """The one-liner: expand -> group -> execute -> summarize.

    ``family_or_scenarios`` is a registered family name (``**params`` go to
    its expansion) or an iterable of
    :class:`~repro_torch.sweeps.registry.Scenario`.  ``tap`` /
    ``tap_stride`` pass through to :func:`run_group`.
    Returns a list of :class:`~repro_torch.sweeps.results.ScenarioResult`
    in scenario order.
    """
    from . import results as results_mod
    from .registry import build_groups

    scenarios = _scenarios(family_or_scenarios, params)
    groups = build_groups(scenarios, seeds=seeds)
    succs = run_groups(groups, round_chunk=round_chunk, draws=draws,
                       device=device, tap=tap, tap_stride=tap_stride)
    return results_mod.summarize(groups, succs, scenario_order=scenarios)


def _scenarios(family_or_scenarios, params) -> tuple:
    from .registry import expand

    if isinstance(family_or_scenarios, str):
        return expand(family_or_scenarios, **params)
    if params:
        raise TypeError("family params only apply to a named family")
    return tuple(family_or_scenarios)


def _slice_group_rows(group: SweepGroup, process_id: int,
                      num_processes: int) -> SweepGroup:
    """The sub-group of rows ``r`` with ``r % num_processes == process_id``.

    Interleaving (not a contiguous split) balances scenarios and seeds
    across processes.  The sub-group keeps the group's scenarios, so its
    ``rows`` (:class:`~repro_torch.sweeps.registry.RowMeta`) name each row
    exactly; its generator seed is a hash of its own rows' seed pairs.
    """
    batch = ScenarioBatch(*(t[process_id::num_processes].contiguous() for t in group.batch))
    return dataclasses.replace(group, batch=batch,
                               rows=tuple(group.rows[process_id::num_processes]))


def run_multihost(
    family_or_scenarios,
    *,
    spool_dir,
    seeds: int = 1,
    round_chunk: int | None = None,
    draws: Callable[[SweepGroup], Draws] | None = None,
    device=None,
    timeout_s: float = 600.0,
    **params,
):
    """:func:`run` over a ``torch.distributed`` group: row shards per
    process, merged by process 0.

    Every process expands the same scenario list and groups, runs the
    interleaved rows ``rows[pid::P]`` of every group through
    :func:`run_group` on its own device (``draws`` receives the
    sub-group), and publishes its shard to
    ``spool_dir`` by atomic rename
    (:func:`repro_torch.sweeps.results.write_row_shard`).  Process 0 merges
    the shards back into row order and summarizes; every other process
    returns ``None``.  The world comes from
    :func:`repro_torch.launch.mesh.world`; at world 1 this IS :func:`run`.

    Draws.  Under a position-keyed source (the JAX package's keys replayed
    for each sub-group's rows) the merged successes equal one process's
    bit for bit.  Under the default generator each shard draws from its own
    sub-group's hashed seed (:attr:`SweepGroup.generator_seed`), so the
    merge is a valid stream of the same distribution but not one process's
    numbers.
    """
    from repro_torch.launch import mesh as mesh_mod

    from . import results as results_mod
    from .registry import build_groups

    pid, nprocs = mesh_mod.world()
    if nprocs == 1:
        return run(family_or_scenarios, seeds=seeds, round_chunk=round_chunk,
                   draws=draws, device=device, **params)
    scenarios = _scenarios(family_or_scenarios, params)
    groups = build_groups(scenarios, seeds=seeds)
    for gi, group in enumerate(groups):
        sub = _slice_group_rows(group, pid, nprocs)
        if sub.batch.rows == 0:      # more processes than rows: empty shard
            succ = np.zeros((0, group.rounds, len(group.strategies)), bool)
        else:
            succ = run_group(sub, round_chunk=round_chunk,
                             draws=None if draws is None else draws(sub),
                             device=device)
        results_mod.write_row_shard(spool_dir, gi, pid, nprocs, succ)
    if pid != 0:
        return None
    succs = [results_mod.merge_row_shards(spool_dir, gi, nprocs, timeout_s=timeout_s)
             for gi in range(len(groups))]
    return results_mod.summarize(groups, succs, scenario_order=scenarios)


__all__ = ["compile_cache_size", "run", "run_group", "run_groups", "run_multihost",
           "suggest_round_chunk"]
