"""Batched fault-sweep engine: score decode modes under shared fault traces.

One vectorised pass over (B,) rows: the engine's rollout
(:func:`repro_torch.core.throughput.rollout_pool` semantics — per-row K*
and loads over mask-padded pools, ONE batched allocator call, so one launch
of the per-row Poisson-binomial kernel on the card for the whole grid),
the fault channel realised ONCE per row from the fault draws, and every
strategy's every round scored under three decode modes on the SAME
trajectory and the SAME faults:

  ``full_aon``       — all-or-nothing packet rule meets K* at every packet
                       index (the classic ``chunk_on_time`` model);
  ``full_conserve``  — partial-work-conserving rule meets K* at every
                       packet index.  AON ⊆ conserve pointwise, so
                       ``full_aon => full_conserve`` round by round;
  ``partial``        — full decode infeasible but the hierarchical layer-1
                       code (threshold ``k1star`` over the first ``p1``
                       packet indices) decodes — the degraded serving mode.

Channel parameters are Python floats or (B,) tensors, one value a row, so
a whole fault-parameter grid is one call: where the JAX package compiles
one computation per signature, here the grid launches the allocator kernel
as many times as a single cell does.

``telemetry=True`` adds a :class:`~repro_torch.obs.FaultTelemetry` of
per-round fault-event counts and the binding received margins of both
decode modes; ``tap=True`` delivers ``faults.sweep`` events (prefix sums
of the outcome and fault streams at ``tap_stride`` boundaries, one event
a row) to the registered tap handlers.  The outcomes are the same either
way.  :func:`fault_compile_cache_size` counts the kernel builds the path
needed (:mod:`repro_torch.obs.counters`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import throughput
from repro_torch.core.lea import PoolLoad
from repro_torch.device import resolve_device
from repro_torch.obs import counters as _obs_counters
from repro_torch.obs import taps as _taps
from repro_torch.obs.profiling import phase as _phase
from repro_torch.obs.telemetry import FaultTelemetry
from repro_torch.random import as_draws

from .channels import apply_channel, base_trace
from .packets import layer1_recovery, packet_counts, packet_on_time


class FaultOutcomes(NamedTuple):
    """Per-round, per-strategy decode outcomes ((..., rounds, S) bool each).

    ``partial`` is exclusive of ``full_conserve`` (layer-1 only); a round's
    conserving-mode disposition is full_conserve / partial / neither.
    """

    full_aon: torch.Tensor
    full_conserve: torch.Tensor
    partial: torch.Tensor


def fault_compile_cache_size() -> int:
    """Kernel builds the fault path needed in this process.

    The JAX package counts one compiled computation per fault-group
    signature; the port compiles nothing per signature, so this alias over
    the unified counter (``obs.compile_events("build.poisson_binomial")``)
    counts the ``nvcc`` runs of the allocator's source: 0 or 1.
    """
    return _obs_counters.compile_events("build.poisson_binomial")


def _emit_faults(outcomes, preempted, lost, tap_stride, rows) -> None:
    """Deliver ``faults.sweep`` events: the streams' prefix sums at the
    stride boundaries, copied to the host once, one event a row a
    boundary."""
    bounds, (aon, con, part, pre, los) = _taps.prefix_sums_at(tap_stride, *outcomes,
                                                                preempted, lost)
    b = pre.shape[0]
    for bi, bound in enumerate(bounds):
        _taps.emit_rows(
            "faults.sweep", block=np.full(b, bi, np.int32), row=rows,
            rounds_done=np.full(b, bound, np.int32),
            recovered_aon_so_far=aon[:, bi], recovered_conserve_so_far=con[:, bi],
            partial_so_far=part[:, bi], preempted_so_far=pre[:, bi],
            packets_lost_so_far=los[:, bi],
        )


def _lifted(pool, p_gg, p_bb, mu_g, mu_b, deadline, k1star, dev):
    """The (B,)-row tensors :func:`_faults_batched` takes, from (B, n)
    chains and scalar or (B,) parameters."""
    p_gg = torch.as_tensor(p_gg, dtype=torch.float32, device=dev)
    p_bb = torch.as_tensor(p_bb, dtype=torch.float32, device=dev)
    b = p_gg.shape[0]
    f32 = lambda x: throughput._rows(x, b, torch.float32, dev)
    return (throughput._batch_pool(pool, b, dev), p_gg, p_bb, f32(mu_g), f32(mu_b),
            f32(deadline), throughput._rows(k1star, b, torch.int32, dev))


def _faults_batched(draws, pool: PoolLoad, p_gg, p_bb, mu_g, mu_b, deadline, k1star,
                    channel, rounds, strategies, r, packets, p1,
                    telemetry=False, tap=False, tap_stride=None, tap_rows=None):
    """(B,) rows of (B,)-shaped inputs -> (B, rounds, S) outcomes (and a
    :class:`FaultTelemetry` of (B, rounds, ...) leaves with ``telemetry``)."""
    strategies = tuple(strategies)
    throughput._check_strategies(strategies)
    throughput._check_chain_shapes(p_gg, p_bb, rounds)
    b, n = p_gg.shape[0], p_gg.shape[-1]
    states, p_alloc, pi_g = throughput.engine_preamble(
        draws, pool.mask, p_gg, p_bb, rounds, strategies)
    loads, feasible = throughput._rollout_block(
        states, draws, rounds, 0, p_alloc, pi_g, pool, strategies
    )                                          # (S, B, M, n), (S, B, M)
    trace = base_trace(b, rounds, n, r, packets, deadline, device=states.device)
    trace = apply_channel(draws, channel, trace)
    col = lambda x: x[:, None, None]           # (B,) against (B, M, n)
    mg, mb, dl = col(mu_g), col(mu_b), col(deadline)
    with _phase("decode", states.device):
        counts_aon = packet_counts(packet_on_time(
            states, loads, mg, mb, dl, r, packets, trace=trace, conserve=False))
        counts_con = packet_counts(packet_on_time(
            states, loads, mg, mb, dl, r, packets, trace=trace, conserve=True))
    kstar = pool.kstar[:, None, None]          # against (S, B, M, P)
    full_aon = feasible & torch.all(counts_aon >= kstar, dim=-1)
    full_con = feasible & torch.all(counts_con >= kstar, dim=-1)
    l1 = feasible & layer1_recovery(counts_con, k1star[:, None, None], p1)
    to_bms = lambda x: x.permute(1, 2, 0)      # (S, B, M) -> (B, M, S)
    outcomes = FaultOutcomes(full_aon=to_bms(full_aon),
                             full_conserve=to_bms(full_con),
                             partial=to_bms(l1 & ~full_con))
    if not (telemetry or tap):
        return outcomes
    # fault-event counts: extra outputs of the same tensors
    preempted = (trace.t_cut < dl).sum(dim=-1, dtype=torch.int32)            # (B, M)
    lost = (~trace.keep).sum(dim=(-3, -2, -1), dtype=torch.int32)           # (B, M)
    if tap:
        rows = (np.arange(b, dtype=np.int32) if tap_rows is None
                else np.asarray(tap_rows, np.int32))
        _emit_faults(outcomes, preempted, lost, tap_stride, rows)
    if not telemetry:
        return outcomes
    return outcomes, FaultTelemetry(
        preempted=preempted, packets_lost=lost,
        received_aon=to_bms(counts_aon.amin(dim=-1)),
        received_conserve=to_bms(counts_con.amin(dim=-1)))


def sweep_faults(
    draws,
    pool: PoolLoad,
    p_gg,
    p_bb,
    mu_g,
    mu_b,
    deadline,
    channel: tuple,
    k1star,
    *,
    rounds: int,
    strategies: tuple[str, ...] = ("lea", "static"),
    r: int,
    packets: int,
    p1: int = 1,
    telemetry: bool = False,
    tap: bool = False,
    tap_stride: int | None = None,
    device=None,
):
    """Batched :func:`simulate_faults`: B rows in one pass.

    ``p_gg`` / ``p_bb`` are (B, n); ``pool`` leaves (B,) (or scalars) with a
    (B, n) (or (n,)) mask; ``mu_g`` / ``mu_b`` / ``deadline`` / ``k1star``
    and every channel parameter scalars or (B,).  ``draws`` is a
    :class:`~repro_torch.random.Draws` that also answers
    :class:`~repro_torch.random.FaultDraws` (an int seeds a
    :class:`~repro_torch.random.TorchDraws`).  Returns
    :class:`FaultOutcomes` of (B, rounds, S) tensors; with ``telemetry``
    ``(outcomes, FaultTelemetry)``, every leaf with a leading (B,).
    ``tap=True`` delivers one ``faults.sweep`` event a row at every
    ``tap_stride`` boundary (default: once, at the end), ``row`` the batch
    index.
    """
    dev = resolve_device(device)
    return _faults_batched(
        as_draws(draws, dev), *_lifted(pool, p_gg, p_bb, mu_g, mu_b, deadline, k1star, dev),
        tuple(channel), rounds, strategies, r, packets, p1, telemetry, tap, tap_stride)


def simulate_faults(
    draws,
    pool: PoolLoad,
    p_gg,
    p_bb,
    mu_g,
    mu_b,
    deadline,
    channel: tuple,
    k1star,
    *,
    rounds: int,
    strategies: tuple[str, ...] = ("lea", "static"),
    r: int,
    packets: int,
    p1: int = 1,
    telemetry: bool = False,
    tap: bool = False,
    tap_stride: int | None = None,
    device=None,
):
    """One row's fault-scored simulation (see module docstring).

    ``pool`` is a :class:`~repro_torch.core.lea.PoolLoad` of scalars and an
    (n,) mask; ``p_gg`` / ``p_bb`` (n,); ``channel`` a tuple of injectors
    from :mod:`repro_torch.faults.channels` with scalar parameters;
    ``k1star`` the layer-1 threshold; ``r`` / ``packets`` / ``p1`` the
    packet geometry.  With an empty channel AND ``packets=1`` the
    ``full_aon`` column equals
    :func:`~repro_torch.core.throughput.simulate_strategies_pool`'s
    successes on the same draws.  Returns (rounds, S) outcomes; with
    ``telemetry`` ``(outcomes, FaultTelemetry)``; tap events carry
    ``row = -1``.
    """
    dev = resolve_device(device)
    p_gg = torch.as_tensor(p_gg, dtype=torch.float32, device=dev)[None]
    p_bb = torch.as_tensor(p_bb, dtype=torch.float32, device=dev)[None]
    out = _faults_batched(
        as_draws(draws, dev), *_lifted(pool, p_gg, p_bb, mu_g, mu_b, deadline, k1star, dev),
        tuple(channel), rounds, strategies, r, packets, p1, telemetry, tap, tap_stride,
        tap_rows=[-1])
    if not telemetry:
        return FaultOutcomes(*(x[0] for x in out))
    return FaultOutcomes(*(x[0] for x in out[0])), FaultTelemetry(*(x[0] for x in out[1]))


__all__ = ["FaultOutcomes", "fault_compile_cache_size", "simulate_faults", "sweep_faults"]
