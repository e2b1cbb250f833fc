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
as many times as a single cell does.  ``telemetry=`` and ``tap=`` belong
to the observability slice and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import throughput
from repro_torch.core.lea import PoolLoad
from repro_torch.device import resolve_device
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


def _not_ported(telemetry: bool, tap: bool) -> None:
    if telemetry or tap:
        raise NotImplementedError(
            "telemetry= and tap= need the observability slice "
            "(ROADMAP Queue A, A4), which is not ported yet"
        )


def _faults_batched(draws, pool: PoolLoad, p_gg, p_bb, mu_g, mu_b, deadline,
                    channel, k1star, rounds, strategies, r, packets, p1
                    ) -> FaultOutcomes:
    """(B,) rows of (B,)-shaped inputs -> (B, rounds, S) outcomes."""
    strategies = tuple(strategies)
    throughput._check_strategies(strategies)
    throughput._check_chain_shapes(p_gg, p_bb, rounds)
    b, n = p_gg.shape[0], p_gg.shape[-1]
    states, p_alloc, pi_g = throughput.engine_preamble(
        draws, pool, p_gg, p_bb, rounds, strategies)
    loads, feasible = throughput._rollout_block(
        states, draws, rounds, 0, p_alloc, pi_g, pool, strategies
    )                                          # (S, B, M, n), (S, B, M)
    trace = base_trace(b, rounds, n, r, packets, deadline, device=states.device)
    trace = apply_channel(draws, channel, trace)
    col = lambda x: x[:, None, None]           # (B,) against (B, M, n)
    mg, mb, dl = col(mu_g), col(mu_b), col(deadline)
    counts_aon = packet_counts(packet_on_time(
        states, loads, mg, mb, dl, r, packets, trace=trace, conserve=False))
    counts_con = packet_counts(packet_on_time(
        states, loads, mg, mb, dl, r, packets, trace=trace, conserve=True))
    kstar = pool.kstar[:, None, None]          # against (S, B, M, P)
    full_aon = feasible & torch.all(counts_aon >= kstar, dim=-1)
    full_con = feasible & torch.all(counts_con >= kstar, dim=-1)
    l1 = feasible & layer1_recovery(counts_con, k1star[:, None, None], p1)
    to_bms = lambda x: x.permute(1, 2, 0)      # (S, B, M) -> (B, M, S)
    return FaultOutcomes(full_aon=to_bms(full_aon),
                         full_conserve=to_bms(full_con),
                         partial=to_bms(l1 & ~full_con))


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
    device=None,
) -> FaultOutcomes:
    """Batched :func:`simulate_faults`: B rows in one pass.

    ``p_gg`` / ``p_bb`` are (B, n); ``pool`` leaves (B,) (or scalars) with a
    (B, n) (or (n,)) mask; ``mu_g`` / ``mu_b`` / ``deadline`` / ``k1star``
    and every channel parameter scalars or (B,).  ``draws`` is a
    :class:`~repro_torch.random.Draws` that also answers
    :class:`~repro_torch.random.FaultDraws` (an int seeds a
    :class:`~repro_torch.random.TorchDraws`).  Returns
    :class:`FaultOutcomes` of (B, rounds, S) tensors.
    """
    _not_ported(telemetry, tap)
    dev = resolve_device(device)
    p_gg = torch.as_tensor(p_gg, dtype=torch.float32, device=dev)
    p_bb = torch.as_tensor(p_bb, dtype=torch.float32, device=dev)
    b = p_gg.shape[0]
    f32 = lambda x: throughput._rows(x, b, torch.float32, dev)
    return _faults_batched(
        as_draws(draws, dev), throughput._batch_pool(pool, b, dev), p_gg, p_bb,
        f32(mu_g), f32(mu_b), f32(deadline), tuple(channel),
        throughput._rows(k1star, b, torch.int32, dev), rounds, strategies, r, packets, p1,
    )


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
    device=None,
) -> FaultOutcomes:
    """One row's fault-scored simulation (see module docstring).

    ``pool`` is a :class:`~repro_torch.core.lea.PoolLoad` of scalars and an
    (n,) mask; ``p_gg`` / ``p_bb`` (n,); ``channel`` a tuple of injectors
    from :mod:`repro_torch.faults.channels` with scalar parameters;
    ``k1star`` the layer-1 threshold; ``r`` / ``packets`` / ``p1`` the
    packet geometry.  With an empty channel AND ``packets=1`` the
    ``full_aon`` column equals
    :func:`~repro_torch.core.throughput.simulate_strategies_pool`'s
    successes on the same draws.  Returns (rounds, S) outcomes.
    """
    _not_ported(telemetry, tap)
    dev = resolve_device(device)
    out = sweep_faults(
        draws, pool, torch.as_tensor(p_gg, dtype=torch.float32, device=dev)[None],
        torch.as_tensor(p_bb, dtype=torch.float32, device=dev)[None],
        mu_g, mu_b, deadline, channel, k1star, rounds=rounds,
        strategies=strategies, r=r, packets=packets, p1=p1, device=dev,
    )
    return FaultOutcomes(*(x[0] for x in out))


__all__ = ["FaultOutcomes", "simulate_faults", "sweep_faults"]
