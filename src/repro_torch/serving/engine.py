"""The streaming serving engine: a loop over rounds on the device.

Turns the offline sweep engine into an online service simulator: a
continuous arrival process feeds a fixed-capacity request queue on the
device; every round the worker pool is split across the active queue
slots by greedy EDF water-filling (:func:`repro_torch.core.lea.allocate_queue`),
slots are scored with the engine's on-time rule, and completed / expired
requests leave with full accounting (:class:`ServingOutcomes`).

Engine discipline (as in the JAX package):

  * draws — the preamble is :func:`repro_torch.core.throughput.serve_rollout`,
    the offline engine's trajectory and policy replays, with arrivals on
    :class:`~repro_torch.random.ArrivalDraws` and faults on
    :class:`~repro_torch.random.FaultDraws` — so a single-slot queue fed
    one always-admitted request per round with ``deadline_rel = 0``
    reproduces :func:`~repro_torch.core.throughput.simulate_strategies_pool`
    on the same draws to the bit, and a zero-arrival run leaves every
    engine draw untouched;
  * scoring — ``loads / speed <= t_cut + 1e-9`` per slot in float32, the
    engine rule; ``t_cut`` is the deadline unless a fault channel degrades
    it (time-axis injectors only: ``crash_restart`` / ``preempt``;
    packet-axis injectors are REJECTED loudly, never silently ignored);
  * accounting — every request ends in exactly one disposition:

        arrivals == admitted + rejected
        admitted == served_on_time + served_late + expired + in_flight

Round order: (1) admit this round's arrivals (they may be served the same
round, like the offline engine's one-round jobs); (2) allocate over active
slots in EDF order; (3) score; (4) retire — completions by
``deadline_abs`` are on time, completions within ``grace`` extra rounds
are late, uncompleted requests past ``deadline_abs + grace`` expire; freed
slots are recycled at once.

Where the JAX package runs one ``lax.scan`` vmapped over strategies and
rows, the port runs a Python loop over rounds on tensors that live on the
device, every strategy and row of a call batched into each op.  Nothing in
the loop reads a tensor back to the host, so the host syncs a call makes do
not depend on ``rounds``.  On the card the admission gate is one launch of
the Poisson-binomial kernel for every (strategy, row, round) and the
allocation one launch a round for every (strategy, row, slot): ``rounds +
1`` launches a call.  The port compiles nothing per signature, so
:func:`serving_compile_cache_size` counts the kernel builds the path needed
(:mod:`repro_torch.obs.counters`).

``telemetry=True`` adds a :class:`~repro_torch.obs.ServingTelemetry` of
per-round arrivals, occupancy, admissions and rejections, computed on the
device from the loop's own streams.  ``tap=True`` follows the JAX
package's segmented scan: the engine runs :func:`_round_loop` once per
``tap_stride`` segment, carrying the queue between calls, and between
segments copies that boundary's aggregates to the host once and delivers
one ``serving`` event a (row, strategy) — so each boundary costs one sync
and the loop itself still reads nothing back.  The outcomes are the same
either way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import lea as lea_mod
from repro_torch.core import throughput
from repro_torch.device import resolve_device
from repro_torch.obs import counters as _obs_counters
from repro_torch.obs import taps as _taps
from repro_torch.obs.telemetry import ServingTelemetry
from repro_torch.random import as_draws

from . import admission
from . import arrivals as arrivals_mod
from . import queue as rqueue

# event codes emitted per (round, slot)
EVENT_NONE, EVENT_ON_TIME, EVENT_LATE, EVENT_EXPIRED = 0, 1, 2, 3

# fault injectors that act on the time axis (t_cut) — the only ones the
# serving scorer consumes; packet-axis injectors would be silently inert
_TIME_INJECTORS = frozenset({"crash_restart", "preempt"})


class ServingOutcomes(NamedTuple):
    """Per-strategy serving accounting over one simulation.

    Counters are (S,) int32 ((B, S) under :func:`sweep_serving`);
    ``events`` / ``sojourn`` are (S, rounds, Q) per-slot streams: the event
    code (EVENT_*) of any request LEAVING that slot that round, and its
    sojourn time ``t - arrival + 1`` in rounds (0 where no event) — the raw
    material for latency percentiles.

    Conservation (every request in exactly one disposition):
    ``arrivals == admitted + rejected`` and
    ``admitted == served_on_time + served_late + expired + in_flight``.
    """

    arrivals: torch.Tensor
    admitted: torch.Tensor
    served_on_time: torch.Tensor
    served_late: torch.Tensor
    rejected: torch.Tensor
    expired: torch.Tensor
    in_flight: torch.Tensor
    events: torch.Tensor
    sojourn: torch.Tensor


def _check_channel(channel) -> None:
    for inj in channel:
        name = getattr(type(inj), "injector_name", type(inj).__name__)
        if name not in _TIME_INJECTORS:
            raise ValueError(
                f"serving consumes the time axis (t_cut) of a fault trace "
                f"only; injector {name!r} acts on the packet axis and would "
                f"be silently ignored — use one of "
                f"{sorted(_TIME_INJECTORS)} or score packets through "
                f"repro_torch.faults.engine instead"
            )


def serving_compile_cache_size() -> int:
    """Kernel builds the serving path needed in this process.

    The JAX package counts one compiled computation per serving-group
    signature; the port compiles nothing per signature, so this alias over
    the unified counter (``obs.compile_events("build.poisson_binomial")``)
    counts the ``nvcc`` runs of the allocator's source: 0 or 1.
    """
    return _obs_counters.compile_events("build.poisson_binomial")


def _per_round(x, rows: int, rounds: int, dtype, dev) -> torch.Tensor:
    """A (rows, 1) or (rows, rounds) spec field as a contiguous (rounds,
    rows) table, one row a round."""
    t = torch.as_tensor(x, dtype=dtype, device=dev)
    return torch.broadcast_to(t, (rows, rounds)).t().contiguous()


class _Tables(NamedTuple):
    """The serving loop's inputs, one leading row a round (``rounds`` first)."""

    counts: torch.Tensor        # (M, B) int32 arrivals
    gate: torch.Tensor          # (M, S, B) bool — the prediction gate passed
    kstar: torch.Tensor         # (M, B) int32, and so the other spec fields
    ell_g: torch.Tensor
    ell_b: torch.Tensor
    deadline_rel: torch.Tensor
    reserve_cap: torch.Tensor   # (M, B) float32
    m_new: torch.Tensor         # (M, B) int32 — a newcomer's minimal demand
    speeds: torch.Tensor        # (M, B, n) float32
    t_cut: torch.Tensor         # (M, B, n) or (M, B, 1) float32, + 1e-9
    p_alloc: torch.Tensor       # (M, S, B, n) float32 predicted p_good


def _round_loop(tab: _Tables, mask: torch.Tensor, n_valid: torch.Tensor, grace: int,
                q: rqueue.RequestQueue, t0: int, t1: int):
    """Rounds ``t0 .. t1 - 1``, in order, on the device, from queue ``q``:
    returns ``(events (m, S, B, Q), sojourn (m, S, B, Q), admitted (m, S,
    B), q)`` for the m = t1 - t0 rounds and the queue after them.

    Every op is a tensor op on the tables' device with Python ints as its
    only host inputs, so no round reads anything back to the host.
    """
    i32, f32 = torch.int32, torch.float32
    events, sojourn, admitted = [], [], []
    for t in range(t0, t1):
        # (1) admission: prediction gate x capacity gate x free slots
        m_active = admission.minimal_demand(q.occupied, q.kstar, q.ell_g)
        room = admission.admission_room(m_active, tab.m_new[t], n_valid, tab.reserve_cap[t])
        want = torch.where(tab.gate[t], torch.minimum(tab.counts[t], room), 0)
        q, n_admit = rqueue.admit(q, t, want, tab.kstar[t], tab.ell_g[t], tab.ell_b[t],
                                  tab.deadline_rel[t])
        # (2) multi-job allocation: greedy EDF water-filling
        loads, _i_star, feas = lea_mod.allocate_queue(
            tab.p_alloc[t], mask, q.occupied, q.kstar, q.ell_g, q.ell_b, rqueue.edf_order(q))
        # (3) score: the engine's on-time rule, per slot
        on_time = loads.to(f32) / tab.speeds[t][:, None, :] <= tab.t_cut[t][:, None, :]
        received = torch.where(on_time, loads, 0).sum(dim=-1, dtype=i32)     # (S, B, Q)
        complete = q.occupied & feas & (received >= q.kstar)
        # (4) disposition
        late = q.deadline_abs < t
        overdue = q.occupied & ~complete & (q.deadline_abs + grace <= t)
        leave = complete | overdue
        events.append(torch.where(complete, torch.where(late, EVENT_LATE, EVENT_ON_TIME),
                                  torch.where(overdue, EVENT_EXPIRED, EVENT_NONE)).to(i32))
        sojourn.append(torch.where(leave, t + 1 - q.arrival, 0))
        admitted.append(n_admit)
        q = rqueue.release(q, leave)
    return torch.stack(events), torch.stack(sojourn), torch.stack(admitted), q


def _segmented_loop(tab: _Tables, mask, n_valid, capacity: int, grace: int,
                    tap_stride: int | None, rows: np.ndarray):
    """:func:`_round_loop` once per tap segment, the queue carried between
    calls; after each segment one copy of the boundary's (S, B) aggregates
    to the host and one ``serving`` event a (row, strategy)."""
    rounds, s, b = tab.gate.shape
    i32 = torch.int32
    q = rqueue.empty_queue(capacity, (s, b), device=tab.gate.device)
    bounds = _taps.stride_boundaries(rounds, _taps.resolve_stride(rounds, tap_stride))
    parts, done = [], 0
    tot = torch.zeros((4, s, b), dtype=i32, device=tab.gate.device)
    arrived = tab.counts.cumsum(dim=0, dtype=i32)                          # (M, B)
    strategy = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).reshape(-1)
    row = np.repeat(rows, s)
    for bi, bound in enumerate(bounds):
        events, sojourn, admitted, q = _round_loop(tab, mask, n_valid, grace, q, done, bound)
        parts.append((events, sojourn, admitted))
        tot = tot + torch.stack([admitted.sum(dim=0, dtype=i32)]
                                + [(events == code).sum(dim=(0, -1), dtype=i32)
                                   for code in (EVENT_ON_TIME, EVENT_LATE, EVENT_EXPIRED)])
        agg = torch.cat([tot, (arrived[bound - 1] - tot[0])[None],
                         q.occupied.sum(dim=-1, dtype=i32)[None]])               # (6, S, B)
        adm, on_t, late, exp, rej, occ = (x.T.reshape(-1) for x in _taps.to_host(agg)[0])
        _taps.emit_rows(
            "serving", block=np.full(b * s, bi, np.int32), row=row, strategy=strategy,
            rounds_done=np.full(b * s, bound, np.int32), admitted_so_far=adm,
            served_on_time_so_far=on_t, served_late_so_far=late, rejected_so_far=rej,
            expired_so_far=exp, occupancy=occ)
        done = bound
    events, sojourn, admitted = (torch.cat(x) for x in zip(*parts))
    return events, sojourn, admitted, q


def _serving_batched(draws, mask, p_gg, p_bb, mu_g, mu_b, deadline, spec, process,
                     channel, rounds, strategies, capacity, grace, telemetry=False,
                     tap=False, tap_stride=None, tap_rows=None):
    """(B,) rows -> :class:`ServingOutcomes` of (B, S, ...) leaves (and a
    :class:`ServingTelemetry` with ``telemetry``).

    ``mask``, ``p_gg``, ``p_bb`` are (B, n); ``mu_g``, ``mu_b``,
    ``deadline`` (B,) float32; every ``spec`` field (B, 1) or (B, rounds).
    """
    _check_channel(channel)
    dev = p_gg.device
    b, n = p_gg.shape
    states, p_alloc = throughput.serve_rollout(draws, mask, p_gg, p_bb, rounds, strategies,
                                               device=dev)            # (B, M, n), (S, B, M, n)
    s = p_alloc.shape[0]
    counts = arrivals_mod.sample_arrivals(draws, process, b, rounds, device=dev)   # (B, M)

    # compute-cutoff times: the deadline, or a time-axis fault channel's
    if channel:
        from repro_torch.faults.channels import apply_channel, base_trace

        trace = apply_channel(draws, channel, base_trace(b, rounds, n, 1, 1, deadline,
                                                         device=dev))
        t_cut = trace.t_cut.transpose(0, 1) + 1e-9                      # (M, B, n)
    else:
        t_cut = (deadline + 1e-9)[:, None].expand(rounds, b, 1)         # (M, B, 1)

    # the admission prediction gate, ONE batched DP over (S, B, M) rows
    p_succ = admission.predicted_success(p_alloc, mask[:, None, :], spec.kstar,
                                         spec.ell_g, spec.ell_b)      # (S, B, M)
    gate = (p_succ >= spec.admit_threshold).permute(2, 0, 1).contiguous()   # (M, S, B)

    # per-round tables, one row a round (nothing in the loop is made from
    # host data: a host-to-device copy would sync)
    i32, f32 = torch.int32, torch.float32
    ks_m, eg_m, eb_m, dl_m = (_per_round(x, b, rounds, i32, dev) for x in
                              (spec.kstar, spec.ell_g, spec.ell_b, spec.deadline_rel))
    n_valid = mask.to(i32).sum(dim=-1)                                  # (B,)
    tables = _Tables(
        counts=counts.t().contiguous(), gate=gate, kstar=ks_m, ell_g=eg_m, ell_b=eb_m,
        deadline_rel=dl_m,
        reserve_cap=_per_round(spec.reserve_cap, b, rounds, f32, dev),
        m_new=admission._ceil_div(ks_m, eg_m),
        speeds=torch.where(states == 1, mu_g[:, None, None],
                           mu_b[:, None, None]).transpose(0, 1).contiguous(),
        t_cut=t_cut, p_alloc=p_alloc.permute(2, 0, 1, 3).contiguous(),
    )
    if tap:
        rows = np.arange(b, dtype=np.int32) if tap_rows is None else np.asarray(tap_rows,
                                                                               np.int32)
        events, sojourn, admitted, q = _segmented_loop(tables, mask, n_valid, capacity,
                                                       grace, tap_stride, rows)
    else:
        q = rqueue.empty_queue(capacity, (s, b), device=dev)
        events, sojourn, admitted, q = _round_loop(tables, mask, n_valid, grace, q, 0, rounds)
    occupied = q.occupied

    to_bs = lambda x: x.permute(2, 1, 0, 3).contiguous()               # (M, S, B, Q) -> (B, S, M, Q)
    events_t = to_bs(events)
    count_ev = lambda code: (events_t == code).sum(dim=(-2, -1), dtype=i32)
    arrivals = counts.sum(dim=-1, dtype=i32)[:, None].expand(b, s).contiguous()
    admitted_t = admitted.sum(dim=0, dtype=i32).t().contiguous()       # (B, S)
    outcomes = ServingOutcomes(
        arrivals=arrivals,
        admitted=admitted_t,
        served_on_time=count_ev(EVENT_ON_TIME),
        served_late=count_ev(EVENT_LATE),
        rejected=arrivals - admitted_t,
        expired=count_ev(EVENT_EXPIRED),
        in_flight=occupied.sum(dim=-1, dtype=i32).t().contiguous(),
        events=events_t,
        sojourn=to_bs(sojourn),
    )
    if not telemetry:
        return outcomes
    # occupancy after round t's departures: what was admitted minus what
    # left, up to t (every leaving request has a nonzero event)
    left = (events != EVENT_NONE).sum(dim=-1, dtype=i32)                  # (M, S, B)
    occupancy = (admitted - left).cumsum(dim=0, dtype=i32)
    to_bsm = lambda x: x.permute(2, 1, 0).contiguous()                 # (M, S, B) -> (B, S, M)
    return outcomes, ServingTelemetry(
        arrivals_t=counts.to(i32), occupancy=to_bsm(occupancy),
        admitted_t=to_bsm(admitted.to(i32)),
        rejected_t=to_bsm(counts.t()[:, None, :].to(i32) - admitted))


def _spec_rows(spec: rqueue.RequestSpec, b: int, rounds: int, dev,
               per_round: bool) -> rqueue.RequestSpec:
    """Every field as a (B, 1) tensor, or (B, rounds) where ``per_round``
    and the field has a rounds axis."""
    def field(x, dtype):
        t = torch.as_tensor(x, dtype=dtype, device=dev)
        if per_round and t.dim() == 1 and t.shape[0] == rounds:
            return t[None].expand(b, rounds)
        return torch.broadcast_to(t, (b,))[:, None]
    i32, f32 = torch.int32, torch.float32
    return rqueue.RequestSpec(
        kstar=field(spec.kstar, i32), ell_g=field(spec.ell_g, i32),
        ell_b=field(spec.ell_b, i32), deadline_rel=field(spec.deadline_rel, i32),
        admit_threshold=field(spec.admit_threshold, f32),
        reserve_cap=field(spec.reserve_cap, f32),
    )


def sweep_serving(
    draws,
    pool_mask,
    p_gg,
    p_bb,
    mu_g,
    mu_b,
    deadline,
    spec: rqueue.RequestSpec,
    process,
    *,
    rounds: int,
    strategies: tuple[str, ...] = ("lea",),
    capacity: int = 4,
    grace: int = 0,
    channel: tuple = (),
    telemetry: bool = False,
    tap: bool = False,
    tap_stride: int | None = None,
    device=None,
):
    """Batched :func:`simulate_serving`: every input carries a leading (B,).

    ``p_gg`` / ``p_bb`` are (B, n), ``pool_mask`` (B, n) (or (n,)),
    ``mu_g`` / ``mu_b`` / ``deadline``, every ``spec`` field and every
    ``process`` parameter scalars or (B,) rows, so a whole arrival-rate x
    deadline x admission grid is one call: one admission-gate launch and
    one allocation launch a round for all of it.  The fault ``channel`` (if
    any) takes scalar or (B,) parameters.  ``draws`` is an int seed or a
    :class:`~repro_torch.random.Draws` that also answers
    :class:`~repro_torch.random.ArrivalDraws` (and
    :class:`~repro_torch.random.FaultDraws` with a channel).  Returns
    :class:`ServingOutcomes` of (B, S) counters and (B, S, rounds, Q)
    streams; with ``telemetry`` ``(outcomes, ServingTelemetry)``, every
    leaf with a leading (B,).  ``tap=True`` delivers one ``serving`` event
    a (row, strategy) every ``tap_stride`` rounds (default: once, at the
    end), ``row`` the batch index, while the loop runs.
    """
    dev = resolve_device(device)
    p_gg = torch.as_tensor(p_gg, dtype=torch.float32, device=dev)
    p_bb = torch.as_tensor(p_bb, dtype=torch.float32, device=dev)
    b, n = p_gg.shape
    mask = torch.broadcast_to(torch.as_tensor(pool_mask, dtype=torch.bool, device=dev),
                              (b, n)).contiguous()
    rows = lambda x: throughput._rows(x, b, torch.float32, dev)
    return _serving_batched(
        as_draws(draws, dev), mask, p_gg, p_bb, rows(mu_g), rows(mu_b), rows(deadline),
        _spec_rows(spec, b, rounds, dev, per_round=False), process, tuple(channel),
        rounds, tuple(strategies), capacity, grace, telemetry, tap, tap_stride)


def simulate_serving(
    draws,
    pool_mask,
    p_gg,
    p_bb,
    mu_g,
    mu_b,
    deadline,
    spec: rqueue.RequestSpec,
    process,
    *,
    rounds: int,
    strategies: tuple[str, ...] = ("lea",),
    capacity: int = 4,
    grace: int = 0,
    channel: tuple = (),
    telemetry: bool = False,
    tap: bool = False,
    tap_stride: int | None = None,
    device=None,
):
    """One serving simulation (see module docstring).

    ``pool_mask`` (n,) bool marks real workers; ``p_gg`` / ``p_bb`` (n,);
    ``spec`` a :class:`~repro_torch.serving.queue.RequestSpec` of scalars or
    (rounds,) rows; ``process`` a registered arrival process
    (:mod:`repro_torch.serving.arrivals`) with scalar parameters;
    ``strategies`` unique policy names (static draws are rejected —
    serving allocates from predictions); ``channel`` an optional time-axis
    fault channel; ``capacity`` queue slots and ``grace`` the
    late-completion window in rounds.  Returns :class:`ServingOutcomes` of
    (S,) counters and (S, rounds, Q) streams; with ``telemetry``
    ``(outcomes, ServingTelemetry)``.  ``tap`` / ``tap_stride`` as in
    :func:`sweep_serving`, events labelled ``row = -1``.
    """
    dev = resolve_device(device)
    p_gg = torch.as_tensor(p_gg, dtype=torch.float32, device=dev)[None]
    p_bb = torch.as_tensor(p_bb, dtype=torch.float32, device=dev)[None]
    mask = torch.as_tensor(pool_mask, dtype=torch.bool, device=dev).reshape(1, -1)
    rows = lambda x: throughput._rows(x, 1, torch.float32, dev)
    out = _serving_batched(
        as_draws(draws, dev), mask, p_gg, p_bb, rows(mu_g), rows(mu_b), rows(deadline),
        _spec_rows(spec, 1, rounds, dev, per_round=True), process, tuple(channel),
        rounds, tuple(strategies), capacity, grace, telemetry, tap, tap_stride, tap_rows=[-1])
    if not telemetry:
        return ServingOutcomes(*(x[0] for x in out))
    return (ServingOutcomes(*(x[0] for x in out[0])),
            ServingTelemetry(*(x[0] for x in out[1])))


__all__ = ["EVENT_EXPIRED", "EVENT_LATE", "EVENT_NONE", "EVENT_ON_TIME", "ServingOutcomes",
           "serving_compile_cache_size", "simulate_serving", "sweep_serving"]
