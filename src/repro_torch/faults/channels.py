"""Composable fault processes over engine trajectories, batched rows.

A fault process takes the "everything arrives" trace of a batch of rounds
and degrades it.  Every injector is a NamedTuple of parameters (Python
floats, or (B,) tensors that ride the batch's rows) with an
``apply(draws, position, trace)`` method, a pure function of the fault
uniforms it is handed, so

  * a *channel* (tuple of injectors) composes by folding the trace through
    each injector in order, injector ``i`` drawing as position ``i``;
  * one call scores a whole fault-parameter grid: each row carries its own
    parameters, the draws are shaped over the rows;
  * the same uniforms always give the same faults, so two decode modes
    scored "under the same fault traces" literally share the trace.

Randomness: an injector asks :class:`repro_torch.random.FaultDraws` for the
uniforms of its ``parts`` (``chain``, ``hit``, ``frac``, ``drop``,
``event``), named by its position in the channel.  In the JAX package the
position is a ``fold_in`` of the fault key; here it is an argument of the
draw, and the default source takes every fault uniform from a generator of
its own, so fault draws never move the trajectory, round or policy
uniforms, and two channels that share a prefix share that prefix's
faults exactly (on a position-keyed source).

The trace (:class:`FaultTrace`) separates the two physical failure axes:

  ``t_cut``  (B, rounds, n) float32 — the time at which worker i's round-m
             compute is CUT OFF (crash, preemption); the base value is the
             deadline itself.
  ``keep``   (B, rounds, n, r, packets) bool — per-packet network delivery.

Injectors are MONOTONE: ``t_cut`` only decreases and ``keep`` only loses
packets, so a channel never manufactures work and the all-or-nothing ⊆
conserving containment of :mod:`repro_torch.faults.packets` survives any
channel.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core.markov import sample_trajectory_from
from repro_torch.device import resolve_device
from repro_torch.random import FaultDraws, require


class FaultTrace(NamedTuple):
    """One batch of rounds' fault realisation (see module docstring)."""

    t_cut: torch.Tensor   # (B, rounds, n) float32 — compute cutoff time
    keep: torch.Tensor    # (B, rounds, n, r, packets) bool — network delivery

    @property
    def rows(self) -> int:
        return self.t_cut.shape[0]

    @property
    def rounds(self) -> int:
        return self.t_cut.shape[1]


def base_trace(rows: int, rounds: int, n: int, r: int, packets: int, deadline,
               *, device=None) -> FaultTrace:
    """The no-fault trace: the full deadline to compute, every packet
    delivered.  ``deadline`` is a scalar or a (rows,) tensor."""
    dev = resolve_device(device)
    d = torch.as_tensor(deadline, dtype=torch.float32, device=dev)
    d = d.reshape(-1, 1, 1) if d.dim() else d
    return FaultTrace(
        t_cut=torch.broadcast_to(d, (rows, rounds, n)).contiguous(),
        keep=torch.ones((rows, rounds, n, r, packets), dtype=torch.bool, device=dev),
    )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_INJECTORS: dict[str, type] = {}


def register_injector(name: str):
    """Decorator: register an injector class under ``name``."""

    def deco(cls):
        if name in _INJECTORS:
            raise ValueError(f"fault injector {name!r} already registered")
        _INJECTORS[name] = cls
        cls.injector_name = name
        return cls

    return deco


def injector_names() -> tuple[str, ...]:
    return tuple(sorted(_INJECTORS))


def make_injector(name: str, **params):
    """Build a registered injector from keyword parameters."""
    if name not in _INJECTORS:
        raise KeyError(
            f"unknown fault injector {name!r}; available: "
            f"{', '.join(injector_names())}"
        )
    return _INJECTORS[name](**params)


def make_channel(spec: Sequence[tuple[str, dict]]) -> tuple:
    """((name, params), ...) -> a channel: an ordered tuple of injectors."""
    return tuple(make_injector(name, **params) for name, params in spec)


def apply_channel(draws, channel: Sequence, trace: FaultTrace) -> FaultTrace:
    """Fold the trace through every injector, injector ``i`` drawing as
    position ``i`` of ``draws`` (a :class:`~repro_torch.random.FaultDraws`).

    A realisation depends on the injector ORDER as well as the draws: two
    channels sharing a prefix share that prefix's faults exactly.
    """
    if channel:
        require(draws, FaultDraws)
    for i, inj in enumerate(channel):
        trace = inj.apply(draws, i, trace)
    return trace


def _param(x, trace: FaultTrace, trailing: int) -> torch.Tensor:
    """A scalar or (B,) parameter as float32 on the trace's device, shaped
    to broadcast against a (B, ...) tensor with ``trailing`` more axes."""
    t = torch.as_tensor(x, dtype=torch.float32, device=trace.t_cut.device)
    if t.dim() == 0:
        return t
    if t.shape != (trace.rows,):
        raise ValueError(f"a per-row parameter must be ({trace.rows},), "
                         f"got {tuple(t.shape)}")
    return t.reshape((trace.rows,) + (1,) * trailing)


def _draw(draws, position: int, part: str, trace: FaultTrace, shape) -> torch.Tensor:
    u = draws.fault(trace.rows, position, part, tuple(shape))
    return u.to(trace.t_cut.device)


def _chain(draws, position: int, trace: FaultTrace, p_stay1, p_stay0) -> torch.Tensor:
    """(B, rounds, n) alive / good chain per worker, starting in state 1."""
    rounds, n = trace.t_cut.shape[1:]
    init = torch.ones((trace.rows, n), dtype=torch.int32, device=trace.t_cut.device)
    u = _draw(draws, position, "chain", trace, (rounds - 1, n)) if rounds > 1 else None
    return sample_trajectory_from(u, p_stay1, p_stay0, init)


# ---------------------------------------------------------------------------
# built-in injectors
# ---------------------------------------------------------------------------


@register_injector("crash_restart")
class CrashRestart(NamedTuple):
    """Worker crash/restart: a persistent alive/crashed chain per worker.

    Every worker runs an independent 2-state chain over rounds, starting
    ALIVE: an alive worker crashes with probability ``p_crash`` per round
    and a crashed one restarts with probability ``p_restart``.  A crashed
    worker's round produces nothing (``t_cut`` -> 0); its stored chunks
    survive the restart (the executor's ``mark_dead`` models the permanent
    variant).
    """

    p_crash: float | torch.Tensor
    p_restart: float | torch.Tensor

    parts = ("chain",)

    def apply(self, draws, position: int, trace: FaultTrace) -> FaultTrace:
        alive = _chain(draws, position, trace,
                       1.0 - _param(self.p_crash, trace, 2),
                       1.0 - _param(self.p_restart, trace, 2))
        return trace._replace(t_cut=torch.where(alive == 1, trace.t_cut, 0.0))


@register_injector("preempt")
class Preempt(NamedTuple):
    """Preemption ramp: a hit worker keeps only a fraction of its round.

    With probability ``p_preempt`` per (round, worker), the worker is
    reclaimed mid-round at a uniform fraction in [``min_frac``, 1) of its
    remaining cutoff: ``t_cut -> frac * t_cut``.  Work finished before the
    preemption point survives — exactly the partial results the conserving
    decode (and the hierarchical layer) exist to harvest.
    """

    p_preempt: float | torch.Tensor
    min_frac: float | torch.Tensor = 0.0

    parts = ("hit", "frac")

    def apply(self, draws, position: int, trace: FaultTrace) -> FaultTrace:
        shape = trace.t_cut.shape[1:]
        hit = _draw(draws, position, "hit", trace, shape) < _param(self.p_preempt, trace, 2)
        min_frac = _param(self.min_frac, trace, 2)
        frac = min_frac + (1.0 - min_frac) * _draw(draws, position, "frac", trace, shape)
        return trace._replace(t_cut=torch.where(hit, frac * trace.t_cut, trace.t_cut))


@register_injector("packet_bernoulli")
class PacketBernoulli(NamedTuple):
    """iid per-packet erasure: every packet is dropped with prob ``p_drop``."""

    p_drop: float | torch.Tensor

    parts = ("drop",)

    def apply(self, draws, position: int, trace: FaultTrace) -> FaultTrace:
        u = _draw(draws, position, "drop", trace, trace.keep.shape[1:])
        return trace._replace(keep=trace.keep & (u >= _param(self.p_drop, trace, 4)))


@register_injector("gilbert_elliott")
class GilbertElliott(NamedTuple):
    """Gilbert-Elliott bursty packet loss: a 2-state channel per worker link.

    Each worker's link runs a good/bad channel chain over rounds (starting
    good): good -> bad with ``p_gb``, bad -> good with ``p_bg``; packets
    drop with ``drop_good`` in the good state and ``drop_bad`` in the bad
    one — the classic bursty-erasure model of the packet-erasure-channel
    literature (arXiv 1901.03610).
    """

    p_gb: float | torch.Tensor
    p_bg: float | torch.Tensor
    drop_good: float | torch.Tensor = 0.0
    drop_bad: float | torch.Tensor = 0.5

    parts = ("chain", "drop")

    def apply(self, draws, position: int, trace: FaultTrace) -> FaultTrace:
        good = _chain(draws, position, trace,
                      1.0 - _param(self.p_gb, trace, 2),
                      1.0 - _param(self.p_bg, trace, 2))
        p = torch.where(good == 1, _param(self.drop_good, trace, 2),
                        _param(self.drop_bad, trace, 2))
        u = _draw(draws, position, "drop", trace, trace.keep.shape[1:])
        return trace._replace(keep=trace.keep & (u >= p[..., None, None]))


@register_injector("burst")
class Burst(NamedTuple):
    """Correlated burst loss: one shared event wipes a packet-tail fleet-wide.

    With probability ``p_event`` per round, EVERY worker loses its last
    ``frac`` fraction of packet indices that round (a shared network event —
    switch congestion, a rack brown-out) — the correlated-loss regime where
    per-worker redundancy cannot help but per-packet position can.
    """

    p_event: float | torch.Tensor
    frac: float | torch.Tensor = 0.5

    parts = ("event",)

    def apply(self, draws, position: int, trace: FaultTrace) -> FaultTrace:
        rounds, packets = trace.keep.shape[1], trace.keep.shape[-1]
        hit = _draw(draws, position, "event", trace, (rounds,)) < _param(
            self.p_event, trace, 1)                                   # (B, rounds)
        # packet index q survives a burst iff q/packets < 1 - frac
        pos = torch.arange(packets, dtype=torch.float32,
                           device=trace.keep.device) / packets        # (packets,)
        survive = pos < (1.0 - _param(self.frac, trace, 1))           # (B|1, packets)
        if survive.dim() == 1:
            survive = survive[None]
        keep = trace.keep & (survive[:, None, None, None, :]
                             | ~hit[:, :, None, None, None])
        return trace._replace(keep=keep)


__all__ = ["FaultTrace", "apply_channel", "base_trace", "injector_names",
           "make_channel", "make_injector", "register_injector"]
