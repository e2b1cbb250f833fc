"""Registered arrival processes: batched request streams on the device.

An arrival process turns draws into a ``(rows, rounds) int32`` tensor of
per-round request counts.  Every process is a NamedTuple of parameters —
Python numbers, or (rows,) tensors that ride the batch's rows — with a
``sample(draws, rows, rounds, device)`` method that is a pure function of
the variates it is handed (an :class:`~repro_torch.random.ArrivalDraws`):

  * one call samples a whole grid of rates, each row with its own
    parameters (the ``arrival_grid`` family);
  * :class:`~repro_torch.random.TorchDraws` takes arrival variates from a
    generator of its own (the JAX package's ``arrival_key`` tag), so
    arrivals never move the trajectory, policy or fault draws.  A
    zero-arrival serving run is therefore the idle engine.

Built-ins:

  ``constant``   — exactly ``per_round`` requests every round (takes no
                   draws; the degenerate one-job-per-round stream).
  ``poisson``    — iid Poisson(rate) counts per round.
  ``shift_exp``  — shift-exponential inter-arrival gaps, the paper's
                   Sec. 6.2 request model: gap = t_const + Exp(mean) in
                   round units, event times binned into rounds.
  ``mmpp``       — Markov-modulated Poisson (bursty): a 2-state calm/burst
                   chain modulates the per-round Poisson rate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.markov import sample_trajectory_from
from repro_torch.device import resolve_device
from repro_torch.random import ArrivalDraws, require

# shift_exp materialises at most this many events per simulated round; a
# stream denser than this (mean gap << 1/density rounds) is truncated
_SHIFT_EXP_DENSITY = 8

# block width of the event-time prefix sum (see _blocked_cumsum)
_CUMSUM_BLOCK = 16


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_PROCESSES: dict[str, type] = {}


def register_process(name: str):
    """Decorator: register an arrival-process class under ``name``."""

    def deco(cls):
        if name in _PROCESSES:
            raise ValueError(f"arrival process {name!r} already registered")
        _PROCESSES[name] = cls
        cls.process_name = name
        return cls

    return deco


def process_names() -> tuple[str, ...]:
    return tuple(sorted(_PROCESSES))


def make_process(name: str, **params):
    """Build a registered arrival process from keyword parameters."""
    if name not in _PROCESSES:
        raise KeyError(
            f"unknown arrival process {name!r}; available: "
            f"{', '.join(process_names())}"
        )
    return _PROCESSES[name](**params)


def sample_arrivals(draws, process, rows: int, rounds: int, *, device=None) -> torch.Tensor:
    """(rows, rounds) int32 per-round request counts of ``process``.

    ``draws`` answers :class:`~repro_torch.random.ArrivalDraws` wherever the
    process takes variates (``constant`` takes none).
    """
    dev = resolve_device(device)
    return process.sample(draws, rows, rounds, dev).to(torch.int32)


def _param(x, rows: int, dev, trailing: int = 1) -> torch.Tensor:
    """A scalar or (rows,) parameter as float32, shaped to broadcast against
    a (rows, ...) tensor with ``trailing`` more axes."""
    t = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if t.dim() == 0:
        return t
    if t.shape != (rows,):
        raise ValueError(f"a per-row parameter must be ({rows},), got {tuple(t.shape)}")
    return t.reshape((rows,) + (1,) * trailing)


def _arrival_draws(draws):
    return require(draws, ArrivalDraws)


def _inclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Sequential float32 prefix sums along the last axis."""
    acc = x[..., 0]
    out = [acc]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
        out.append(acc)
    return torch.stack(out, dim=-1)


def _blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Float32 prefix sums along the last axis, in the JAX package's order.

    XLA on the CPU computes ``jnp.cumsum`` as a blocked reduce-window: the
    axis is padded with zeros to a multiple of 16 and cut into blocks of
    16, each block is summed sequentially from its first element, the
    block totals get the same treatment recursively, and every element
    adds its block's exclusive prefix.  The event times of ``shift_exp``
    are binned by ``floor``, so the summation order decides which round an
    event near a boundary lands in; this repeats that order with float32
    adds, which give the same bits on the CPU and on the card.
    """
    n = x.shape[-1]
    if n <= _CUMSUM_BLOCK:
        return _inclusive_scan(x)
    blocks = -(-n // _CUMSUM_BLOCK)
    pad = blocks * _CUMSUM_BLOCK - n
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    within = _inclusive_scan(xp.reshape(x.shape[:-1] + (blocks, _CUMSUM_BLOCK)))
    totals = _blocked_cumsum(within[..., -1])
    excl = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    out = within + excl[..., None]
    return out.reshape(x.shape[:-1] + (blocks * _CUMSUM_BLOCK,))[..., :n]


# ---------------------------------------------------------------------------
# built-in processes
# ---------------------------------------------------------------------------


@register_process("constant")
class Constant(NamedTuple):
    """Exactly ``per_round`` requests every round (no draws taken).

    ``per_round = 1`` is the degenerate stream that reduces the serving
    engine to the offline single-job engine; ``per_round = 0`` is the idle
    stream of the zero-arrival property.
    """

    per_round: float | torch.Tensor = 1

    def sample(self, draws, rows: int, rounds: int, dev) -> torch.Tensor:
        per = _param(self.per_round, rows, dev).to(torch.int32)
        return torch.broadcast_to(per, (rows, rounds)).contiguous()


@register_process("poisson")
class Poisson(NamedTuple):
    """iid Poisson(rate) request counts per round."""

    rate: float | torch.Tensor

    def sample(self, draws, rows: int, rounds: int, dev) -> torch.Tensor:
        lam = torch.broadcast_to(_param(self.rate, rows, dev), (rows, rounds))
        return _arrival_draws(draws).poisson(lam.contiguous()).to(dev, torch.int32)


@register_process("shift_exp")
class ShiftExp(NamedTuple):
    """Shift-exponential inter-arrival gaps (paper Sec. 6.2's model).

    Successive gaps are ``t_const + Exp(mean)`` in ROUND units; the event
    times (their running sum) are binned into rounds.  A static budget of
    ``_SHIFT_EXP_DENSITY * rounds`` events is drawn — streams denser than
    that (mean rate above ~8 requests/round) are truncated, which is far
    past any serviceable load for the pools this repo simulates.  The gap
    is one fused multiply-add (formed in float64, rounded once to float32)
    and the running sum follows :func:`_blocked_cumsum`, as the JAX package
    computes them on the CPU; the binning is a ``scatter_add_`` on the
    device.
    """

    t_const: float | torch.Tensor = 0.0
    mean: float | torch.Tensor = 1.0

    def sample(self, draws, rows: int, rounds: int, dev) -> torch.Tensor:
        max_events = _SHIFT_EXP_DENSITY * rounds
        t_c = _param(self.t_const, rows, dev)
        mean = _param(self.mean, rows, dev)
        e = _arrival_draws(draws).exponential(rows, max_events).to(dev, torch.float32)
        gaps = (t_c.double() + mean.double() * e.double()).float()
        idx = torch.floor(_blocked_cumsum(gaps)).to(torch.int32)
        valid = (idx < rounds).to(torch.int32)
        counts = torch.zeros((rows, rounds), dtype=torch.int32, device=dev)
        return counts.scatter_add_(1, idx.clamp(0, rounds - 1).long(), valid)


@register_process("mmpp")
class MMPP(NamedTuple):
    """Markov-modulated Poisson process: bursty arrivals.

    A 2-state calm/burst chain (starting calm) modulates the per-round
    Poisson rate between ``rate_lo`` and ``rate_hi`` — the bursty-traffic
    regime where admission control earns its keep.  ``p_stay_lo`` /
    ``p_stay_hi`` are the chain's self-transition probabilities; state 1
    is calm, so ``p_stay_lo`` is P[1 -> 1].
    """

    rate_lo: float | torch.Tensor
    rate_hi: float | torch.Tensor
    p_stay_lo: float | torch.Tensor = 0.9
    p_stay_hi: float | torch.Tensor = 0.7

    def sample(self, draws, rows: int, rounds: int, dev) -> torch.Tensor:
        src = _arrival_draws(draws)
        u = src.chain(rows, rounds).to(dev, torch.float32) if rounds > 1 else None
        init = torch.ones((rows, 1), dtype=torch.int32, device=dev)
        calm = sample_trajectory_from(u, _param(self.p_stay_lo, rows, dev, 2),
                                      _param(self.p_stay_hi, rows, dev, 2),
                                      init)[..., 0]                   # (rows, rounds)
        lam = torch.where(calm == 1, _param(self.rate_lo, rows, dev),
                          _param(self.rate_hi, rows, dev))
        return src.poisson(lam.contiguous()).to(dev, torch.int32)


__all__ = ["Constant", "MMPP", "Poisson", "ShiftExp", "make_process", "process_names",
           "register_process", "sample_arrivals"]
