"""The one place where the port draws random numbers.

The engine separates DRAWING uniforms from TRANSFORMING them.  Every
random quantity the throughput engine consumes is a float32 uniform in
[0, 1) at a fixed position, asked for through the three calls of
:class:`Draws` (plus the one-shot draw of the ``static_single`` strategy):

  * ``initial(rows, n)``                        — the stationary initial
    worker states, (rows, n);
  * ``steps(rows, rounds, n)``                  — the Markov transition
    uniforms of rounds 1..M-1, (rows, M-1, n);
  * ``static(rows, rounds, start, stop, n, t)`` — the static rejection
    resampler's uniforms for try ``t`` of rounds ``start:stop``,
    (rows, stop-start, n);
  * ``single(rows, rounds, start, stop, n)``    — ``static_single``'s one
    draw per round, (rows, stop-start, n).

Everything downstream (comparisons against transition probabilities,
stationary draws, two-level loads) is deterministic, so any source that
yields the same uniforms yields the same trajectories, allocations and
per-round successes.  The default source is :class:`TorchDraws` on a
``torch.Generator`` on the target device.  Tests hand the engine a source
backed by ``jax.random`` that replays, position for position, the uniforms
the JAX package draws on the same key — bit-level parity of the whole
engine without porting threefry.  The port never imports that source.

Two more kinds of draws live in protocols of their own, checked only
where they are taken, so a source built for the engine alone still
passes :func:`as_draws`:

  * :class:`FaultDraws` — ``fault(rows, position, part, shape)``, the
    uniforms of part ``part`` of the fault injector at ``position`` of a
    channel, (rows, *shape).  The parts: ``chain`` (rounds-1, n) transition
    uniforms, ``hit`` / ``frac`` (rounds, n), ``drop`` (rounds, n, r,
    packets) and ``event`` (rounds,) (:mod:`repro_torch.faults.channels`);
  * :class:`BetaDraws` — ``beta(a, b)``, one Beta(a, b) variate per element
    of the float32 tensors ``a`` and ``b`` (``thompson``'s posterior draws);
  * :class:`ArrivalDraws` — the serving layer's request arrivals
    (:mod:`repro_torch.serving.arrivals`).  Poisson and exponential
    samplers do not consume a fixed number of uniforms, so this protocol
    hands out *variates*: ``poisson(rate)`` one int32 Poisson count per
    element of a float32 ``rate`` tensor, ``exponential(rows, count)``
    (rows, count) float32 Exp(1) variates, and ``chain(rows, rounds)`` the
    (rows, rounds - 1, 1) transition uniforms of the ``mmpp`` calm/burst
    chain.

:class:`RecordedDraws` keeps a copy of every draw another source hands
out and :class:`ReplayedDraws` hands them out again, so a run on the card
can be repeated on the CPU with the same numbers.

:class:`TorchDraws` takes each of these from a generator of its own,
seeded from the engine generator's seed and a fixed tag, so asking for
fault, Beta or arrival draws never moves the engine's uniforms: a run
with no channel (or an empty one) and no randomised policy draws exactly
what :func:`~repro_torch.core.throughput.simulate_strategies_pool` draws,
whatever its arrivals.

Stream note: :class:`TorchDraws` hands out its generator's numbers in call
order, so a chunked run (``round_chunk``) draws the static resampler's
numbers block by block and its stream differs from the unchunked run's
(same distribution, other numbers).  Position-keyed sources such as the
jax replay give identical results either way.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

from .device import resolve_device


@runtime_checkable
class Draws(Protocol):
    """A source of float32 uniforms for the engine (see module docstring)."""

    def initial(self, rows: int, n: int) -> torch.Tensor: ...

    def steps(self, rows: int, rounds: int, n: int) -> torch.Tensor: ...

    def static(self, rows: int, rounds: int, start: int, stop: int, n: int,
               try_index: int) -> torch.Tensor: ...

    def single(self, rows: int, rounds: int, start: int, stop: int,
               n: int) -> torch.Tensor: ...


@runtime_checkable
class FaultDraws(Protocol):
    """A source of the fault channels' float32 uniforms (module docstring)."""

    def fault(self, rows: int, position: int, part: str,
              shape: tuple[int, ...]) -> torch.Tensor: ...


@runtime_checkable
class BetaDraws(Protocol):
    """A source of Beta variates for randomised policies."""

    def beta(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor: ...


@runtime_checkable
class ArrivalDraws(Protocol):
    """A source of the arrival processes' variates (module docstring)."""

    def poisson(self, rate: torch.Tensor) -> torch.Tensor: ...

    def exponential(self, rows: int, count: int) -> torch.Tensor: ...

    def chain(self, rows: int, rounds: int) -> torch.Tensor: ...


# tags of the derived generators (the JAX package's fold_in tags of the
# fault, policy and arrival streams)
FAULT_TAG = 0x7F4A7C15 % (2**31)
POLICY_TAG = 0x9E3779B9 % (2**31)
ARRIVAL_TAG = 0x5BD1E995 % (2**31)


class TorchDraws:
    """The default source of every draw: ``torch.Generator`` s on the device.

    Engine uniforms come from ``generator``; fault uniforms, Beta variates
    and arrival variates from generators of their own, made on first use
    and seeded with the engine generator's initial seed plus a tag.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device
        self._derived: dict[int, torch.Generator] = {}

    def _stream(self, tag: int) -> torch.Generator:
        gen = self._derived.get(tag)
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed((self.generator.initial_seed() + tag) % (2**63))
            self._derived[tag] = gen
        return gen

    def _uniform(self, *shape: int) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device,
                          dtype=torch.float32)

    def initial(self, rows, n):
        return self._uniform(rows, n)

    def steps(self, rows, rounds, n):
        return self._uniform(rows, max(rounds - 1, 0), n)

    def static(self, rows, rounds, start, stop, n, try_index):
        return self._uniform(rows, stop - start, n)

    def single(self, rows, rounds, start, stop, n):
        return self._uniform(rows, stop - start, n)

    def fault(self, rows, position, part, shape):
        return torch.rand((rows,) + tuple(shape), generator=self._stream(FAULT_TAG),
                          device=self.device, dtype=torch.float32)

    def beta(self, a, b):
        gen = self._stream(POLICY_TAG)
        x = torch._standard_gamma(a.to(self.device, torch.float32), generator=gen)
        y = torch._standard_gamma(b.to(self.device, torch.float32), generator=gen)
        return x / (x + y)

    def poisson(self, rate):
        rate = rate.to(self.device, torch.float32)
        return torch.poisson(rate, generator=self._stream(ARRIVAL_TAG)).to(torch.int32)

    def exponential(self, rows, count):
        out = torch.empty((rows, count), dtype=torch.float32, device=self.device)
        return out.exponential_(generator=self._stream(ARRIVAL_TAG))

    def chain(self, rows, rounds):
        return torch.rand((rows, max(rounds - 1, 0), 1), generator=self._stream(ARRIVAL_TAG),
                          device=self.device, dtype=torch.float32)


class RecordedDraws:
    """Hands out another source's draws and keeps a CPU copy of each, in
    call order, with the call's kind (``initial``, ``steps``, ``static``,
    ``single``, ``fault``, ``beta``, ``poisson``, ``exponential`` or
    ``chain``), so that :class:`ReplayedDraws` can
    hand the same numbers to a run on another device."""

    def __init__(self, inner):
        self.inner, self.calls, self.kinds = inner, [], []

    def _keep(self, kind: str, t: torch.Tensor) -> torch.Tensor:
        self.calls.append(t.cpu())
        self.kinds.append(kind)
        return t

    def initial(self, *a):
        return self._keep("initial", self.inner.initial(*a))

    def steps(self, *a):
        return self._keep("steps", self.inner.steps(*a))

    def static(self, *a):
        return self._keep("static", self.inner.static(*a))

    def single(self, *a):
        return self._keep("single", self.inner.single(*a))

    def fault(self, *a):
        return self._keep("fault", self.inner.fault(*a))

    def beta(self, *a):
        return self._keep("beta", self.inner.beta(*a))

    def poisson(self, *a):
        return self._keep("poisson", self.inner.poisson(*a))

    def exponential(self, *a):
        return self._keep("exponential", self.inner.exponential(*a))

    def chain(self, *a):
        return self._keep("chain", self.inner.chain(*a))


class ReplayedDraws:
    """Hands out recorded draws (:attr:`RecordedDraws.calls`) in order,
    whatever the call.  With ``row``, only that row of each: a one-row run
    replays one row of a batched run's draws."""

    def __init__(self, calls, row: int | None = None):
        self.calls, self.row = list(calls), row

    def _next(self, *a):
        t = self.calls.pop(0)
        return t if self.row is None else t[self.row:self.row + 1]

    initial = steps = static = single = fault = beta = _next
    poisson = exponential = chain = _next


def require(draws, protocol):
    """``draws`` if it answers ``protocol``'s calls, else ``TypeError``."""
    if not isinstance(draws, protocol):
        raise TypeError(f"{type(draws).__name__} does not answer "
                        f"{protocol.__name__}'s calls")
    return draws


def torch_draws(seed: int, device=None) -> TorchDraws:
    """A :class:`TorchDraws` on a fresh generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return TorchDraws(gen)


def as_draws(draws, device) -> Draws:
    """An int seeds a fresh :class:`TorchDraws`; a :class:`Draws` passes."""
    if isinstance(draws, bool):
        raise TypeError("draws must be a Draws or an int seed, not a bool")
    if isinstance(draws, int):
        return torch_draws(draws, device)
    if isinstance(draws, Draws):
        return draws
    raise TypeError(f"draws must be a Draws or an int seed, got {type(draws)!r}")


__all__ = ["ARRIVAL_TAG", "ArrivalDraws", "BetaDraws", "Draws", "FaultDraws",
           "RecordedDraws", "ReplayedDraws", "TorchDraws", "as_draws", "require",
           "torch_draws"]
