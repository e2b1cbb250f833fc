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


class TorchDraws:
    """The default :class:`Draws`: one ``torch.Generator`` on the device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

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


__all__ = ["Draws", "TorchDraws", "as_draws", "torch_draws"]
