"""The unified compile-event and kernel-launch counters.

The JAX package counts compiled computations: every jitted entry point
registers its trace cache here and "did this sweep add a compile?" is one
question.  The port compiles nothing per signature; what it compiles are
its CUDA kernels, each source once per checkout (``nvcc`` into
``build/repro_torch/``, hash-keyed).  So a port *compile event* is an
``nvcc`` run in this process, read from
:data:`repro_torch.kernels.build._BUILDS`: every source registers a
counter ``build.<source>`` here (1 once ``nvcc`` built it in this process,
else 0), and :func:`compile_events` sums them::

    before = obs.compile_events()
    ... run any mix of sweep families ...
    assert obs.compile_events() - before == 0     # nothing rebuilt

A library found already built is a *persistent-cache hit*
(:func:`persistent_cache_hits`; a :class:`~repro_torch.kernels.build.BuildResult`
with ``seconds == 0.0``) — the port's counterpart of the JAX package's
persistent compilation cache, and what a warm process shows: 0 compile
events, one hit a source.

The second registry answers "which kernels did this run launch": each
kernel module registers its ``launch_counts`` / ``reset_launch_counts``
pair at import (:func:`register_launches`), and :func:`launch_counts` /
:func:`reset_launch_counts` read and reset them all.  A module never
imported launched nothing.

``register_compiled`` keeps the JAX package's API for any other counter
(a zero-arg callable returning an int).  Counters are monotonic per
process; deltas around a call window are the meaningful quantity.
Registration is idempotent by name.
"""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable[[], int]] = {}
_LAUNCHES: dict[str, tuple[Callable[[], dict[str, int]], Callable[[], None]]] = {}


def _builds() -> dict:
    from repro_torch.kernels import build

    return build._BUILDS


def _nvcc_runs(source: str) -> int:
    result = _builds().get(source)
    return int(result is not None and result.seconds > 0.0)


def _register_sources() -> None:
    from repro_torch.kernels import build

    for source in build.sources():
        _REGISTRY.setdefault(f"build.{source}", lambda s=source: _nvcc_runs(s))


def register_compiled(name: str, counter) -> None:
    """Register a compile-event counter under ``name``.

    ``counter`` is a zero-arg callable returning an int (or anything with a
    ``_cache_size()`` hook, as in the JAX package).
    """
    hook = getattr(counter, "_cache_size", counter)
    if not callable(hook):
        raise TypeError(f"{name!r}: {counter!r} has no _cache_size and is not callable")
    _REGISTRY[name] = hook


def counter_names() -> tuple[str, ...]:
    """Registered counter names, sorted (``build.<source>`` for every source)."""
    _register_sources()
    return tuple(sorted(_REGISTRY))


def compile_events(name: str | None = None) -> int:
    """Compile events so far: one named counter, or the sum of all.

    With ``name=None`` the value is the number of ``nvcc`` runs in this
    process (plus any counter registered by hand).
    """
    _register_sources()
    if name is None:
        return sum(int(hook()) for hook in _REGISTRY.values())
    if name not in _REGISTRY:
        raise KeyError(f"no compile counter {name!r}; registered: {counter_names()}")
    return int(_REGISTRY[name]())


def persistent_cache_hits() -> int:
    """Kernel libraries loaded from ``build/repro_torch/`` without ``nvcc``
    in this process (``BuildResult.seconds == 0.0``)."""
    return sum(1 for result in _builds().values() if result.seconds == 0.0)


def register_launches(module: str, counts: Callable[[], dict[str, int]],
                      reset: Callable[[], None]) -> None:
    """Register a kernel module's launch counters (its wrappers' names ->
    launches since its last reset) under ``module``."""
    if not (callable(counts) and callable(reset)):
        raise TypeError(f"{module!r}: launch counters must be callables")
    _LAUNCHES[module] = (counts, reset)


def launch_counts() -> dict[str, int]:
    """Every registered wrapper's launches since the last reset."""
    out: dict[str, int] = {}
    for module in sorted(_LAUNCHES):
        out.update(_LAUNCHES[module][0]())
    return out


def reset_launch_counts() -> None:
    """Set every registered wrapper's launch count to 0."""
    for _, reset in _LAUNCHES.values():
        reset()
