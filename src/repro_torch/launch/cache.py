"""The persistent compile cache (opt-in via ``REPRO_COMPILE_CACHE``).

The JAX package turns on JAX's persistent compilation cache, so a restarted
process skips the XLA compile of every family it has seen.  The port
compiles nothing per family: what it compiles are its CUDA sources, each
into a hash-keyed shared library (:mod:`repro_torch.kernels.build`).  That
library directory is the port's persistent cache, and
:func:`enable_compile_cache` is the one switch that moves it:

  * reads ``REPRO_COMPILE_CACHE=<dir>`` (or an explicit ``path``) -- unset
    means disabled: returns ``None`` and changes nothing, and libraries stay
    under ``build/repro_torch/`` of the checkout;
  * points :func:`repro_torch.kernels.build.build_dir` at the directory, so
    every process given the same directory builds each source once and
    loads it from there afterwards.

A library found built is a hit (:func:`repro_torch.obs.counters.persistent_cache_hits`)
and a build is a miss (:func:`persistent_cache_misses`): a warm process
shows 0 compile events (:func:`repro_torch.obs.counters.backend_compile_events`).

Callers: :mod:`repro_torch.launch.serve` calls this before any work, as the
JAX package's CLIs do; it is idempotent per process.  Libraries a process
loaded before the switch stay loaded.
"""

from __future__ import annotations

import os
from pathlib import Path

CACHE_ENV = "REPRO_COMPILE_CACHE"

_STATE = {"enabled_dir": None}


def persistent_cache_misses() -> int:
    """Libraries ``nvcc`` built into the cache this process (0 unless enabled)."""
    from repro_torch.kernels import build

    target = _STATE["enabled_dir"]
    if target is None:
        return 0
    return sum(1 for result in build.builds().values()
               if result.seconds > 0.0 and result.path.parent == Path(target))


def cache_dir() -> str | None:
    """The directory the cache was enabled with, or None."""
    return _STATE["enabled_dir"]


def enable_compile_cache(path: str | None = None) -> str | None:
    """Enable the persistent compile cache if configured; returns the dir.

    ``path`` overrides the ``REPRO_COMPILE_CACHE`` environment variable.
    Returns ``None`` (and changes nothing) when neither is set.  Safe to
    call repeatedly; re-enabling with a DIFFERENT directory raises -- a
    process mixing library directories would count its own builds twice.
    """
    from repro_torch.kernels import build

    target = path if path is not None else os.environ.get(CACHE_ENV)
    if not target:
        return None
    target = os.path.abspath(target)
    if _STATE["enabled_dir"] is not None:
        if _STATE["enabled_dir"] != target:
            raise RuntimeError(
                f"compile cache already enabled at {_STATE['enabled_dir']!r}; "
                f"cannot re-enable at {target!r}"
            )
        return target
    os.makedirs(target, exist_ok=True)
    build.set_build_dir(target)
    _STATE["enabled_dir"] = target
    return target


__all__ = ["CACHE_ENV", "cache_dir", "enable_compile_cache", "persistent_cache_misses"]
