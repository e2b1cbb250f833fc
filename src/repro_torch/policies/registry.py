"""Policy registry: named schedulers the engine resolves strategy strings to.

Registration mirrors ``repro_torch.sweeps``: ``@register("name", ...)`` wraps a
trajectory function into a :class:`~repro_torch.policies.api.Policy`, or
:func:`register_policy` adds a ready-made instance.  The engine
(:mod:`repro_torch.core.throughput`) resolves every non-static strategy name
through :func:`resolve`, so a new scheduler becomes a legal
``strategies=(...)`` entry everywhere — ``simulate_strategies``, ``sweep``,
the sweeps executor — the moment it is registered.

Parameterised names: windowed and discounted LEA form families, so
``resolve`` also accepts dynamic spellings —

  * ``lea_window<W>``    (e.g. ``lea_window48``)  — sliding window of W
    transitions;
  * ``lea_discount<D>``  (e.g. ``lea_discount97`` = gamma 0.97,
    ``lea_discount995`` = gamma 0.995; gamma = D / 10**len(D)).

Dynamic resolutions are memoised into the registry, so repeated lookups
return the same :class:`Policy` object.
"""

from __future__ import annotations

import re
from typing import Callable

from .api import Policy

_POLICIES: dict[str, Policy] = {}
_BUILTINS_LOADED = False

_WINDOW_RE = re.compile(r"^lea_window(\d+)$")
_DISCOUNT_RE = re.compile(r"^lea_discount(\d+)$")


def register_policy(policy: Policy) -> Policy:
    """Add a ready-made Policy; duplicate names are an error."""
    if policy.name in _POLICIES:
        raise ValueError(f"policy {policy.name!r} already registered")
    _POLICIES[policy.name] = policy
    return policy


def register(
    name: str,
    *,
    uses_model: bool = False,
    description: str = "",
):
    """Decorator: register ``fn(ctx) -> (B, M, n)`` as policy ``name``."""

    def deco(fn: Callable) -> Callable:
        desc = description or (fn.__doc__ or "").strip()
        register_policy(Policy(
            name=name, trajectory=fn, uses_model=uses_model,
            description=desc.splitlines()[0] if desc else "",
        ))
        return fn

    return deco


def _ensure_builtins() -> None:
    # built-in policies live in estimators.py; importing it registers them.
    # The flag is set only AFTER the import succeeds: a failed import (e.g. a
    # user pre-registered a builtin name) must not latch a half-populated
    # registry — the next call retries and surfaces the real error.
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        from . import estimators  # noqa: F401

        _BUILTINS_LOADED = True


def _resolve_dynamic(name: str) -> Policy | None:
    """Materialise a parameterised family member (memoised into _POLICIES)."""
    from . import estimators

    m = _WINDOW_RE.match(name)
    if m:
        window = int(m.group(1))
        if window < 1:
            raise KeyError(f"{name!r}: window must be >= 1")
        return register_policy(estimators.windowed_lea(window, name=name))
    m = _DISCOUNT_RE.match(name)
    if m:
        digits = m.group(1)
        gamma = int(digits) / 10 ** len(digits)
        if not 0.0 < gamma < 1.0:
            raise KeyError(f"{name!r}: discount must be in (0, 1)")
        return register_policy(estimators.discounted_lea(gamma, name=name))
    return None


def is_registered(name: str) -> bool:
    """Would :func:`resolve` succeed?  Dynamic spellings are checked against
    the same parameter bounds resolve enforces (``lea_window0`` and
    ``lea_discount0`` are invalid, not merely unresolved-yet)."""
    _ensure_builtins()
    if name in _POLICIES:
        return True
    m = _WINDOW_RE.match(name)
    if m:
        return int(m.group(1)) >= 1
    m = _DISCOUNT_RE.match(name)
    if m:
        digits = m.group(1)
        return 0.0 < int(digits) / 10 ** len(digits) < 1.0
    return False


def resolve(name: str) -> Policy:
    """Look up a policy by name (dynamic family spellings allowed)."""
    _ensure_builtins()
    pol = _POLICIES.get(name)
    if pol is None:
        pol = _resolve_dynamic(name)
    if pol is None:
        raise KeyError(
            f"unknown policy {name!r}; registered: {', '.join(sorted(_POLICIES))} "
            "(or dynamic lea_window<W> / lea_discount<D>)"
        )
    return pol


def names() -> tuple[str, ...]:
    """All concretely-registered policy names (dynamic memos included)."""
    _ensure_builtins()
    return tuple(sorted(_POLICIES))


def describe(name: str) -> str:
    return resolve(name).description


def catalogue() -> str:
    """Human-readable one-line-per-policy catalogue (ROADMAP / --help text)."""
    _ensure_builtins()
    width = max((len(n) for n in _POLICIES), default=0)
    return "\n".join(
        f"{n:<{width}}  {_POLICIES[n].description}" for n in sorted(_POLICIES)
    )
