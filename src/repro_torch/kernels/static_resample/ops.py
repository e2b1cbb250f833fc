"""The static resampler of one block, routed by the tensor
(:mod:`repro_torch.kernels.dispatch`): CUDA tensors go to the kernel
(:class:`StaticResampleCuda`), CPU tensors to the plain version
(:class:`StaticResampleRef`).  Both give the same loads and ``feasible``
flags for the same uniforms, and both answer the host's one read a try with
the number of unfinished (strategy, round) pairs.

The engine adds each try to the engagement counters (:func:`count_try`,
read by :func:`engagement`) from that read, whatever the route: ``tries``,
``redraws`` (unfinished pairs redrawn, summed over tries) and ``slots``
(S x B x m a try, summed).  ``redraws / slots`` is the share of the block
the tries touched.  They are not launches: the kernel's are counted where
it launches (``kernel.launch_counts``).
"""

from __future__ import annotations

from repro_torch.kernels.dispatch import PLAIN, route

from .kernel import StaticResampleCuda
from .ref import StaticResampleRef

_ENGAGEMENT = {"tries": 0, "redraws": 0, "slots": 0}


def static_resampler(pis, m: int, kstar, ell_g, ell_b, mask=None):
    """Rejection resampling of one block of ``m`` rounds for the static
    strategies' good-probabilities ``pis`` ((B, n) each), all fed the same
    uniforms: ``unfinished()`` before each try, ``redraw(u)`` with the try's
    uniforms, ``result()`` at the end."""
    impl = StaticResampleRef if route(pis[0]) == PLAIN else StaticResampleCuda
    return impl(pis, m, kstar, ell_g, ell_b, mask)


def count_try(redraws: int, slots: int) -> None:
    """Add one try that redrew ``redraws`` of its ``slots`` pairs."""
    _ENGAGEMENT["tries"] += 1
    _ENGAGEMENT["redraws"] += redraws
    _ENGAGEMENT["slots"] += slots


def engagement() -> dict[str, int]:
    """Tries, pairs redrawn and pairs offered since the last
    :func:`reset_engagement`."""
    return dict(_ENGAGEMENT)


def reset_engagement() -> None:
    for name in _ENGAGEMENT:
        _ENGAGEMENT[name] = 0


__all__ = ["count_try", "engagement", "reset_engagement", "static_resampler"]
