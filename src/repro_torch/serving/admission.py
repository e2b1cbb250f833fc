"""Admission control: shed load the service would miss anyway.

Two gates, both riding in :class:`repro_torch.serving.queue.RequestSpec`
as tensors, so an admit-all run and a controlled run take the same code
path:

  * the PREDICTION gate — :func:`predicted_success` evaluates the policy's
    p_good row through the same best-prefix Poisson-binomial machinery the
    allocator uses (the prefix tails over the full pool), and a request is
    admitted only when that predicted feasibility clears
    ``admit_threshold``;
  * the CAPACITY gate — :func:`admission_room` bounds how many newcomers
    fit before the queue's summed minimal worker demand (each slot's
    ``ceil(kstar / ell_g)``) exceeds ``reserve_cap * n_valid`` workers,
    so doomed requests never steal the minimal segments that feasible
    ones need (the EDF water-filling hands every active slot its minimal
    demand first — see :func:`repro_torch.core.lea.allocate_queue`).

The prediction gate runs once for every (strategy, row, round) before the
serving loop — one launch of the Poisson-binomial kernel on the card — and
the capacity gate is one cheap reduction a round inside it.
"""

from __future__ import annotations

import torch

from repro_torch.core import lea as lea_mod
from repro_torch.kernels.poisson_binomial import success_tails


def predicted_success(p_alloc: torch.Tensor, pool_mask: torch.Tensor, kstar, ell_g,
                      ell_b) -> torch.Tensor:
    """Best-prefix predicted success probability of a fresh request.

    ``p_alloc`` is (..., n) predicted p_good (the engine passes (S, B, M, n)
    policy rows); ``pool_mask`` (..., n) bool broadcasts against it; the
    request's ``kstar``/``ell_g``/``ell_b`` broadcast against the pool
    mask's leading axes.  Returns (...,) = max over prefixes of the
    Poisson-binomial success probability on the FULL pool — the
    probability the allocator's own objective assigns to the request if it
    were granted the whole pool — in ONE batched DP.

    The thresholds are computed on the pool mask's and the spec's own
    axes and reach the kernel as a broadcast view (stride 0 on the axes
    they share, e.g. every round of a row), never materialised to the
    probabilities' size.
    """
    n = p_alloc.shape[-1]
    mask = torch.broadcast_to(pool_mask, p_alloc.shape)
    # demote padding exactly like allocate_masked, sort, pad the DP with
    # identity Bernoullis past the valid pool
    p_eff = torch.where(mask, p_alloc, -1.0)
    p_sorted = torch.sort(p_eff, dim=-1, descending=True).values
    n_valid = mask.to(torch.int32).sum(dim=-1)
    pos = torch.arange(n, device=p_alloc.device)
    p_dp = torch.where(pos < n_valid[..., None], p_sorted, 0.0)
    n_valid_w = pool_mask.to(torch.int32).sum(dim=-1)
    w = lea_mod.prefix_thresholds_traced(kstar, ell_g, ell_b, n_valid_w, n)
    return success_tails(p_dp, w).amax(dim=-1)


def _ceil_div(num, den):
    """Exact int32 ``ceil(num / max(den, 1))``."""
    num = torch.as_tensor(num, dtype=torch.int32)
    den = torch.as_tensor(den, dtype=torch.int32, device=num.device).clamp(min=1)
    return -torch.div(-num, den, rounding_mode="floor")


def minimal_demand(occupied, kstar, ell_g) -> torch.Tensor:
    """Summed minimal worker demand of the occupied slots: sum of
    ``ceil(kstar / ell_g)`` (exact int32 ceil-div, 0 for free slots)."""
    occupied = torch.as_tensor(occupied)
    m = torch.where(occupied, _ceil_div(kstar, ell_g).to(occupied.device), 0)
    return m.sum(dim=-1, dtype=torch.int32)


def admission_budget(n_valid, reserve_cap) -> torch.Tensor:
    """The capacity gate's worker budget ``floor(reserve_cap * n_valid)``.

    The product is float32, as in the JAX package: ``0.7 * 10`` rounds to
    7.0 there and floors to 7, where a float64 product (6.99999988) would
    floor to 6.  Clipped so a disabled gate (``reserve_cap`` huge) never
    overflows int32.
    """
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32)
    cap = torch.as_tensor(reserve_cap, dtype=torch.float32, device=n_valid.device)
    return (cap * n_valid).clamp(0.0, 2.0**30).to(torch.int32)


def admission_room(m_active, m_new, n_valid, reserve_cap) -> torch.Tensor:
    """How many newcomers (minimal demand ``m_new`` each) the capacity gate
    admits on top of ``m_active`` already-reserved workers, within
    :func:`admission_budget`."""
    budget = admission_budget(n_valid, reserve_cap)
    m_active = torch.as_tensor(m_active, dtype=torch.int32, device=budget.device)
    m_new = torch.as_tensor(m_new, dtype=torch.int32, device=budget.device)
    return torch.div((budget - m_active).clamp(min=0), m_new.clamp(min=1),
                     rounding_mode="floor")


__all__ = ["admission_budget", "admission_room", "minimal_demand", "predicted_success"]
