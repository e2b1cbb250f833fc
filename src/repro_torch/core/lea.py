"""Estimate-and-Allocate (EA) — the load-allocation half of LEA (Sec. 3.2).

The paper's phases map to:
  (1) Load Assignment -> :func:`allocate` / :func:`allocate_masked`
  (4) Update          -> :func:`update_estimator`

The estimated success probability (eq. 8) of every prefix i~ is a
Poisson-binomial tail, computed for all prefixes of a whole batch by one
O(n^2) dynamic program (:mod:`repro_torch.kernels.poisson_binomial`: the
CUDA kernel for CUDA tensors, the plain version for CPU tensors).  Every
function accepts leading batch axes: ``p_good`` (..., n) gives loads
(..., n) and ``i_star`` (...,).

Ranks: ties are the common case (LEA predicts 0.5 for every worker at round
0), and they break by lower worker index first, as in the JAX package — a
stable descending sort gives exactly that order, the sorted values are an
exact gather, and ``torch.argmax`` returns the first maximum.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.poisson_binomial import success_tails


class EstimatorState(NamedTuple):
    """Per-worker transition counts + last observed state.

    counts[:, 0] = C_{g->g}, counts[:, 1] = C_{g->b},
    counts[:, 2] = C_{b->g}, counts[:, 3] = C_{b->b}.
    """

    counts: torch.Tensor      # (n, 4) float32
    prev_state: torch.Tensor  # (n,) int32, 1=good 0=bad
    seen_prev: torch.Tensor   # () bool — False before the first observation


def init_estimator(n: int, device=None) -> EstimatorState:
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    return EstimatorState(
        counts=torch.zeros((n, 4), dtype=torch.float32, device=dev),
        prev_state=torch.zeros((n,), dtype=torch.int32, device=dev),
        seen_prev=torch.tensor(False, device=dev),
    )


def transition_onehot(prev: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """One-hot (g->g, g->b, b->g, b->b) transition indicators, (..., 4) f32."""
    return torch.stack(
        [
            (prev == 1) & (cur == 1),
            (prev == 1) & (cur == 0),
            (prev == 0) & (cur == 1),
            (prev == 0) & (cur == 0),
        ],
        dim=-1,
    ).to(torch.float32)


def smoothed_transitions(counts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(p̂_gg, p̂_bb) from (..., 4) transition counts with add-one smoothing."""
    p_gg = (counts[..., 0] + 1.0) / (counts[..., 0] + counts[..., 1] + 2.0)
    p_bb = (counts[..., 3] + 1.0) / (counts[..., 2] + counts[..., 3] + 2.0)
    return p_gg, p_bb


def update_estimator(state: EstimatorState, observed: torch.Tensor) -> EstimatorState:
    """Phase (4): fold one round's observed states (n,) into the counts.

    The first observation only sets ``prev_state`` (no transition yet).
    """
    prev, cur = state.prev_state, observed.to(torch.int32)
    inc = transition_onehot(prev, cur)
    counts = torch.where(state.seen_prev, state.counts + inc, state.counts)
    return EstimatorState(counts=counts, prev_state=cur,
                          seen_prev=torch.ones_like(state.seen_prev))


def estimated_transitions(state: EstimatorState) -> tuple[torch.Tensor, torch.Tensor]:
    return smoothed_transitions(state.counts)


def predicted_good_prob(state: EstimatorState) -> torch.Tensor:
    """p̂_{g,i}(m+1): p̂_gg if last seen good, else 1 - p̂_bb (Phase 4)."""
    p_gg, p_bb = estimated_transitions(state)
    return torch.where(state.prev_state == 1, p_gg, 1.0 - p_bb)


# ---------------------------------------------------------------------------
# Success probability + allocation (Phase 1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LoadParams:
    """Static load-allocation parameters for one deployment."""

    n: int
    kstar: int      # optimal recovery threshold K*
    ell_g: int      # min(mu_g * d, r)  — good-state load
    ell_b: int      # mu_b * d          — bad-state load (always finishes)

    def __post_init__(self):
        if self.ell_g <= self.ell_b:
            raise ValueError("ell_g must exceed ell_b (otherwise allocation is trivial)")


class PoolLoad(NamedTuple):
    """Per-row load parameters + worker-pool validity mask (tensors).

    The batched twin of :class:`LoadParams`: each row may have its own
    (K*, ell_g, ell_b) and valid pool inside a pool padded to width n.
    ``mask`` False marks padding: no load, no success count, and its
    probability entries are ignored by :func:`allocate_masked`.  Leading
    axes of the scalar leaves broadcast against the probability batch.
    """

    kstar: torch.Tensor   # (...,) int32
    ell_g: torch.Tensor   # (...,) int32
    ell_b: torch.Tensor   # (...,) int32
    mask: torch.Tensor    # (..., n) bool — True = real worker

    @property
    def n(self) -> int:
        """The padded pool width."""
        return self.mask.shape[-1]


def pool_load(lp: LoadParams, n: int | None = None, device=None) -> PoolLoad:
    """Lift a static :class:`LoadParams` to a (possibly padded) PoolLoad."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    n = lp.n if n is None else n
    if n < lp.n:
        raise ValueError(f"cannot pad {lp.n} workers into width {n}")
    as_i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return PoolLoad(
        kstar=as_i32(lp.kstar), ell_g=as_i32(lp.ell_g), ell_b=as_i32(lp.ell_b),
        mask=torch.arange(n, device=dev) < lp.n,
    )


def prefix_thresholds(lp: LoadParams) -> np.ndarray:
    """w(i~) = ceil((K* - (n - i~) * ell_b) / ell_g) for i~ = 1..n  (eq. 7/8).

    Values <= 0 mean "always enough", > i~ mean "impossible".  numpy,
    because ``lp`` is static: the kernel's static entry takes them as is.
    """
    i_tilde = np.arange(1, lp.n + 1)
    return np.ceil((lp.kstar - (lp.n - i_tilde) * lp.ell_b) / lp.ell_g).astype(np.int32)


def prefix_thresholds_traced(
    kstar: torch.Tensor,
    ell_g: torch.Tensor,
    ell_b: torch.Tensor,
    n_valid: torch.Tensor,
    n: int,
) -> torch.Tensor:
    """Per-row w(i~) for i~ = 1..n over a pool of n_valid real workers.

    Exact int32 arithmetic: ``ceil(a/g) = -floor(-a/g)`` with floor
    division.  Prefixes past the valid pool carry the infeasible sentinel
    n + 1.  Inputs broadcast against each other; the result gains (n,).
    """
    dev = n_valid.device
    kstar = torch.as_tensor(kstar, dtype=torch.int32, device=dev)[..., None]
    ell_g = torch.as_tensor(ell_g, dtype=torch.int32, device=dev)[..., None]
    ell_b = torch.as_tensor(ell_b, dtype=torch.int32, device=dev)[..., None]
    n_valid = n_valid.to(torch.int32)[..., None]
    i_tilde = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    num = kstar - (n_valid - i_tilde) * ell_b
    w = -torch.div(-num, ell_g, rounding_mode="floor")
    sentinel = torch.full_like(w, n + 1)
    return torch.where(i_tilde > n_valid, sentinel, w).to(torch.int32)


def success_prob_all_prefixes(
    p_good_sorted: torch.Tensor, lp: "LoadParams | PoolLoad"
) -> torch.Tensor:
    """P̂(i~) for every i~ in 1..n, p_good sorted descending on the last axis.

    A :class:`PoolLoad` gives per-row thresholds (per-row entry of the
    kernel); a :class:`LoadParams` the static tuple (static entry).
    """
    if isinstance(lp, PoolLoad):
        n = p_good_sorted.shape[-1]
        n_valid = lp.mask.to(torch.int32).sum(dim=-1)
        w = prefix_thresholds_traced(lp.kstar, lp.ell_g, lp.ell_b, n_valid, n)
        return success_tails(p_good_sorted, w)
    return success_tails(p_good_sorted, prefix_thresholds(lp))


def _ranks_descending(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, ranks): stable descending order (ties by lower index first)
    and each worker's rank in it — argsort(argsort(-p)) of the JAX package."""
    order = torch.sort(p, dim=-1, descending=True, stable=True).indices
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(p.shape[-1], device=p.device).expand_as(order))
    return order, ranks


def _take_by_rank(p: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Values in rank order: an exact gather."""
    return torch.gather(p, -1, order)


def allocate(p_good: torch.Tensor, lp: LoadParams) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase (1): the LEA load assignment, batched over leading axes.

    Returns ``(loads, i_star)``: (..., n) int32 loads in the original worker
    order (the i* workers with the largest p_good get ell_g, the rest ell_b
    — Lemma 4.5) and the (...,) argmax prefix (1-based).
    """
    order, ranks = _ranks_descending(p_good)
    probs = success_prob_all_prefixes(_take_by_rank(p_good, order), lp)
    i_star = torch.argmax(probs, dim=-1) + 1
    loads = torch.where(ranks < i_star[..., None], lp.ell_g, lp.ell_b).to(torch.int32)
    return loads, i_star


def allocate_masked(
    p_good: torch.Tensor, pool: PoolLoad
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LEA load assignment over a mask-padded pool with per-row parameters.

    Masked workers are demoted below every real probability before ranking,
    replaced by p = 0 (an identity convolution) before the DP, and receive
    load 0.  Returns ``(loads, i_star, feasible)``; ``feasible`` is False
    where no prefix of the valid pool can reach K* — explicit, never a
    silent failure.  On a full-width pool every masking step preserves
    values, so the result equals :func:`allocate` on the same inputs.
    """
    mask = pool.mask
    n = p_good.shape[-1]
    if mask.shape[-1] != n:
        raise ValueError(f"mask width {mask.shape[-1]} != pool width {n}")
    n_valid = mask.to(torch.int32).sum(dim=-1)
    p_eff = torch.where(mask, p_good, -1.0)
    order, ranks = _ranks_descending(p_eff)
    p_sorted = _take_by_rank(p_eff, order)
    pos = torch.arange(n, device=p_good.device)
    p_dp = torch.where(pos < n_valid[..., None], p_sorted, 0.0)
    w = prefix_thresholds_traced(pool.kstar, pool.ell_g, pool.ell_b, n_valid, n)
    probs = success_tails(p_dp, w)
    i_star = torch.argmax(probs, dim=-1) + 1
    i_tilde = pos + 1
    feasible = torch.any((w <= i_tilde) & (i_tilde <= n_valid[..., None]), dim=-1)
    loads = torch.where(ranks < i_star[..., None], pool.ell_g[..., None],
                        pool.ell_b[..., None])
    loads = torch.where(mask, loads, 0).to(torch.int32)
    return loads, i_star, torch.broadcast_to(feasible, i_star.shape)


def allocate_queue(
    p_good: torch.Tensor,
    pool_mask: torch.Tensor,
    active: torch.Tensor,
    kstar: torch.Tensor,
    ell_g: torch.Tensor,
    ell_b: torch.Tensor,
    order: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split ONE worker pool across the active slots of a request queue.

    The multi-job extension of :func:`allocate_masked` (the serving layer):
    greedy EDF water-filling over the pool's descending-p_good ranks.  Each
    active slot j has its own (kstar, ell_g, ell_b); ``order`` lists the
    slots in priority (EDF) order.  Walking slots in that order, slot j is
    handed a contiguous SEGMENT of the rank-sorted pool: at least its
    minimal feasible worker count ``m_j = ceil(kstar_j / ell_g_j)``, plus
    every worker not reserved by the minimal demands of the lower-priority
    slots behind it — so the most urgent slot absorbs all surplus
    redundancy and each segment then gets its own :func:`allocate_masked`
    two-level assignment, ONE batched DP over every segment (one launch of
    the Poisson-binomial kernel on the card).

    Batched over leading axes: ``p_good`` (..., n) predicted good
    probabilities (raw, not demoted), ``pool_mask`` (..., n) bool (True = real
    worker), ``active`` (..., Q) bool, ``kstar``/``ell_g``/``ell_b`` (..., Q)
    integer per-slot parameters and ``order`` (..., Q) a permutation of the
    slots, highest priority first (inactive slots may appear anywhere; they
    demand and receive nothing).  The loop over the Q slots is a fixed loop
    of integer tensor ops: exact, and nothing is read back to the host.

    Returns ``(loads, i_star, feasible)``, all in ORIGINAL slot order:

      * ``loads`` (..., Q, n) int32 — per-slot worker assignment; segments
        are disjoint, zero outside a slot's segment and for inactive slots;
      * ``i_star`` (..., Q) — each segment's argmax prefix (1-based);
      * ``feasible`` (..., Q) bool — False where a slot's segment cannot
        reach its kstar (the pool is oversubscribed and the shortfall is
        EXPLICIT, never silent).  Inactive slots read False.

    With ONE active slot the segment is the entire valid pool, so the
    result equals :func:`allocate_masked` on the full pool to the bit — the
    case that reduces the serving engine to the single-job engine.
    """
    q = active.shape[-1]
    # worker ranks over the FULL pool, exactly allocate_masked's demotion
    _, ranks = _ranks_descending(torch.where(pool_mask, p_good, -1.0))
    n_valid = pool_mask.to(torch.int32).sum(dim=-1)

    # per-slot quantities in priority order
    take = lambda x: torch.gather(x, -1, order)
    act_e = take(active)
    ks_e, eg_e, eb_e = (take(x).to(torch.int32) for x in (kstar, ell_g, ell_b))
    m_e = torch.where(act_e, -torch.div(-ks_e, eg_e.clamp(min=1), rounding_mode="floor"), 0)
    # minimal demand of the slots BEHIND priority position j
    reserve_after = torch.flip(torch.cumsum(torch.flip(m_e, (-1,)), -1), (-1,)) - m_e

    sizes = []
    remaining = torch.broadcast_to(n_valid, act_e.shape[:-1])
    for j in range(q):
        want = torch.maximum(m_e[..., j], remaining - reserve_after[..., j])
        size = torch.where(act_e[..., j], torch.minimum(want.clamp(min=0), remaining), 0)
        sizes.append(size)
        remaining = remaining - size
    sizes_e = torch.stack(sizes, dim=-1).to(torch.int32)                  # (..., Q)
    starts_e = torch.cumsum(sizes_e, dim=-1, dtype=torch.int32) - sizes_e

    r = ranks[..., None, :]
    seg = ((r >= starts_e[..., None]) & (r < (starts_e + sizes_e)[..., None])
           & pool_mask[..., None, :] & act_e[..., None])                   # (..., Q, n)
    # a free slot's stale ell_g may be 0: its segment is empty, so every
    # output of it is the same for any ell_g, and 1 keeps the DP's
    # threshold division defined
    loads_e, i_star_e, feas_e = allocate_masked(
        p_good[..., None, :].expand(seg.shape),
        PoolLoad(kstar=ks_e, ell_g=torch.where(act_e, eg_e, 1), ell_b=eb_e, mask=seg),
    )
    inv = torch.empty_like(order).scatter_(
        -1, order, torch.arange(q, device=order.device).expand_as(order))  # unpermute
    return (torch.gather(loads_e, -2, inv[..., None].expand(loads_e.shape)),
            torch.gather(i_star_e, -1, inv), torch.gather(feas_e, -1, inv))


def success_prob_bruteforce(p_good_sorted, lp: LoadParams, i_tilde: int) -> float:
    """Reference implementation of eq. (8) by exponential enumeration (tests)."""
    p = np.asarray(torch.as_tensor(p_good_sorted).cpu(), np.float64)[:i_tilde]
    w = int(math.ceil((lp.kstar - (lp.n - i_tilde) * lp.ell_b) / lp.ell_g))
    if w > i_tilde:
        return 0.0
    total = 0.0
    for bits in itertools.product([0, 1], repeat=i_tilde):
        if sum(bits) >= max(w, 0):
            prob = 1.0
            for i, b in enumerate(bits):
                prob *= p[i] if b else (1.0 - p[i])
            total += prob
    return float(total)


def round_success(loads: torch.Tensor, states: torch.Tensor, lp: LoadParams,
                  mu_g, mu_b, deadline) -> torch.Tensor:
    """Did the master receive >= K* evaluations by the deadline?

    Worker i returns all ``loads[i]`` results iff loads[i]/speed_i <= d.
    The comparison runs in float32, as in the JAX package (``1e-9`` rounds
    away against a float32 deadline of 1).
    """
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=loads.device)
    speeds = torch.where(states == 1, f32(mu_g), f32(mu_b))
    on_time = loads.to(torch.float32) / speeds <= f32(deadline) + 1e-9
    received = torch.where(on_time, loads, 0).sum(dim=-1)
    return received >= lp.kstar
