"""Plain NumPy reference of the packet-erasure fault model.

A worker evaluates its assigned prefix of r stored chunks in order; chunk
j's packet q (of P) is done at (j + (q+1)/P) / speed.  A preemption hit
cuts the worker's compute at a uniform fraction of the deadline; each
packet is independently lost with probability p_drop.  Three decodes per
round: all-or-nothing (a worker's packets count only if its whole load
met the cutoff), partial-work conserving (every packet done by the cutoff
counts), and the layer-1 code (the first p1 packet indices reach K1 when
the full conserving decode fails).  Every decode also needs the round's
allocation to have been feasible.

Imports neither the program nor JAX.
"""

from __future__ import annotations

import numpy as np

from .engine import F32, float32


def cutoffs(u_hit, u_frac, p_preempt, deadline, rd=float32):
    """(R, M, n) compute cutoffs: the deadline, or a uniform fraction of it
    where a preemption hit the worker that round."""
    d = F32(deadline)
    hit = rd(u_hit) < rd(np.asarray(p_preempt, F32))[:, None, None]
    return np.where(hit, rd(rd(u_frac) * d), d).astype(F32)


def delivered(u_drop, p_drop, rd=float32):
    """(R, M, n, r, P) packets the network kept: each lost with p_drop."""
    return rd(u_drop) >= rd(np.asarray(p_drop, F32)).reshape(-1, 1, 1, 1, 1)


def packets_counts(states, loads, t_cut, keep, mu_g, mu_b, deadline, r, packets,
                   conserve, rd=float32):
    """(S, R, M, P) chunk evaluations whose packet q arrived, for states
    (R, M, n), loads (S, R, M, n), cutoffs (R, M, n) and deliveries
    (R, M, n, r, P)."""
    speeds = np.where(states == 1, F32(mu_g), F32(mu_b)).astype(F32)
    tc = rd(np.minimum(t_cut, F32(deadline)) + F32(1e-9))
    if conserve:
        frac = rd(rd(np.arange(packets, dtype=F32) + F32(1)) / F32(packets))
        num = rd(np.arange(r, dtype=F32)[:, None] + frac)                   # (r, P)
        done = rd(num / speeds[..., None, None]) <= tc[..., None, None]     # (R, M, n, r, P)
        done = done[None]
    else:
        whole = rd(loads.astype(F32) / speeds) <= tc                        # (S, R, M, n)
        done = whole[..., None, None]
    assigned = np.arange(r) < loads[..., None]                              # (S, R, M, n, r)
    ok = done & assigned[..., None] & keep[None]
    return ok.sum(axis=(-3, -2))


def outcomes(states, loads, feasible, t_cut, keep, mu_g, mu_b, deadline, r, packets,
             kstar, k1star, p1, rd=float32):
    """(full_aon, full_conserve, partial), each (S, R, M) bool."""
    aon = packets_counts(states, loads, t_cut, keep, mu_g, mu_b, deadline, r, packets,
                         False, rd)
    con = packets_counts(states, loads, t_cut, keep, mu_g, mu_b, deadline, r, packets,
                         True, rd)
    full_aon = feasible & np.all(aon >= kstar, axis=-1)
    full_con = feasible & np.all(con >= kstar, axis=-1)
    layer1 = feasible & np.all(con[..., :p1] >= k1star, axis=-1)
    return full_aon, full_con, layer1 & ~full_con
