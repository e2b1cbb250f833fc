"""Plain NumPy reference of the LEA round engine (paper Sec. 2-4, 6.1).

Worked out from the paper's definitions, one row at a time in the plain
order: the two-state Markov trajectory as a sequential recurrence, LEA's
transition-count estimator and the genie's true conditional, the
Poisson-binomial success probability of every prefix (eq. 8) by the
textbook dynamic program, the argmax allocation of Lemma 4.5, the static
rejection resampler, and the deadline rule of Defn. 2.1.

Arithmetic is float32 throughout, as the configuration states.  The DP's
step ``pmf[c-1] p + pmf[c] (1 - p)`` is one fused multiply-add in float32
(the product is formed in float64, where it is exact, and rounded once with
the sum); each tail is summed over ascending counts.  ``rd`` rounds every
float result to a lower precision for the control run
(:func:`rounding`); the sound run passes :func:`float32`.

Imports neither the program nor JAX.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
MAX_TRIES = 128


def float32(x):
    return np.asarray(x, F32)


def bfloat16(x):
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    bits = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return bits.astype(np.uint32).view(F32)


def rounding(name: str):
    return {"float32": float32, "bfloat16": bfloat16}[name]


def stationary_good(p_gg, p_bb, rd=float32):
    return rd(rd(F32(1) - p_bb) / rd(rd(F32(2) - p_gg) - p_bb))


def trajectory(u0, u, p_gg, p_bb, rd=float32):
    """(R, M, n) 0/1 states from round-0 uniforms (R, n), transition
    uniforms (R, M-1, n) and per-row chains (R, n): round 0 from the
    stationary law, then one Markov step a round."""
    p_gg, p_bb = rd(p_gg), rd(p_bb)
    u0, u = rd(u0), rd(u)
    leave_bad = rd(F32(1) - p_bb)
    s = u0 < stationary_good(p_gg, p_bb, rd)
    out = np.empty((u0.shape[0], u.shape[1] + 1, u0.shape[1]), np.int8)
    out[:, 0] = s
    for t in range(u.shape[1]):
        s = np.where(s, u[:, t] < p_gg, u[:, t] < leave_bad)
        out[:, t + 1] = s
    return out


def lea_p_good(states, rd=float32):
    """LEA's prediction for every round (Sec. 3.2, phase 4): add-one
    smoothed transition counts over the rounds seen so far, read at the last
    observed state; 1/2 before any transition is seen."""
    prev, cur = states[:, :-1], states[:, 1:]
    inc = np.stack([(prev == 1) & (cur == 1), (prev == 1) & (cur == 0),
                    (prev == 0) & (cur == 1), (prev == 0) & (cur == 0)], axis=-1)
    counts = np.zeros(states.shape + (4,), np.int64)
    counts[:, 2:] = np.cumsum(inc, axis=1)[:, :-1]
    c = counts.astype(F32)
    p_gg = rd(rd(c[..., 0] + F32(1)) / rd(rd(c[..., 0] + c[..., 1]) + F32(2)))
    p_bb = rd(rd(c[..., 3] + F32(1)) / rd(rd(c[..., 2] + c[..., 3]) + F32(2)))
    last = np.concatenate([states[:, :1], states[:, :-1]], axis=1)
    p = np.where(last == 1, p_gg, rd(F32(1) - p_bb)).astype(F32)
    p[:, 0] = F32(0.5)
    return p


def oracle_p_good(states, p_gg, p_bb, rd=float32):
    """The genie (Thm. 4.6): the true chain's conditional on last round's
    state; round 0 the stationary law.  Chains are (R, n)."""
    p_gg, p_bb = rd(p_gg), rd(p_bb)
    last = np.concatenate([states[:, :1], states[:, :-1]], axis=1)
    p = np.where(last == 1, p_gg[:, None], rd(F32(1) - p_bb)[:, None]).astype(F32)
    p[:, 0] = stationary_good(p_gg, p_bb, rd)
    return p


def thresholds(n: int, kstar: int, ell_g: int, ell_b: int) -> np.ndarray:
    """w(i) = ceil((K* - (n - i) ell_b) / ell_g), i = 1..n (eq. 7)."""
    i = np.arange(1, n + 1)
    return -((-(kstar - (n - i) * ell_b)) // ell_g)


def tails(p_sorted, w, rd=float32):
    """P[at least w(i) of the first i workers are good] for i = 1..n, each
    row's probabilities sorted descending: the Poisson-binomial DP."""
    p_sorted = rd(p_sorted)
    rows, n = p_sorted.shape
    pmf = np.zeros((rows, n + 1), F32)
    pmf[:, 0] = 1
    out = np.zeros((rows, n), F32)
    exact = rd is float32
    for i in range(n):
        p = p_sorted[:, i:i + 1]
        shifted = np.concatenate([np.zeros((rows, 1), F32), pmf[:, :-1]], axis=1)
        kept = rd(pmf * rd(F32(1) - p))
        if exact:
            pmf = (shifted.astype(np.float64) * p + kept).astype(F32)
        else:
            pmf = rd(rd(shifted * p) + kept)
        if w[i] > i + 1:
            continue
        acc = np.zeros(rows, F32)
        for c in range(max(w[i], 0), i + 2):
            acc = rd(acc + pmf[:, c])
        out[:, i] = acc
    return out


def allocate(p_good, kstar, ell_g, ell_b, rd=float32):
    """LEA's load assignment (Lemma 4.5) for (..., n) predictions: the i*
    workers with the largest p_good (ties: lower index first) get ell_g,
    the others ell_b, i* the prefix of largest success probability (the
    first of equals).  Returns int loads (..., n) and feasibility (...,)."""
    shape = p_good.shape
    p = rd(p_good.reshape(-1, shape[-1]))
    n = shape[-1]
    order = np.argsort(-p, axis=-1, kind="stable")
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.arange(n)[None], axis=-1)
    w = thresholds(n, kstar, ell_g, ell_b)
    prob = tails(np.take_along_axis(p, order, axis=-1), w, rd)
    i_star = np.argmax(prob, axis=-1) + 1
    loads = np.where(ranks < i_star[:, None], ell_g, ell_b)
    feasible = np.broadcast_to(np.any(w <= np.arange(1, n + 1)), i_star.shape)
    return loads.reshape(shape), feasible.reshape(shape[:-1])


def static_loads(draw, rows, m, n, pi, kstar, ell_g, ell_b, rd=float32):
    """The static strategy: every worker independently good with its
    stationary probability ``pi`` (R, n); a round redraws until its total
    load reaches K*, at most 128 times, then counts as infeasible.
    ``draw(t)`` gives try t's uniforms (R, m, n)."""
    loads = np.zeros((rows, m, n), np.int64)
    pi = rd(pi)[:, None, :]
    for t in range(MAX_TRIES):
        redo = loads.sum(axis=-1) < kstar
        if not redo.any():
            break
        new = np.where(rd(draw(t)) < pi, ell_g, ell_b)
        loads = np.where(redo[..., None], new, loads)
    return loads, loads.sum(axis=-1) >= kstar


def on_time(states, loads, mu_g, mu_b, t_cut, rd=float32):
    """Defn. 2.1: worker i's whole load arrives iff load / speed <= cutoff
    (the deadline, float32, with the engine's 1e-9 tolerance)."""
    speeds = np.where(states == 1, F32(mu_g), F32(mu_b)).astype(F32)
    return rd(loads.astype(F32) / speeds) <= rd(np.asarray(t_cut, F32) + F32(1e-9))


def received(states, loads, mu_g, mu_b, deadline, rd=float32):
    """Evaluations the master holds by the deadline, each round."""
    return np.where(on_time(states, loads, mu_g, mu_b, deadline, rd), loads, 0).sum(axis=-1)


def rollout(draws_for, rows, rounds, n, p_gg, p_bb, strategies, kstar, ell_g, ell_b,
            blocks, rd=float32):
    """States (R, M, n) and per-strategy loads (S, R, M, n) and feasibility
    (S, R, M) of the checked rows.  ``draws_for(kind, *args)`` returns the
    checked rows of the run's uniforms for that call; ``blocks`` are the
    (start, stop) round blocks the static resampler drew by."""
    states = trajectory(draws_for("initial"), draws_for("steps"), p_gg, p_bb, rd)
    pi = stationary_good(rd(p_gg), rd(p_bb), rd)
    loads, feas = [], []
    for s in strategies:
        if s == "static":
            parts = [static_loads(lambda t, a=a, b=b: draws_for("static", a, b, t),
                                  rows, b - a, n, pi, kstar, ell_g, ell_b, rd)
                     for a, b in blocks]
            loads.append(np.concatenate([x for x, _ in parts], axis=1))
            feas.append(np.concatenate([f for _, f in parts], axis=1))
            continue
        if s == "lea":
            p = lea_p_good(states, rd)
        elif s == "oracle":
            p = oracle_p_good(states, p_gg, p_bb, rd)
        else:
            raise ValueError(f"the reference has no strategy {s!r}")
        x, f = allocate(p, kstar, ell_g, ell_b, rd)
        loads.append(x)
        feas.append(f)
    return states, np.stack(loads), np.stack(feas)
