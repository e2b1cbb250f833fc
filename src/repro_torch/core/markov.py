"""Two-state Markov worker-speed model (Sec. 2.2 of the paper), batched rows.

State convention: ``1 = good``, ``0 = bad``; ``p_gg[i] = P[good -> good]``,
``p_bb[i] = P[bad -> bad]``; chains start from their stationary distribution.

Shapes: every function works on a leading batch axis of B independent rows
(B may be 1).  A chain is ``(B, n)`` (stationary) or ``(B, M, n)``
(time-varying: row t governs the transition INTO round t, row 0 the initial
distribution).  Trajectories are ``(B, M, n)`` int32.

Randomness is drawn through a :class:`repro_torch.random.Draws` and only
TRANSFORMED here, so feeding the uniforms ``jax.random`` would have drawn
reproduces the JAX package's trajectories bit for bit.

``worker_mask`` (B, n) bool freezes masked (padding) workers in the good
state; it never changes the draw geometry (draws are shaped over the padded
width, exactly as an unpadded width-n pool draws).
"""

from __future__ import annotations

import torch


def stationary_good_prob(p_gg: torch.Tensor, p_bb: torch.Tensor) -> torch.Tensor:
    """pi_g = (1 - p_bb) / (2 - p_gg - p_bb) for an irreducible 2-state chain."""
    return (1.0 - p_bb) / (2.0 - p_gg - p_bb)


def chain_row0(p: torch.Tensor) -> torch.Tensor:
    """The (B, n) chain in force at round 0 of a (B, n) / (B, M, n) chain."""
    return p[:, 0] if p.dim() == 3 else p


def initial_states(
    u: torch.Tensor,
    p_gg: torch.Tensor,
    p_bb: torch.Tensor,
    worker_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, n) int32 stationary states from (B, n) uniforms ``u``.

    A time-varying chain initialises from its round-0 row.  Masked workers
    are pinned to the good state.
    """
    pi_g = stationary_good_prob(chain_row0(p_gg), chain_row0(p_bb))
    s0 = (u < pi_g).to(torch.int32)
    if worker_mask is None:
        return s0
    return torch.where(worker_mask, s0, torch.ones_like(s0))


def step_states(
    u: torch.Tensor, states: torch.Tensor, p_gg: torch.Tensor, p_bb: torch.Tensor
) -> torch.Tensor:
    """One Markov transition for all workers from uniforms ``u``."""
    stay_good = u < p_gg
    leave_bad = u < (1.0 - p_bb)
    return torch.where(states == 1, stay_good, leave_bad).to(torch.int32)


def _step_chains(p_gg: torch.Tensor, p_bb: torch.Tensor):
    """Per-step thresholds broadcastable against (B, M-1, n) uniforms."""
    if p_gg.dim() == 3:
        return p_gg[:, 1:], p_bb[:, 1:]
    return p_gg[:, None, :], p_bb[:, None, :]


def _check_chain(p_gg: torch.Tensor, p_bb: torch.Tensor, rounds: int) -> None:
    if p_gg.shape != p_bb.shape or p_gg.dim() not in (2, 3):
        raise ValueError(
            f"chains must be matching (B, n) or (B, rounds, n) tensors, got "
            f"{tuple(p_gg.shape)} and {tuple(p_bb.shape)}"
        )
    if p_gg.dim() == 3 and p_gg.shape[1] != rounds:
        raise ValueError(
            f"time-varying chain must have one row per round: got "
            f"{p_gg.shape[1]} rows for rounds={rounds}"
        )


def _freeze(traj: torch.Tensor, worker_mask: torch.Tensor | None) -> torch.Tensor:
    if worker_mask is None:
        return traj
    return torch.where(worker_mask[:, None, :], traj, torch.ones_like(traj))


def sample_trajectory(
    draws,
    p_gg: torch.Tensor,
    p_bb: torch.Tensor,
    rounds: int,
    worker_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, M, n) int32 trajectories, initial states from the stationary dist.

    Round t's transition is a map {0,1} -> {0,1} fixed by its uniform u_t:
    the value table ``(f_t(bad), f_t(good)) = ([u_t < 1-p_bb], [u_t < p_gg])``
    (exactly :func:`step_states` on both inputs).  The prefix compositions
    ``f_t o ... o f_1`` come from a log-depth doubling scan (Hillis-Steele)
    over the rounds axis; boolean composition is exact, so this equals the
    sequential recurrence (:func:`sample_trajectory_scan`) bit for bit.
    """
    _check_chain(p_gg, p_bb, rounds)
    b, n = p_gg.shape[0], p_gg.shape[-1]
    s0 = initial_states(draws.initial(b, n).to(p_gg.device), p_gg, p_bb)
    if rounds == 1:
        return _freeze(s0[:, None, :], worker_mask)
    u = draws.steps(b, rounds, n).to(p_gg.device)        # (B, M-1, n)
    pg, pb = _step_chains(p_gg, p_bb)
    return _freeze(_run_from(s0, u, pg, 1.0 - pb), worker_mask)


def _run_from(s0: torch.Tensor, u: torch.Tensor, p_stay1, p_leave0) -> torch.Tensor:
    """(B, M, n) int32 states from (B, n) round-0 states and (B, M-1, n)
    transition uniforms: ``f_t(good) = [u_t < p_stay1]``, ``f_t(bad) =
    [u_t < p_leave0]``, prefixes composed by the doubling scan."""
    pref1 = u < p_stay1                                  # f_t(good)
    pref0 = u < p_leave0                                 # f_t(bad)
    steps = u.shape[1]
    offset = 1
    while offset < steps:
        # P_t <- P_t o P_{t-offset} for t >= offset: apply the earlier
        # prefix first, then look its result up in the later table
        e0, e1 = pref0[:, :-offset], pref1[:, :-offset]
        l0, l1 = pref0[:, offset:], pref1[:, offset:]
        new0 = torch.where(e0, l1, l0)
        new1 = torch.where(e1, l1, l0)
        pref0 = torch.cat([pref0[:, :offset], new0], dim=1)
        pref1 = torch.cat([pref1[:, :offset], new1], dim=1)
        offset *= 2
    tail = torch.where(s0[:, None, :] == 1, pref1, pref0).to(torch.int32)
    return torch.cat([s0[:, None, :], tail], dim=1)


def sample_trajectory_from(
    u: torch.Tensor | None,
    p_stay1,
    p_stay0,
    init: torch.Tensor,
) -> torch.Tensor:
    """(B, M, n) trajectories of a 2-state chain from an EXPLICIT round 0.

    The fault processes' twin of :func:`sample_trajectory`: ``init`` (B, n)
    IS round 0 (no stationary draw: a fleet starts alive, a channel starts
    clear), ``u`` holds the (B, M-1, n) transition uniforms (``None`` or
    zero rounds for M = 1), and ``p_stay1`` / ``p_stay0`` are P[1 -> 1] /
    P[0 -> 0], float32 tensors broadcastable against ``u``.  The same
    per-round maps and doubling scan as :func:`sample_trajectory`, so on
    the JAX package's uniforms it equals ``sample_trajectory_from`` there to
    the bit.
    """
    init = init.to(torch.int32)
    if u is None or u.shape[1] == 0:
        return init[:, None, :]
    return _run_from(init, u, p_stay1, 1.0 - p_stay0)


def sample_trajectory_scan(
    draws,
    p_gg: torch.Tensor,
    p_bb: torch.Tensor,
    rounds: int,
    worker_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sequential reference of :func:`sample_trajectory` (one step per round).

    Kept as the oracle for the doubling scan; it loops over rounds on the
    host, so use it at test sizes only.
    """
    _check_chain(p_gg, p_bb, rounds)
    b, n = p_gg.shape[0], p_gg.shape[-1]
    s = initial_states(draws.initial(b, n).to(p_gg.device), p_gg, p_bb)
    out = [s]
    if rounds > 1:
        u = draws.steps(b, rounds, n).to(p_gg.device)
        for t in range(1, rounds):
            pg = p_gg[:, t] if p_gg.dim() == 3 else p_gg
            pb = p_bb[:, t] if p_bb.dim() == 3 else p_bb
            s = step_states(u[:, t - 1], s, pg, pb)
            out.append(s)
    return _freeze(torch.stack(out, dim=1), worker_mask)


def speeds_from_states(states: torch.Tensor, mu_g, mu_b) -> torch.Tensor:
    """Map 0/1 states to evaluations-per-second speeds."""
    return torch.where(states == 1, mu_g, mu_b)


def _integer_pow(x: torch.Tensor, t: int) -> torch.Tensor:
    """x**t by binary exponentiation — the multiplication order XLA uses for
    an integer power, so the result is the JAX package's to the bit."""
    if t == 0:
        return torch.ones_like(x)
    acc = None
    while t > 0:
        if t & 1:
            acc = x if acc is None else acc * x
        t >>= 1
        if t > 0:
            x = x * x
    return acc


def t_step_transitions(p_gg, p_bb, t: int):
    """Effective (p_gg, p_bb) of the t-step chain: P^t in closed form.

    ``P^t[g,g] = pi_g + (1 - pi_g) lam^t`` with ``lam = p_gg + p_bb - 1``
    (and symmetrically for b).  float32 throughout, like the JAX package.
    """
    p_gg = torch.as_tensor(p_gg, dtype=torch.float32)
    p_bb = torch.as_tensor(p_bb, dtype=torch.float32)
    lam = p_gg + p_bb - 1.0
    pi_g = stationary_good_prob(p_gg, p_bb)
    lam_t = _integer_pow(lam, int(t))
    return pi_g + (1.0 - pi_g) * lam_t, (1.0 - pi_g) + pi_g * lam_t
