"""Built-in policies: estimator-state replays as closed-form batched functions.

Every policy predicts round m's per-worker P[good] from the observed prefix
``states[:, :m]`` (plus, for the genie, the true chain) in one vectorised
pass over all M rounds.  Shapes: states (B, M, n) -> (B, M, n) float32.

Catalogue:

  ``lea``            — the paper's LEA estimator (Sec. 3.2 phase 4): running
                       transition counts with add-one smoothing, an exact
                       cumsum (integer counts in float32).
  ``lea_window<W>``  — counts over the last W observed transitions only
                       (cumsum difference, exact).
  ``lea_discount<D>``— counts decayed by gamma per round: a first-order
                       linear recurrence, run as a log-depth doubling scan.
                       Its float sums are taken in another order than the
                       JAX package's ``associative_scan``, so the two agree
                       to float32 round-off, not to the bit.
  ``ucb``            — the LEA point estimate plus a sqrt(2 ln m / visits)
                       confidence bonus, clipped.  ``log1p`` differs by an
                       ulp between XLA and PyTorch on some inputs, so the
                       bonus agrees with the JAX package to round-off.
  ``thompson``       — Beta-posterior Thompson sampling on the transition
                       probabilities: each round draws p_gg / p_bb from the
                       posterior the counts induce (the run's
                       :class:`~repro_torch.random.BetaDraws`) and predicts
                       with the sample.  On the JAX package's variates it
                       equals ``thompson`` there.
  ``oracle``         — genie-aided optimum of Thm. 4.6: the true one-step
                       conditional given the previous true state.

All count-based variants share one prediction rule given counts
(:func:`predict_from_counts`), so they differ only in how history is
weighted.
"""

from __future__ import annotations

import torch

from repro_torch.core import lea as lea_mod
from repro_torch.random import BetaDraws, require

from .api import Policy, PolicyContext
from .registry import register

# ---------------------------------------------------------------------------
# shared count machinery (rounds on axis -2 of states, -3 of counts)
# ---------------------------------------------------------------------------


def transition_increments(states: torch.Tensor) -> torch.Tensor:
    """(..., M-1, n, 4) one-hot transitions between consecutive rounds."""
    return lea_mod.transition_onehot(states[..., :-1, :], states[..., 1:, :])


def _zeros_counts(states: torch.Tensor, rounds: int) -> torch.Tensor:
    return torch.zeros(states.shape[:-2] + (rounds, states.shape[-1], 4),
                       dtype=torch.float32, device=states.device)


def counts_before_round(states: torch.Tensor) -> torch.Tensor:
    """Vanilla LEA counts entering each round: (..., M, n, 4) exact cumsum.

    Round m sees the transitions among ``states[..., :m, :]``; rounds 0 and 1
    see zeros.
    """
    rounds_total = states.shape[-2]
    if rounds_total < 2:
        return _zeros_counts(states, rounds_total)
    csum = torch.cumsum(transition_increments(states), dim=-3)
    zeros = _zeros_counts(states, 2)
    return torch.cat([zeros, csum[..., :-1, :, :]], dim=-3)


def windowed_counts_before_round(states: torch.Tensor, window: int) -> torch.Tensor:
    """Counts over the last ``window`` transitions entering each round.

    ``cs[j]`` is the sum of the first j increments; round m's window is
    ``cs[m-1] - cs[max(m-1-window, 0)]`` — a difference of exact integer
    cumsums, so ``window >= M`` reproduces :func:`counts_before_round`.
    """
    rounds_total = states.shape[-2]
    if rounds_total < 2:
        return _zeros_counts(states, rounds_total)
    csum = torch.cumsum(transition_increments(states), dim=-3)
    cs = torch.cat([_zeros_counts(states, 1), csum], dim=-3)     # (..., M, n, 4)
    m = torch.arange(rounds_total, device=states.device)
    hi = torch.clamp(m - 1, min=0)
    lo = torch.clamp(m - 1 - window, min=0)
    return cs.index_select(-3, hi) - cs.index_select(-3, lo)


def discounted_counts_before_round(states: torch.Tensor, gamma: float) -> torch.Tensor:
    """Geometrically-discounted counts entering each round.

    z[j] = gamma * z[j-1] + inc[j], composed as (coefficient, value) pairs
    by a doubling scan over the rounds axis (log-depth).  Round m sees
    ``z[m-2]``, mirroring the vanilla shift.
    """
    rounds_total = states.shape[-2]
    if rounds_total < 2:
        return _zeros_counts(states, rounds_total)
    val = transition_increments(states)                       # (..., M-1, n, 4)
    coef = torch.full_like(val, gamma)
    steps = val.shape[-3]
    offset = 1
    while offset < steps:
        c_early, v_early = coef[..., :-offset, :, :], val[..., :-offset, :, :]
        c_late, v_late = coef[..., offset:, :, :], val[..., offset:, :, :]
        new_c = c_early * c_late
        new_v = c_late * v_early + v_late
        coef = torch.cat([coef[..., :offset, :, :], new_c], dim=-3)
        val = torch.cat([val[..., :offset, :, :], new_v], dim=-3)
        offset *= 2
    return torch.cat([_zeros_counts(states, 2), val[..., :-1, :, :]], dim=-3)


def prev_state_rows(states: torch.Tensor) -> torch.Tensor:
    """(..., M, n) state observed entering each round (round 0 repeats
    itself — masked out by the round-0 fill everywhere it is used)."""
    return torch.cat([states[..., :1, :], states[..., :-1, :]], dim=-2)


def _first_round(states: torch.Tensor) -> torch.Tensor:
    return (torch.arange(states.shape[-2], device=states.device) == 0)[:, None]


def predict_from_counts(states: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The LEA prediction rule given per-round counts: smoothed transition
    estimates selected by the last observed state; 0.5 before any
    observation."""
    p_gg_hat, p_bb_hat = lea_mod.smoothed_transitions(counts)
    p_good = torch.where(prev_state_rows(states) == 1, p_gg_hat, 1.0 - p_bb_hat)
    return torch.where(_first_round(states), 0.5, p_good)


def lea_p_good(states: torch.Tensor) -> torch.Tensor:
    """Vanilla LEA's predicted p_good, equal to sequential
    :func:`repro_torch.core.lea.update_estimator` calls."""
    return predict_from_counts(states, counts_before_round(states))


def oracle_p_good(
    states: torch.Tensor,
    p_gg: torch.Tensor,
    p_bb: torch.Tensor,
    pi_g: torch.Tensor,
) -> torch.Tensor:
    """Genie p_good per round: the exact conditional given last round's true
    state (round 0: the stationary distribution of the round-0 chain).
    ``p_gg``/``p_bb`` are (B, n) or, time-varying, (B, M, n)."""
    if p_gg.dim() == states.dim() - 1:
        p_gg, p_bb = p_gg[..., None, :], p_bb[..., None, :]
    p_good = torch.where(prev_state_rows(states) == 1, p_gg, 1.0 - p_bb)
    return torch.where(_first_round(states), pi_g[..., None, :], p_good)


# ---------------------------------------------------------------------------
# registered policies
# ---------------------------------------------------------------------------


@register("lea", description="paper LEA: all-history transition counts (Sec. 3.2)")
def _lea(ctx: PolicyContext) -> torch.Tensor:
    return lea_p_good(ctx.states)


@register("oracle", uses_model=True,
          description="genie-aided optimum (Thm. 4.6): true one-step conditional")
def _oracle(ctx: PolicyContext) -> torch.Tensor:
    return oracle_p_good(ctx.states, ctx.p_gg, ctx.p_bb, ctx.pi_g)


def windowed_lea(window: int, name: str | None = None) -> Policy:
    """A sliding-window LEA policy instance (``resolve("lea_window<W>")``)."""
    if window < 1:
        raise ValueError("window must be >= 1")

    def traj(ctx: PolicyContext) -> torch.Tensor:
        return predict_from_counts(
            ctx.states, windowed_counts_before_round(ctx.states, window)
        )

    return Policy(
        name=name or f"lea_window{window}", trajectory=traj,
        description=f"windowed LEA: counts over the last {window} transitions",
    )


def _discount_name(gamma: float) -> str:
    """The canonical ``lea_discount<D>`` spelling (gamma = D / 10**len(D))."""
    digits = f"{gamma:.12f}".rstrip("0")[2:]
    if not digits or int(digits) / 10 ** len(digits) != gamma:
        raise ValueError(
            f"gamma={gamma!r} has no exact lea_discount<D> spelling; pass an "
            "explicit name="
        )
    return f"lea_discount{digits}"


def discounted_lea(gamma: float, name: str | None = None) -> Policy:
    """A discounted-count LEA policy instance (``resolve("lea_discount<D>")``)."""
    if not 0.0 < gamma < 1.0:
        raise ValueError("gamma must be in (0, 1)")

    def traj(ctx: PolicyContext) -> torch.Tensor:
        return predict_from_counts(
            ctx.states, discounted_counts_before_round(ctx.states, gamma)
        )

    return Policy(
        name=name or _discount_name(gamma), trajectory=traj,
        description=f"discounted LEA: counts decayed by gamma={gamma:g} per round",
    )


@register("thompson", description="Beta-posterior Thompson sampling on transition probs")
def _thompson(ctx: PolicyContext) -> torch.Tensor:
    """Posterior draw per round: p_gg ~ Beta(C_gg+1, C_gb+1) and
    p_bb ~ Beta(C_bb+1, C_bg+1) (the Laplace-smoothed counts ARE the
    posterior parameters), predict with the sample.  Rounds with no data
    draw from the uniform prior — native exploration."""
    draws = require(ctx.draws, BetaDraws)
    counts = counts_before_round(ctx.states)
    s_gg = draws.beta(counts[..., 0] + 1.0, counts[..., 1] + 1.0)
    s_bb = draws.beta(counts[..., 3] + 1.0, counts[..., 2] + 1.0)
    s_gg, s_bb = (s.to(ctx.states.device, torch.float32) for s in (s_gg, s_bb))
    prev_state = prev_state_rows(ctx.states)
    return torch.where(prev_state == 1, s_gg, 1.0 - s_bb)


@register("ucb", description="optimistic UCB: LEA estimate + sqrt(2 ln m / visits)")
def _ucb(ctx: PolicyContext) -> torch.Tensor:
    """The LEA point estimate plus a per-worker confidence bonus shrinking
    with the visits to the current conditioning state, clipped to [0, 1]."""
    states = ctx.states
    counts = counts_before_round(states)
    p_gg_hat, p_bb_hat = lea_mod.smoothed_transitions(counts)
    prev_state = prev_state_rows(states)
    p_hat = torch.where(prev_state == 1, p_gg_hat, 1.0 - p_bb_hat)
    visits = torch.where(
        prev_state == 1,
        counts[..., 0] + counts[..., 1],
        counts[..., 2] + counts[..., 3],
    )
    m = torch.arange(states.shape[-2], dtype=torch.float32,
                     device=states.device)[:, None]
    bonus = torch.sqrt(2.0 * torch.log1p(m) / (visits + 1.0))
    return torch.clamp(p_hat + bonus, 0.0, 1.0)


# concrete members of the parameterised families, pre-registered so
# ``policies.names()`` / the catalogue show canonical instances
from .registry import register_policy as _register_policy  # noqa: E402

_register_policy(windowed_lea(64))
_register_policy(windowed_lea(256))
_register_policy(discounted_lea(0.97))
