"""Policy protocol for the scheduling-policy subsystem.

A *policy* is a pluggable scheduler for the timely-throughput engine: given
the worker-state trajectories it emits, per round, the predicted probability
that each worker is good.  The engine feeds every round of every policy
through one batched :func:`repro_torch.core.lea.allocate` call (Lemma 4.5's
two-level assignment).  A policy IS its estimator-state replay, written as
a closed-form batched function of the trajectory instead of a sequential
per-round update loop.

Shapes: ``states`` is (B, M, n) — B independent rows, M rounds, n workers —
and a policy returns (B, M, n) float32 in [0, 1].

Causality contract: round m's prediction may read ``states[:, :m]`` only.
The genie oracle is the one sanctioned exception — it also reads the true
chain (``ctx.p_gg`` / ``ctx.p_bb``) and is the regret reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


class PolicyContext(NamedTuple):
    """Everything a policy's trajectory function may look at.

    ``p_gg``/``p_bb`` are the TRUE chains — (B, n) stationary or (B, M, n)
    time-varying (row t governs the transition into round t).  Only genie
    policies (``uses_model=True``) may read them.  ``draws`` is the run's
    draws source; only randomised policies (``thompson``) take from it,
    through :class:`~repro_torch.random.BetaDraws`, so deterministic
    policies give the same results whether or not it is there.
    """

    states: torch.Tensor      # (B, M, n) int32 observed trajectories, 1=good
    p_gg: torch.Tensor        # (B, n) or (B, M, n)
    p_bb: torch.Tensor        # (B, n) or (B, M, n)
    pi_g: torch.Tensor        # (B, n) stationary dist of the round-0 chain
    draws: object = None      # the run's draws source


@dataclasses.dataclass(frozen=True)
class Policy:
    """A named scheduler: trajectory function + capability flags."""

    name: str
    trajectory: Callable[[PolicyContext], torch.Tensor]
    uses_model: bool = False        # genie: reads the true p_gg/p_bb
    description: str = ""

    def __post_init__(self):
        if not self.name or not self.name.isidentifier():
            raise ValueError(f"policy name must be an identifier, got {self.name!r}")

    def p_good_trajectory(self, ctx: PolicyContext) -> torch.Tensor:
        """Run the estimator replay and check the output shape."""
        p = self.trajectory(ctx)
        if p.shape != ctx.states.shape:
            raise ValueError(
                f"policy {self.name!r} returned shape {tuple(p.shape)}, "
                f"expected {tuple(ctx.states.shape)}"
            )
        return p
