"""Timely-throughput regret accounting against the genie oracle.

Per-round regret of a policy is the oracle's success indicator minus the
policy's on the SAME worker trajectory (the engine runs all strategies on
one shared trajectory, so the comparison is paired); cumulative regret is
its running sum.  ``succ`` is any ``(..., M, S)`` success array (numpy or a
tensor); every function maps over the leading axes.  Sums of 0/1
indicators are taken in float32 (exact below 2^24 rounds).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

REFERENCE = "oracle"


def _strategy_index(strategies: Sequence[str], name: str) -> int:
    try:
        return tuple(strategies).index(name)
    except ValueError:
        raise ValueError(
            f"strategy {name!r} not in {tuple(strategies)}; regret needs the "
            f"reference policy in the simulated strategy tuple"
        ) from None


def per_round_regret(succ, strategies: Sequence[str], policy: str,
                     reference: str = REFERENCE) -> torch.Tensor:
    """(..., M) per-round regret of ``policy`` vs ``reference`` (+1, 0, -1)."""
    succ = torch.as_tensor(succ)
    j_ref = _strategy_index(strategies, reference)
    j_pol = _strategy_index(strategies, policy)
    return succ[..., j_ref].to(torch.float32) - succ[..., j_pol].to(torch.float32)


def cumulative_regret(succ, strategies: Sequence[str], policy: str,
                      reference: str = REFERENCE) -> torch.Tensor:
    """(..., M) running cumulative regret along the round axis."""
    return torch.cumsum(per_round_regret(succ, strategies, policy, reference), dim=-1)


def final_regret(succ, strategies: Sequence[str],
                 reference: str = REFERENCE) -> Mapping[str, np.ndarray]:
    """``{strategy: (...,) float64}`` total regret per strategy over rounds
    (the reference maps to exact zeros)."""
    return {
        s: per_round_regret(succ, strategies, s, reference).sum(dim=-1)
        .cpu().numpy().astype(np.float64)
        for s in strategies
    }


def regret_curve_summary(succ, strategies: Sequence[str], policy: str,
                         reference: str = REFERENCE, *,
                         points: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """(rounds, mean cumulative regret) sampled at ``points`` horizons,
    averaged over all leading batch axes."""
    cum = cumulative_regret(succ, strategies, policy, reference).cpu().numpy()
    cum = cum.astype(np.float64)
    rounds_total = cum.shape[-1]
    idx = np.unique(
        np.linspace(1, rounds_total, num=min(points, rounds_total), dtype=int)
    ) - 1
    mean_cum = cum.reshape(-1, rounds_total).mean(axis=0)
    return idx + 1, mean_cum[idx]
