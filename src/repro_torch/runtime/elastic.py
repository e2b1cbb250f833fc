"""Elastic scaling: reshard state across mesh-size changes (DESIGN §7).

The checkpoint format is mesh-agnostic (full host arrays), so growing or
shrinking the cluster = restore with the new mesh's shardings
(``checkpoint.restore(..., shardings=)``), or :func:`reshard_state` of a
live state.  LEA estimator counts follow the worker pool: survivors keep
their history, newcomers start from the pooled average (a better prior
than the 0.5 cold start).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lea


def reshard_state(state, shardings):
    """Every tensor of ``state`` placed on the new mesh's shardings (a tree
    of the same structure: ``api.state_shardings`` of the new mesh); a
    DTensor is gathered from its old mesh first, a collective every rank of
    the old mesh joins (``jax.device_put`` of each leaf)."""
    from repro_torch.models.api import distribute_tree

    return distribute_tree(state, shardings)


def remap_estimator(est: lea.EstimatorState, old_n: int, new_n: int,
                    survivors: list[int] | None = None) -> lea.EstimatorState:
    """Carry LEA counts across an elastic resize.

    ``survivors`` maps old worker indices onto the first slots of the new
    pool (default: the identity prefix); every other slot is a newcomer
    with the pooled counts and a good last state.  The result lies on the
    device of ``est``.
    """
    dev = est.counts.device
    counts = est.counts.cpu().numpy()
    prev = est.prev_state.cpu().numpy()
    if survivors is None:
        survivors = list(range(min(old_n, new_n)))
    new_counts = np.zeros((new_n, 4), np.float32)
    new_prev = np.zeros((new_n,), np.int32)
    pooled = counts[survivors].mean(axis=0) if survivors else np.zeros(4, np.float32)
    for i in range(new_n):
        if i < len(survivors):
            new_counts[i] = counts[survivors[i]]
            new_prev[i] = prev[survivors[i]]
        else:
            new_counts[i] = pooled       # newcomer: pooled prior
            new_prev[i] = 1
    return lea.EstimatorState(
        counts=torch.as_tensor(new_counts, device=dev),
        prev_state=torch.as_tensor(new_prev, device=dev),
        seen_prev=est.seen_prev,
    )


__all__ = ["remap_estimator", "reshard_state"]
