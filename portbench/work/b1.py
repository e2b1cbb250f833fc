"""Work of the Poisson-binomial prefix-tail DP (B1): the bytes and
operations one launch needs at the least, whatever implements it.

Bytes: the (rows, n) float32 probabilities read and the tails written
once each, and each distinct int32 threshold row read once.  Operations a
row: n(n+1)/2 fused multiply-adds of the DP (two each), n multiplies and n
subtractions (the factors 1 - p), and one add per tail term of each
feasible prefix: the counts max(w, 0) .. i+1 these thresholds need.
"""

from __future__ import annotations

import numpy as np


def launch_work(rows: int, n: int, w: np.ndarray, threshold_rows: int) -> tuple[int, int]:
    """``(bytes, operations)`` for ``rows`` DP rows of width ``n`` that all
    use the thresholds ``w`` (n,), of which ``threshold_rows`` distinct
    rows lie in memory."""
    w = np.asarray(w, np.int64)
    i = np.arange(n)
    tail_adds = int(np.where(w <= i + 1, i + 2 - np.maximum(w, 0), 0).sum())
    moved = 2 * rows * n * 4 + threshold_rows * n * 4
    return moved, rows * (n * (n + 1) + 2 * n) + rows * tail_adds
