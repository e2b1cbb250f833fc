"""Dispatcher for the batched Poisson-binomial prefix tails.

``success_tails`` is the single entry point the allocator uses.  The route
follows the tensor (:mod:`repro_torch.kernels.dispatch`): CUDA tensors go
to the CUDA kernel, CPU tensors to the plain version.  The form of ``w``
picks the kernel's entry point, as in the JAX package:

  * a tuple, list or numpy array — static thresholds shared by every row
    (:func:`success_tails_cuda`);
  * a tensor broadcastable to ``probs`` — per-row thresholds
    (:func:`success_tails_cuda_w`), passed as they lie: a broadcast axis
    keeps stride 0 and nothing of ``probs``' size is written for them.

Any leading batch shape is accepted.

The allocation's engagement counter (:func:`count_allocate`, read by
:func:`allocate_engagement`) counts the CUDA rows ``core.lea.allocate_masked``
hands to each route: ``fused_rows`` (one launch of
:func:`allocate_masked_cuda`) and ``composed_rows`` (the sort, B1 and
``argmax``, for pools wider than ``ALLOCATE_MAX_N``).  CPU rows are not
counted.  They are rows, not launches: the kernels' launches are counted
where they launch (``kernel.launch_counts``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dispatch import PLAIN, route

from .kernel import success_tails_cuda, success_tails_cuda_w
from .ref import success_tails_ref

_ENGAGEMENT = {"fused_rows": 0, "composed_rows": 0}


def success_tails(probs: torch.Tensor, w) -> torch.Tensor:
    """(..., n) descending-sorted probabilities -> (..., n) prefix tails."""
    per_row = isinstance(w, torch.Tensor)
    if not per_row:
        w = tuple(int(v) for v in np.asarray(w).reshape(-1))
    if route(probs) == PLAIN:
        if per_row:
            return success_tails_ref(probs, w)
        return success_tails_ref(probs, torch.tensor(w, dtype=torch.int32))
    probs32 = probs.to(torch.float32).contiguous()
    if per_row:
        return success_tails_cuda_w(probs32, w.to(torch.int32))
    return success_tails_cuda(probs32, w)


def count_allocate(fused: bool, rows: int) -> None:
    """Add ``rows`` CUDA rows of an allocation to the route they took."""
    _ENGAGEMENT["fused_rows" if fused else "composed_rows"] += rows


def allocate_engagement() -> dict[str, int]:
    """CUDA rows of each allocation route since the last
    :func:`reset_allocate_engagement`."""
    return dict(_ENGAGEMENT)


def reset_allocate_engagement() -> None:
    for name in _ENGAGEMENT:
        _ENGAGEMENT[name] = 0


__all__ = ["allocate_engagement", "count_allocate", "reset_allocate_engagement",
           "success_tails", "success_tails_cuda", "success_tails_cuda_w",
           "success_tails_ref"]
