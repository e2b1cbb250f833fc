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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dispatch import PLAIN, route

from .kernel import success_tails_cuda, success_tails_cuda_w
from .ref import success_tails_ref


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


__all__ = ["success_tails", "success_tails_cuda", "success_tails_cuda_w",
           "success_tails_ref"]
