"""Dispatcher for the batched Poisson-binomial prefix tails.

``success_tails`` is the single entry point the allocator uses.  The route
follows the tensor (:mod:`repro_torch.kernels.dispatch`): CUDA tensors go
to the CUDA kernel, CPU tensors to the plain version.  The form of ``w``
picks the kernel's entry point, as in the JAX package:

  * a tuple, list or numpy array — static thresholds shared by every row
    (:func:`success_tails_cuda`);
  * a tensor broadcastable to ``probs`` — per-row thresholds
    (:func:`success_tails_cuda_w`).

Any leading batch shape is accepted; rows are flattened to (B, n) for the
kernel and reshaped back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dispatch import PLAIN, route

from .kernel import success_tails_cuda, success_tails_cuda_w
from .ref import success_tails_ref


def success_tails(probs: torch.Tensor, w) -> torch.Tensor:
    """(..., n) descending-sorted probabilities -> (..., n) prefix tails."""
    n = probs.shape[-1]
    per_row = isinstance(w, torch.Tensor)
    if not per_row:
        w = tuple(int(v) for v in np.asarray(w).reshape(-1))
    if route(probs) == PLAIN:
        if per_row:
            return success_tails_ref(probs, w)
        return success_tails_ref(probs, torch.tensor(w, dtype=torch.int32))
    flat = probs.to(torch.float32).reshape(-1, n).contiguous()
    if per_row:
        w_flat = torch.broadcast_to(w.to(torch.int32), probs.shape)
        out = success_tails_cuda_w(flat, w_flat.reshape(-1, n).contiguous())
    else:
        out = success_tails_cuda(flat, w)
    return out.reshape(probs.shape)


__all__ = ["success_tails", "success_tails_cuda", "success_tails_cuda_w",
           "success_tails_ref"]
