"""Routed fused coded gradient: the kernel for CUDA tensors, the plain
version for CPU tensors (:mod:`repro_torch.kernels.dispatch`).

The JAX package's ``coded_gradient`` without ``interpret=``: it takes
vector targets/weights ((nr, R) and (C,)) and squeezes back, and it raises
the JAX wrapper's footprint ``ValueError`` on every route, so the same
inputs raise in both packages.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import PLAIN, route

from .kernel import check_footprint, coded_gradient_cuda
from .ref import coded_gradient_ref


def coded_gradient(x_tilde: torch.Tensor, y_tilde: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """(nr,R,C),(nr,R,P),(C,P) -> (nr,C,P): all chunk gradients, fused.

    Accepts vector targets/weights ((nr,R) and (C,)) and squeezes back.
    """
    squeeze = False
    if y_tilde.dim() == 2 and w.dim() == 1:
        y_tilde = y_tilde[..., None]
        w = w[:, None]
        squeeze = True
    nr, r_rows, c = x_tilde.shape
    p = y_tilde.shape[2]
    if w.shape != (c, p):
        raise ValueError(f"w must have shape {(c, p)}, got {tuple(w.shape)}")
    check_footprint(r_rows, c, p)
    if route(x_tilde) == PLAIN:
        out = coded_gradient_ref(x_tilde, y_tilde, w)
    else:
        out = coded_gradient_cuda(
            x_tilde.to(torch.float32).contiguous(),
            y_tilde.to(torch.float32).contiguous(),
            w.to(torch.float32).contiguous(),
        ).to(w.dtype)
    return out[..., 0] if squeeze else out


__all__ = ["coded_gradient", "coded_gradient_ref"]
