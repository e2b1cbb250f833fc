"""Routed Lagrange encode: the kernel for CUDA tensors, the plain version
for CPU tensors (:mod:`repro_torch.kernels.dispatch`).

The JAX package's ``encode_matrix`` / ``encode`` without ``interpret=``.
The kernel computes in float32 and returns float32, so on the card the
inputs are cast to float32 and the result back to ``x2d``'s dtype, as the
Pallas kernel's float32 accumulation does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import PLAIN, route

from .kernel import encode_matrix_cuda
from .ref import encode_matrix_ref, encode_ref


def encode_matrix(g: torch.Tensor, x2d: torch.Tensor) -> torch.Tensor:
    """(nr, k) @ (k, cols) -> (nr, cols), float32 accumulation."""
    if route(x2d) == PLAIN:
        return encode_matrix_ref(g, x2d)
    out = encode_matrix_cuda(g.to(torch.float32).contiguous(),
                             x2d.to(torch.float32).contiguous())
    return out.to(x2d.dtype)


def encode(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``repro_torch.core.lagrange.encode``: (nr,k) x (k,*dims)."""
    lead = x.shape[0]
    out2d = encode_matrix(g, x.reshape(lead, -1))
    return out2d.reshape((g.shape[0],) + tuple(x.shape[1:]))


__all__ = ["encode", "encode_matrix", "encode_ref"]
