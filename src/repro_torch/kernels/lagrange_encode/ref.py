"""Plain PyTorch version of the Lagrange encode/decode GEMM.

The oracle of the CUDA kernel in ``kernel.py`` and the route every CPU
tensor takes; it mirrors the JAX package's ``lagrange_encode/ref.py``.
"""

import torch


def encode_matrix_ref(g: torch.Tensor, x2d: torch.Tensor) -> torch.Tensor:
    """(nr, k) @ (k, cols) with float32 accumulation, in ``x2d``'s dtype."""
    return torch.matmul(g.to(torch.float32), x2d.to(torch.float32)).to(x2d.dtype)


def encode_ref(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(nr, k) x (k, *dims) -> (nr, *dims)."""
    lead = x.shape[0]
    out2d = encode_matrix_ref(g, x.reshape(lead, -1))
    return out2d.reshape((g.shape[0],) + tuple(x.shape[1:]))


__all__ = ["encode_matrix_ref", "encode_ref"]
