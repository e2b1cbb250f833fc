"""Plain PyTorch version of the fused degree-2 coded gradient.

The oracle of the CUDA kernel in ``kernel.py`` and the route every CPU
tensor takes; it mirrors the JAX package's ``coded_gradient/ref.py``.
"""

import torch


def chunk_gradient_ref(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """X^T (X W - Y) for one chunk: (R,C),(R,P),(C,P) -> (C,P), f32 accum."""
    x32 = x.to(torch.float32)
    resid = torch.matmul(x32, w.to(torch.float32)) - y.to(torch.float32)
    return torch.matmul(x32.T, resid).to(w.dtype)


def coded_gradient_ref(x_tilde: torch.Tensor, y_tilde: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """(nr,R,C),(nr,R,P),(C,P) -> (nr,C,P), every chunk in one batched pair
    of products."""
    x32 = x_tilde.to(torch.float32)
    resid = torch.matmul(x32, w.to(torch.float32)) - y_tilde.to(torch.float32)
    return torch.matmul(x32.transpose(1, 2), resid).to(w.dtype)


__all__ = ["chunk_gradient_ref", "coded_gradient_ref"]
