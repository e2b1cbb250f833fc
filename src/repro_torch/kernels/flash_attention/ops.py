"""Routed flash attention: the kernel for CUDA tensors, the plain version
for CPU tensors (:mod:`repro_torch.kernels.dispatch`).

The JAX package's ``flash_attention`` without ``interpret=``.  On the card a
tensor the kernel cannot read through its strides (a head dimension that is
not contiguous, a misaligned row or base address) is copied first
(:func:`kernel_view`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import PLAIN, route

from .kernel import flash_attention_cuda, kernel_takes
from .ref import flash_attention_ref


def kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it through its strides, else a
    dense copy in fresh (so aligned) storage: ``contiguous()`` alone would
    hand back a contiguous tensor whose base address is misaligned."""
    return t if kernel_takes(t) else t.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """(B, Hq, Sq, D) x (B, Hkv, Sk, D)^2 -> (B, Hq, Sq, D) in q's dtype."""
    if route(q) == PLAIN:
        return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    q, k, v = (kernel_view(t) for t in (q, k, v))
    return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)


__all__ = ["flash_attention", "kernel_view"]
