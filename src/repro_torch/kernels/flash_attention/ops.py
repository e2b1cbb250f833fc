"""Routed flash attention: the kernel for CUDA tensors, the plain version
for CPU tensors (:mod:`repro_torch.kernels.dispatch`).

The JAX package's ``flash_attention`` without ``interpret=``.  On the card a
tensor the kernel cannot read through its strides (a head dimension that is
not contiguous, a misaligned row or base address) is copied first
(:func:`kernel_view`).  Neither route has a backward pass, and the call
raises rather than hand autograd an output it cannot differentiate.

On ``meta`` tensors (the dry run's stand-ins) nothing runs: the call
returns an empty tensor of q's shape and hands each observer
(:func:`add_meta_observer`) the launch's work (``kernel.launch_work``), so
a cost counter counts B6 as the kernel's own formula says.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import PLAIN, route

from .kernel import flash_attention_cuda, kernel_takes, launch_work
from .ref import flash_attention_ref

_META_OBSERVERS: list = []


def add_meta_observer(fn) -> None:
    """``fn(bytes, operations)`` is called for every call on meta tensors."""
    _META_OBSERVERS.append(fn)


def remove_meta_observer(fn) -> None:
    _META_OBSERVERS.remove(fn)


def kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it through its strides, else a
    dense copy in fresh (so aligned) storage: ``contiguous()`` alone would
    hand back a contiguous tensor whose base address is misaligned."""
    return t if kernel_takes(t) else t.clone(memory_format=torch.contiguous_format)


NO_BACKWARD = (
    "flash attention (B6) has no backward pass, in the JAX package as here; "
    "train with attn_impl='ref' or 'blockwise'")


def check_no_grad(*tensors: torch.Tensor) -> None:
    """Raise when autograd would need a gradient through B6: grad mode on and
    any input requiring grad.  The card's output is a fresh tensor with no
    ``grad_fn``, so a gradient would silently skip attention."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(NO_BACKWARD)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """(B, Hq, Sq, D) x (B, Hkv, Sk, D)^2 -> (B, Hq, Sq, D) in q's dtype.

    Forward only: with grad mode on and an input that requires grad it
    raises ``RuntimeError`` on both routes (:func:`check_no_grad`)."""
    check_no_grad(q, k, v)
    if q.device.type == "meta":
        for fn in _META_OBSERVERS:
            fn(*launch_work(q, k, causal, window))
        return torch.empty_like(q)
    if route(q) == PLAIN:
        return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    q, k, v = (kernel_view(t) for t in (q, k, v))
    return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)


__all__ = ["NO_BACKWARD", "add_meta_observer", "check_no_grad", "flash_attention",
           "kernel_view", "remove_meta_observer"]
