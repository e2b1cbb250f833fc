"""Plain PyTorch version of the batched Poisson-binomial prefix-tail DP.

The oracle of the CUDA kernel in ``kernel.py`` and the path every CPU
tensor takes.  It mirrors the JAX package's ``poisson_binomial/ref.py``:
convolve one Bernoulli at a time into the pmf over counts 0..n and read the
tail P[count >= w(i~)] off after every prefix.

It repeats the arithmetic of that reference as XLA runs it on the CPU, so
both give the same float32 bits:

  * the convolution step is ``fma(shifted, p, pmf * (1 - p))`` — XLA
    contracts the multiply-add into one fused multiply-add.  PyTorch has no
    fma for CPU tensors, so the fused step is formed in float64 (the product
    of two float32 values is exact there) and rounded once to float32;
  * each tail is summed sequentially over ascending counts, as XLA's
    reduction loop does.

The CUDA kernel issues the same operations (``__fmaf_rn``, ``__fmul_rn``,
``__fadd_rn`` in the same order), so kernel and plain version agree to the
bit but for a double rounding in the float64 step, which no test input has
shown.

Thresholds: ``w`` is (n,) shared or any int tensor broadcastable to
``probs`` (per-row thresholds).  ``w > i~`` is infeasible and scores 0;
``w <= 0`` always succeeds.  Mask-padded pools need nothing extra: a padded
worker has p = 0 (an identity convolution) and an infeasible threshold.
"""

from __future__ import annotations

import torch


def success_tails_ref(probs: torch.Tensor, w) -> torch.Tensor:
    """(..., n) descending-sorted probabilities -> (..., n) float32 tails
    P[Poisson-binomial(top i~ of the row) >= w(i~)]."""
    probs = torch.as_tensor(probs, dtype=torch.float32)
    w = torch.as_tensor(w, dtype=torch.int32, device=probs.device)
    w = torch.broadcast_to(w, probs.shape)
    n = probs.shape[-1]
    batch = probs.shape[:-1]
    pmf = torch.zeros(batch + (n + 1,), dtype=torch.float32, device=probs.device)
    pmf[..., 0] = 1.0
    w_lo = torch.clamp(w, min=0)
    tails = []
    for i in range(n):
        p = probs[..., i : i + 1]
        shifted = torch.cat([torch.zeros_like(pmf[..., :1]), pmf[..., :-1]], dim=-1)
        kept = pmf * (1.0 - p)
        pmf = (shifted.double() * p.double() + kept.double()).float()
        # counts above i + 1 hold exact zeros, which leave the sum unchanged
        acc = torch.zeros(batch, dtype=torch.float32, device=probs.device)
        for c in range(i + 2):
            acc = acc + torch.where(w_lo[..., i] <= c, pmf[..., c], 0.0)
        tails.append(acc)
    out = torch.stack(tails, dim=-1)
    i_tilde = torch.arange(1, n + 1, dtype=torch.int32, device=probs.device)
    return torch.where(w > i_tilde, 0.0, out)


__all__ = ["success_tails_ref"]
