"""Which implementation a kernel call takes — decided by the tensor alone.

The port's rule has no options and no environment override:

  * a CUDA tensor goes to the hand-written CUDA kernel, or the call raises
    (no ``try`` that falls back to the plain version);
  * a CPU tensor goes to the plain PyTorch version;
  * any other device raises.
"""

from __future__ import annotations

import torch

KERNEL = "cuda"
PLAIN = "plain"


def route(t: torch.Tensor) -> str:
    """``"cuda"`` for a CUDA tensor, ``"plain"`` for a CPU tensor."""
    if t.device.type == "cuda":
        return KERNEL
    if t.device.type == "cpu":
        return PLAIN
    raise ValueError(f"no kernel route for device {t.device}")


__all__ = ["KERNEL", "PLAIN", "route"]
