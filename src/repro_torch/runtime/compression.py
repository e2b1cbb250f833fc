"""Gradient compression for cross-pod reduction (``repro/runtime/compression.py``).

Two schemes, both with error feedback (the residual of what compression
dropped is carried into the next step, preserving convergence):

  * ``int8``  — per-tensor symmetric quantization (4x bf16 / 2x fp32 saving)
  * ``topk``  — magnitude top-k sparsification (``k_frac`` of entries kept)

``make_compressor`` returns ``(init_state, apply)`` where
``apply(grads, state) -> (decompressed_grads, new_state)``; gradients and
states are dicts of tensors under the same names (the trainer's flat
gradient dict).  Plain PyTorch, float32 as in JAX; ``top_k`` is
``torch.topk``.
"""

from __future__ import annotations

import torch

_F32 = torch.float32


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(_F32) * scale


def _topk_mask(x: torch.Tensor, k_frac: float) -> torch.Tensor:
    flat = torch.abs(x.reshape(-1))
    k = max(1, int(flat.shape[0] * k_frac))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(x) >= thresh).to(x.dtype)


def make_compressor(kind: str, *, k_frac: float = 0.05):
    """Returns ``(init_state_fn, apply_fn)`` with error feedback."""

    if kind == "int8":
        def transform(g, residual):
            total = g.to(_F32) + residual
            q, s = _quantize_int8(total)
            deq = _dequantize_int8(q, s)
            return deq, total - deq
    elif kind == "topk":
        def transform(g, residual):
            total = g.to(_F32) + residual
            kept = total * _topk_mask(total, k_frac)
            return kept, total - kept
    elif kind == "none":
        def transform(g, residual):
            return g.to(_F32), residual
    else:
        raise ValueError(kind)

    def init_state(grads_like: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return {name: torch.zeros(g.shape, dtype=_F32, device=g.device)
                for name, g in grads_like.items()}

    def apply(grads: dict[str, torch.Tensor], state: dict[str, torch.Tensor]):
        outs = {name: transform(g, state[name]) for name, g in grads.items()}
        return ({name: o[0] for name, o in outs.items()},
                {name: o[1] for name, o in outs.items()})

    return init_state, apply


def compressed_bytes(kind: str, n_elems: int, *, k_frac: float = 0.05) -> int:
    """Wire size of one compressed gradient — for the collective roofline."""
    if kind == "int8":
        return n_elems + 4
    if kind == "topk":
        k = max(1, int(n_elems * k_frac))
        return k * (4 + 4)     # value + index
    return n_elems * 4


__all__ = ["compressed_bytes", "make_compressor"]
