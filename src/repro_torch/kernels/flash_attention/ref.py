"""Plain PyTorch versions of causal / sliding-window GQA attention.

* :func:`attention_ref` ports the JAX package's oracle
  (``repro/kernels/flash_attention/ref.py``): masked scores at ``-inf``, so a
  query row that sees no key comes out NaN.
* :func:`flash_attention_ref` is what the kernel computes
  (``_flash_kernel`` in ``repro/kernels/flash_attention/kernel.py``): masked
  scores at ``-1e30``, and a row that sees no key comes out 0 (the kernel's
  ``l == 0`` guard).  It is the CUDA kernel's oracle on the card and the
  route every CPU tensor takes.

Both take q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D) with Hq a multiple of
Hkv; query head h reads KV head h // (Hq / Hkv) without repeating K or V.
Queries are right-aligned: query i sits at position i + Sk - Sq.  Both
compute in float32 and return q's dtype.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def visible_mask(rows: range, sq: int, sk: int, causal: bool,
                 window: int | None, device=None) -> torch.Tensor:
    """(len(rows), sk) bool: which keys the query rows ``rows`` of ``sq``
    right-aligned queries see."""
    q_pos = torch.arange(rows.start, rows.stop, device=device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((len(rows), sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _grouped(q: torch.Tensor, k: torch.Tensor):
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} are not a multiple of KV heads {hkv}")
    return b, hq, hkv, hq // hkv, sq, sk, d


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """The JAX package's ``attention_ref``: float32 softmax over masked
    scores (``-inf``), in q's dtype."""
    b, hq, hkv, g, sq, sk, d = _grouped(q, k)
    if scale is None:
        scale = d ** -0.5
    kk = torch.repeat_interleave(k, g, dim=1).to(torch.float32)
    vv = torch.repeat_interleave(v, g, dim=1).to(torch.float32)
    logits = torch.matmul(q.to(torch.float32), kk.transpose(-1, -2)) * scale
    mask = visible_mask(range(sq), sq, sk, causal, window, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, vv).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None,
                        block_q: int | None = None) -> torch.Tensor:
    """What ``_flash_kernel`` computes, in one pass over the keys: scores
    masked at -1e30, the softmax numerator zeroed where masked, and the
    row sum ``l`` replaced by 1 where it is 0, so a row that sees no key
    is 0.  Float32 throughout (P stays float32 for the P.V product), the
    result in q's dtype.

    ``block_q`` computes the rows ``block_q`` at a time, which bounds the
    (B, Hq, block_q, Sk) float32 scores; the result is the same.
    """
    b, hq, hkv, g, sq, sk, d = _grouped(q, k)
    if scale is None:
        scale = float(d) ** -0.5
    out = torch.zeros_like(q)
    if sk == 0:
        return out
    kf = k.to(torch.float32)[:, :, None]            # (B, Hkv, 1, Sk, D)
    vf = v.to(torch.float32)[:, :, None]
    step = sq if not block_q else block_q
    for r0 in range(0, sq, max(step, 1)):
        rows = range(r0, min(r0 + step, sq))
        qf = q[:, :, rows.start:rows.stop].to(torch.float32)
        qf = qf.reshape(b, hkv, g, len(rows), d)
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale   # (B, Hkv, G, rows, Sk)
        mask = visible_mask(rows, sq, sk, causal, window, q.device)
        s = s.masked_fill(~mask, _NEG)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m).masked_fill(~mask, 0.0)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p, vf) / torch.where(l == 0.0, 1.0, l)
        out[:, :, rows.start:rows.stop] = o.reshape(b, hq, len(rows), d).to(q.dtype)
    return out


__all__ = ["attention_ref", "flash_attention_ref", "visible_mask"]
