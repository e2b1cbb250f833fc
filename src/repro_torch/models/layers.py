"""The dense-LM part of the JAX package's layer library
(``repro/models/layers.py``), as plain functions on tensors.

Parameters are mappings of tensors under the JAX names and layouts: one
layer's block tensors (``wq``, ``wk``, ``wv``, ``wo``, ``q_scale``,
``k_scale``, ``w_gate``, ``w_up``, ``w_down``), weights as (in, out) applied
as ``x @ w``.  Storage is in the config's dtype with float32 accumulation.
Where JAX asks a bf16 x bf16 product for a float32 result
(``preferred_element_type``), the port multiplies float32 copies of the
bf16 operands: the products are exact in float32, so the result is JAX's up
to summation order.

Attention implementations, chosen by ``cfg.attn_impl`` as in JAX:

  * ``ref``       — dense masked softmax (:func:`_dense_attention`);
  * ``blockwise`` — online softmax over 512-key blocks in plain PyTorch;
  * ``flash``     — the routed flash-attention kernel (B6): the CUDA kernel
                    for CUDA tensors, its plain version on the CPU.

What is left out, and why:

  * the ``shard()`` constraints of ``repro/models/sharding.py``: one card has
    no mesh, so they are omitted, and ``native_out`` (bf16 partial sums
    under tensor parallelism) has nothing to act on;
  * ``_sharded_lse_decode`` and MoE, Mamba2, mLSTM and sLSTM, which wait for
    the slices that port those families.

:func:`attention_decode` writes the new key and value into the cache in
place; JAX returns updated copies (aliased to donated buffers).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import visible_mask

Params = Mapping[str, torch.Tensor]
_NEG = -1e30
_F32 = torch.float32


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def dot(x: torch.Tensor, w: torch.Tensor, *, native_out: bool = False) -> torch.Tensor:
    """Matmul with float32 accumulation, output in x.dtype.

    For bf16 operands ``torch.matmul`` accumulates in float32 (cuBLAS); the
    step functions of ``models.api`` also turn
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    off for their call (``api.float32_split_k_sums``), so split-K partials
    are added in float32 too.  ``native_out`` is accepted for the JAX
    signature and has no effect on one card.
    """
    del native_out
    if x.dtype == w.dtype:
        return torch.matmul(x, w)
    return torch.matmul(x.to(_F32), w.to(_F32)).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In float32, cast to x.dtype, and only then times ``scale``."""
    xf = x.to(_F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on concatenated halves (not interleaved pairs).
    x: (..., S, H, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=_F32, device=x.device) / half)
    angles = positions[..., None].to(_F32) * freq                 # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].to(_F32), x[..., half:].to(_F32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# attention (GQA + qk-norm + sliding window)
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, d))


def _qk_normalize(q, k, p, cfg):
    if cfg.qk_norm:
        q = rms_norm(q, p["q_scale"])
        k = rms_norm(k, p["k_scale"])
    return q, k


def attention_train(
    x: torch.Tensor,                 # (B, S, d)
    p: Params,
    cfg,
    *,
    positions: torch.Tensor,         # (S,)
    causal: bool = True,
    kv_x: torch.Tensor | None = None,   # cross-attention source (B, Sk, d)
    return_kv: bool = False,
):
    """Full-sequence attention.  q, k and v go to the attention
    implementation as the (B, H, S, D) views ``transpose(1, 2)`` makes of the
    (B, S, H, D) projections: no copy, the kernel reads them through their
    strides and writes its output in q's layout."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    src = x if kv_x is None else kv_x
    sk = src.shape[1]
    q = _split_heads(dot(x, p["wq"]), hq, hd)            # (B, S, Hq, Dh)
    k = _split_heads(dot(src, p["wk"]), hkv, hd)
    v = _split_heads(dot(src, p["wv"]), hkv, hd)
    q, k = _qk_normalize(q, k, p, cfg)
    if kv_x is None:                                     # self-attn: rotary
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions[:sk] if positions.shape[0] >= sk else positions,
                 cfg.rope_theta)
    q = q.transpose(1, 2)                                # (B, Hq, S, Dh)
    k = k.transpose(1, 2)                                # (B, Hkv, Sk, Dh)
    v = v.transpose(1, 2)

    is_causal = causal and kv_x is None
    impl = getattr(cfg, "attn_impl", "ref")
    if impl == "flash":
        o = flash_attention(q, k, v, causal=is_causal, window=cfg.window)
    elif impl == "blockwise":
        o = _blockwise_attention(q, k, v, causal=is_causal, window=cfg.window)
    else:
        o = _dense_attention(q, k, v, causal=is_causal, window=cfg.window)
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    y = dot(o, p["wo"], native_out=getattr(cfg, "bf16_reduce", False))
    if return_kv:
        return y, (k, v)
    return y


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B,Hq,S,D) x (B,Hkv,Sk,D) -> float32 (B,Hq,S,Sk) without repeating KV."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, s, d).to(_F32)
    out = torch.matmul(qg, k.to(_F32)[:, :, None].transpose(-1, -2))
    return out.reshape(b, hq, s, k.shape[2])


def _gqa_combine(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """float32 (B,Hq,S,Sk) x (B,Hkv,Sk,D) -> float32 (B,Hq,S,D).

    The weights are rounded to v's dtype first (the flash-attention
    convention JAX follows), then summed in float32.
    """
    b, hq, s, sk = w.shape
    hkv = v.shape[1]
    wg = w.reshape(b, hkv, hq // hkv, s, sk).to(v.dtype).to(_F32)
    out = torch.matmul(wg, v.to(_F32)[:, :, None])
    return out.reshape(b, hq, s, v.shape[3])


def _attn_mask(sq: int, sk: int, causal: bool, window: int | None,
               device=None) -> torch.Tensor:
    return visible_mask(range(sq), sq, sk, causal, window, device)


def _dense_attention(q, k, v, *, causal: bool, window: int | None):
    d = q.shape[-1]
    s = _gqa_scores(q, k) * (d ** -0.5)                  # f32 (B,H,S,Sk)
    mask = _attn_mask(q.shape[2], k.shape[2], causal, window, q.device)
    s = torch.where(mask, s, _NEG)
    w = torch.softmax(s, dim=-1)
    return _gqa_combine(w, v).to(q.dtype)


def _blockwise_attention(q, k, v, *, causal: bool, window: int | None,
                         block: int = 512):
    """Online softmax over KV blocks of ``block`` keys, in plain PyTorch."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    scale = d ** -0.5
    nk = (sk + block - 1) // block
    pad = nk * block - sk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    m_prev = torch.full((b, hq, sq), _NEG, dtype=_F32, device=q.device)
    l_prev = torch.zeros((b, hq, sq), dtype=_F32, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=_F32, device=q.device)
    for ik in range(nk):
        kblk = k[:, :, ik * block:(ik + 1) * block]
        vblk = v[:, :, ik * block:(ik + 1) * block]
        s = _gqa_scores(q, kblk) * scale                 # f32 (B,H,S,block)
        k_pos = ik * block + torch.arange(block, device=q.device)[None, :]
        mask = k_pos < sk
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        alpha = torch.exp(m_prev - m_new)
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        l_prev = alpha * l_prev + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _gqa_combine(p, vblk)
        m_prev = m_new
    l_safe = torch.where(l_prev == 0.0, 1.0, l_prev)
    return (acc / l_safe[..., None]).to(q.dtype)


def attention_decode(
    x_t: torch.Tensor,               # (B, 1, d)
    p: Params,
    cfg,
    cache_k: torch.Tensor,           # (B, Hkv, S, Dh), written in place
    cache_v: torch.Tensor,
    pos: torch.Tensor,               # 0-dim int: tokens already cached
    *,
    cross: bool = False,             # cross-attn: read-only cache, no rope, attend [0, pos)
):
    """One query token against the cache: returns (y, cache_k, cache_v),
    the caches being the same tensors, with the new key and value written
    at ``pos`` (self-attention)."""
    b = x_t.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = _split_heads(dot(x_t, p["wq"]), hq, hd)          # (B,1,Hq,Dh)
    g = hq // hkv
    if not cross:
        k_new = _split_heads(dot(x_t, p["wk"]), hkv, hd)
        v_new = _split_heads(dot(x_t, p["wv"]), hkv, hd)
        q, k_new = _qk_normalize(q, k_new, p, cfg)
        q = rope(q, pos[None], cfg.rope_theta)
        k_new = rope(k_new, pos[None], cfg.rope_theta)
        at = pos.reshape(1).to(torch.int64)
        cache_k.index_copy_(2, at, k_new.transpose(1, 2).to(cache_k.dtype))
        cache_v.index_copy_(2, at, v_new.transpose(1, 2).to(cache_v.dtype))
        valid_len = pos + 1
    else:
        if cfg.qk_norm:
            q, _ = _qk_normalize(q, q, p, cfg)
        valid_len = pos

    qg = q[:, 0].reshape(b, hkv, g, hd)
    # float32 products of the cache's values, summed in float32
    s = torch.matmul(qg.to(cache_k.dtype).to(_F32),
                     cache_k.to(_F32).transpose(-1, -2)) * (hd ** -0.5)
    k_pos = torch.arange(cache_k.shape[2], device=cache_k.device)
    mask = k_pos < valid_len
    if cfg.window is not None and not cross:
        mask &= k_pos > valid_len - 1 - cfg.window
    s = torch.where(mask, s, _NEG)
    w = torch.softmax(s, dim=-1).to(cache_v.dtype)
    o = torch.matmul(w.to(_F32), cache_v.to(_F32))
    o = o.reshape(b, 1, hq * hd).to(x_t.dtype)
    y = dot(o, p["wo"])
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    nat = getattr(cfg, "bf16_reduce", False)
    if cfg.mlp_type == "swiglu":
        return dot(silu(dot(x, p["w_gate"])) * dot(x, p["w_up"]), p["w_down"],
                   native_out=nat)
    if cfg.mlp_type == "squared_relu":
        h = torch.relu(dot(x, p["w_up"]))
        return dot(h * h, p["w_down"], native_out=nat)
    if cfg.mlp_type == "gelu":
        return dot(F.gelu(dot(x, p["w_up"]), approximate="tanh"), p["w_down"],
                   native_out=nat)
    raise ValueError(cfg.mlp_type)


__all__ = ["attention_decode", "attention_train", "dot", "mlp", "rms_norm",
           "rope", "silu"]
