"""The JAX package's layer library (``repro/models/layers.py``) for the
decoder-only LMs, as plain functions on tensors.

Parameters are mappings of tensors under the JAX names and layouts: one
layer's block tensors (``wq``, ``wk``, ``wv``, ``wo``, ``q_scale``,
``k_scale``, ``w_gate``, ``w_up``, ``w_down``, ``router``; Mamba2's
``in_proj``, ``conv_w``, ...), weights as (in, out) applied as ``x @ w``.  Storage is in the config's dtype with float32 accumulation.
Where JAX asks a bf16 x bf16 product for a float32 result
(``preferred_element_type``), the port multiplies float32 copies of the
bf16 operands: the products are exact in float32, so the result is JAX's up
to summation order.

Attention implementations, chosen by ``cfg.attn_impl`` as in JAX:

  * ``ref``       — dense masked softmax (:func:`_dense_attention`);
  * ``blockwise`` — online softmax over 512-key blocks in plain PyTorch;
  * ``flash``     — the routed flash-attention kernel (B6): the CUDA kernel
                    for CUDA tensors, its plain version on the CPU.

Sequence mixers and MoE, in plain PyTorch as the JAX package computes them
in plain ``jnp`` / ``lax`` (no Pallas kernel): :func:`moe` (per-example
capacity routing, batched over the examples), Mamba2 / SSD
(:func:`mamba2_scan`, :func:`mamba2_decode`), mLSTM
(:func:`mlstm_chunked`, :func:`mlstm_decode`) and sLSTM
(:func:`slstm_scan`).  JAX's ``lax.scan`` over chunks and time steps is a
Python loop here.

What is left out, and why:

  * the ``shard()`` constraints of ``repro/models/sharding.py``: one card has
    no mesh, so they are omitted, and ``native_out`` (bf16 partial sums
    under tensor parallelism) has nothing to act on;
  * ``_sharded_lse_decode`` (a ``decode_attn="sharded_lse"`` config decodes
    locally, as JAX does with no mesh) and ``_moe_ep`` (``moe_impl="ep"``
    routes densely, as JAX does with no mesh); both wait for the multi-card
    slice (ROADMAP A7c).

:func:`attention_decode` writes the new key and value into the cache in
place; JAX returns updated copies (aliased to donated buffers).
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import visible_mask

Params = Mapping[str, torch.Tensor]
DECODE_ATTN = ("auto", "local", "sharded_lse")
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
    at ``pos`` (self-attention).

    ``cfg.decode_attn`` may be ``auto``, ``local`` or ``sharded_lse``; any
    other value raises.  All three take the local path here: JAX takes its
    sharded path (``_sharded_lse_decode``, flash-decoding over a
    sequence-sharded cache) only under an active mesh, and the port has no
    mesh; that path waits for the multi-card slice (ROADMAP A7c)."""
    if getattr(cfg, "decode_attn", "auto") not in DECODE_ATTN:
        raise ValueError(f"decode_attn {cfg.decode_attn!r} is not one of {DECODE_ATTN}")
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
# MLP
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


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

class MoeRoutes(NamedTuple):
    """One :func:`moe` call's routing.  Each (B, S * k) tensor lists every
    example's routes token by token (token t's k routes at t k .. t k + k - 1,
    best expert first): ``gates`` (float32, renormalised over the k),
    ``experts``, ``rank`` (the number of earlier routes to the same expert in
    the example) and ``keep`` (rank < ``cap``, the per-example capacity)."""

    gates: torch.Tensor
    experts: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    cap: int


def moe_capacity(s: int, cfg) -> int:
    """Slots per expert for a call over ``s`` tokens: ceil(s k cf / E), at
    least 1.  The call's own length sets it, so a prefill may drop routes
    that a decode step (s = 1) never drops."""
    return max(1, math.ceil(s * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` on the last axis: ties go to the lower index
    (a stable descending sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_routes(x: torch.Tensor, p: Params, cfg) -> MoeRoutes:
    """Token-choice top-k routing with per-example capacity, as the JAX
    package's ``moe`` computes it: router logits in float32, softmax, top-k
    (ties to the lower expert), gates renormalised, and each route ranked
    among the example's earlier routes to its expert in token-major order."""
    b, s, _ = x.shape
    k = cfg.top_k
    logits = dot(x, p["router"]).to(_F32)                  # (B,S,E)
    gates, experts = _top_k(torch.softmax(logits, dim=-1), k)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    experts = experts.reshape(b, s * k)
    onehot = F.one_hot(experts, cfg.n_experts)             # (B, S*k, E)
    rank = torch.gather(torch.cumsum(onehot, dim=1) - onehot, 2, experts[..., None])[..., 0]
    cap = moe_capacity(s, cfg)
    return MoeRoutes(gates.reshape(b, s * k), experts, rank, rank < cap, cap)


def moe(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    """Token-choice top-k MoE with per-example capacity (sort-free,
    GShard-style): the JAX package's dense route, batched over the examples.

    Each example's kept routes fill an (E, cap, d) buffer in x's dtype (a
    dropped route adds 0 at the clamped slot ``cap - 1``, which may hold a
    kept token); the buffers of all examples form one (E, B cap, d) operand
    of one ``bmm`` per expert product (``router``, ``w_gate`` / ``w_up``
    (E, d, f), ``w_down`` (E, f, d)).  A route's contribution is its expert
    output times its gate (times 0 when dropped), formed in float32 and
    rounded to x's dtype; a token's k contributions are then added in x's
    dtype in route order, as JAX's scatter-add into x's dtype adds them.
    Dropped routes pass through the residual unchanged.

    ``cfg.moe_impl == "ep"`` (olmoe) routes the same way: JAX takes its
    expert-parallel ``_moe_ep`` only under an active mesh, and the port has
    none; that path waits for the multi-card slice (ROADMAP A7c)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    r = moe_routes(x, p, cfg)
    slot = r.rank.clamp(max=r.cap - 1)
    tok = torch.arange(s, device=x.device).repeat_interleave(k)
    row = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    src = torch.where(r.keep[..., None], x[:, tok], 0.0)  # (B, S*k, d)
    buf = x.new_zeros((e, b, r.cap, d))
    buf.index_put_((r.experts, row, slot), src, accumulate=True)
    xe = buf.view(e, b * r.cap, d)
    if cfg.mlp_type == "swiglu":
        h = silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    else:
        h = F.gelu(torch.bmm(xe, p["w_up"]), approximate="tanh")
    out = torch.bmm(h, p["w_down"]).view(e, b, r.cap, d)
    gathered = out[r.experts, row, slot]                   # (B, S*k, d)
    contrib = (gathered.to(_F32) * (r.gates * r.keep)[..., None]).to(x.dtype)
    contrib = contrib.view(b, s, k, d)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------

def mamba2_dims(cfg) -> tuple[int, int, int, int]:
    """(d_in, heads, state, head width) of a Mamba2 layer."""
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, cfg.ssm_state, cfg.ssm_head_dim


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d as K shifted multiply-adds in x's dtype, as
    JAX computes it.  x (B,S,C), w (K,C), b (C)."""
    k = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + xp[:, j: j + s] * w[j]
    return out + b


def _ssd_project(x: torch.Tensor, p: Params, cfg):
    """(z, xbc, dt) from one ``in_proj`` product: widths d_in, d_in + 2 state,
    heads."""
    d_in, nh, ds, _ = mamba2_dims(cfg)
    return dot(x, p["in_proj"]).split([d_in, d_in + 2 * ds, nh], dim=-1)


def mamba2_scan(x: torch.Tensor, p: Params, cfg, *, chunk: int = 128,
                return_state: bool = False):
    """Chunk-parallel SSD forward.  x (B,S,d) -> y (B,S,d); with
    ``return_state`` also (the final state (B, heads, head width, state) in
    float32, the conv state: the last K - 1 positions of the raw,
    pre-activation ``xbc`` stream).

    Intra-chunk a masked quadratic form, inter-chunk a loop over the chunks
    carrying the state.  A sequence shorter than ``chunk`` or not a multiple
    of it runs as one chunk (JAX's rule; nothing is padded)."""
    b, s, _ = x.shape
    d_in, nh, ds, hd = mamba2_dims(cfg)
    z, xbc_raw, dt = _ssd_project(x, p, cfg)
    xbc = silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xs, bmat, cmat = xbc.split([d_in, ds, ds], dim=-1)
    dt = F.softplus(dt.to(_F32) + p["dt_bias"])             # (B,S,nh)
    la = dt * -torch.exp(p["a_log"].to(_F32))               # log-decay < 0

    if s < chunk or s % chunk != 0:
        chunk = s
    xh = xs.reshape(b, s, nh, hd).to(_F32)
    bc, cc = bmat.to(_F32), cmat.to(_F32)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((b, nh, hd, ds), dtype=_F32, device=x.device)
    ys = []
    for start in range(0, s, chunk):
        c = slice(start, start + chunk)
        xq, bq, cq, dtq = xh[:, c], bc[:, c], cc[:, c], dt[:, c]
        cum = torch.cumsum(la[:, c], dim=1)                 # (B,Q,nh) inclusive
        # intra-chunk
        cb = torch.matmul(cq, bq.transpose(1, 2))          # (B,Q,Q)
        seg = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
        seg = torch.where(tri[None, :, :, None], seg, 0.0)
        w = cb[..., None] * seg * dtq[:, None, :, :]        # (B,Q,S,nh)
        y = torch.einsum("bqsh,bshp->bqhp", w, xq)
        # inter-chunk contribution of the carried state
        y = y + torch.einsum("bqd,bhpd->bqhp", cq, h) * torch.exp(cum)[..., None]
        rev = torch.exp(cum[:, -1:, :] - cum)               # decay s+1..end
        h = torch.exp(cum[:, -1])[:, :, None, None] * h + torch.einsum(
            "bshp,bsd->bhpd", xq * (rev * dtq)[..., None], bq)
        ys.append(y)
    y = torch.cat(ys, dim=1)                                # (B,S,nh,hd)
    y = y + p["d_skip"].to(_F32)[None, None, :, None] * xh
    y = y.reshape(b, s, d_in).to(x.dtype)
    y = rms_norm(y * silu(z), p["norm"])
    out = dot(y, p["out_proj"])
    if return_state:
        return out, (h, xbc_raw[:, -(cfg.ssm_conv - 1):])
    return out


def mamba2_decode(x_t: torch.Tensor, p: Params, cfg, h: torch.Tensor,
                  conv_state: torch.Tensor):
    """One-token SSD step.  x_t (B,1,d); h (B,heads,head width,state);
    conv_state (B,K-1,C).  Returns (y, h, conv_state), new tensors.  The
    convolution runs in float32 here (the scan's runs in x's dtype), as in
    JAX."""
    b = x_t.shape[0]
    d_in, nh, ds, hd = mamba2_dims(cfg)
    z, xbc, dt = _ssd_project(x_t, p, cfg)                  # (B,1,*)
    window = torch.cat([conv_state, xbc], dim=1)            # (B,K,C)
    conv_out = (window.to(_F32) * p["conv_w"].to(_F32)).sum(dim=1) + p["conv_b"]
    xbc_t = silu(conv_out)[:, None, :].to(x_t.dtype)
    xs, bmat, cmat = xbc_t.split([d_in, ds, ds], dim=-1)
    dtv = F.softplus(dt[:, 0].to(_F32) + p["dt_bias"])     # (B,nh)
    decay = torch.exp(dtv * -torch.exp(p["a_log"].to(_F32)))
    xh = xs[:, 0].reshape(b, nh, hd).to(_F32)
    bv, cv = bmat[:, 0].to(_F32), cmat[:, 0].to(_F32)       # (B,ds)
    h = decay[:, :, None, None] * h + (dtv[:, :, None] * xh)[..., None] * bv[:, None, None, :]
    y = torch.einsum("bd,bhpd->bhp", cv, h)
    y = y + p["d_skip"].to(_F32)[None, :, None] * xh
    y = y.reshape(b, 1, d_in).to(x_t.dtype)
    y = rms_norm(y * silu(z), p["norm"])
    return dot(y, p["out_proj"]), h, window[:, 1:]


# ---------------------------------------------------------------------------
# xLSTM cells
# ---------------------------------------------------------------------------

def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-x)


def mlstm_chunked(q, k, v, i_pre, f_pre, *, chunk: int = 128, initial=None,
                  return_state: bool = False):
    """Stabilised chunkwise mLSTM.  q, k, v (B,S,H,D); i_pre, f_pre (B,S,H).

    C_t = f_t C + i_t k v^T ; n_t = f_t n + i_t k ;
    h_t = (q·C) / max(|q·n|, exp(-m)) with a running stabiliser m, which
    starts at -inf (``initial=None``) and is kept above -1e30, so that an
    all -inf row gives exp(-inf) = 0 and never NaN.  ``chunk`` must divide
    S.  Returns h (B,S,H,D) float32, and with ``return_state`` the final
    (C (B,H,D,D), n (B,H,D), m (B,H))."""
    b, s, h, d = q.shape
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence ({s})")
    log_f = _log_sigmoid(f_pre.to(_F32))
    log_i = i_pre.to(_F32)
    qf = q.to(_F32) * d ** -0.5
    kf, vf = k.to(_F32), v.to(_F32)
    if initial is None:
        cmat = torch.zeros((b, h, d, d), dtype=_F32, device=q.device)
        nvec = torch.zeros((b, h, d), dtype=_F32, device=q.device)
        m = torch.full((b, h), -math.inf, dtype=_F32, device=q.device)
    else:
        cmat, nvec, m = initial
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    outs = []
    for start in range(0, s, chunk):
        c = slice(start, start + chunk)
        qq, kk, vv, li = qf[:, c], kf[:, c], vf[:, c], log_i[:, c]
        cum = torch.cumsum(log_f[:, c], dim=1)              # inclusive (B,Q,H)
        logd = cum[:, :, None, :] - cum[:, None, :, :] + li[:, None, :, :]
        logd = torch.where(tri[None, :, :, None], logd, -math.inf)
        m_inter = cum + m[:, None, :]                       # carry decayed to t
        m_new = torch.maximum(logd.amax(dim=2), m_inter).clamp_min(_NEG)
        w = torch.exp(logd - m_new[:, :, None, :])          # (B,Q,S,H)
        sw = torch.einsum("bqhd,bshd->bqsh", qq, kk) * w
        num = torch.einsum("bqsh,bshd->bqhd", sw, vv)
        den = sw.sum(dim=2)
        inter_scale = torch.exp(m_inter - m_new)            # (B,Q,H)
        num = num + torch.einsum("bqhd,bhde->bqhe", qq, cmat) * inter_scale[..., None]
        den = den + torch.einsum("bqhd,bhd->bqh", qq, nvec) * inter_scale
        outs.append(num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None])
        # chunk-end state
        tot = cum[:, -1]                                    # (B,H)
        tail = cum[:, -1:, :] - cum + li
        m_out = torch.maximum(tot + m, tail.amax(dim=1))
        decay_in = torch.exp(tot + m - m_out)
        wk = torch.exp(tail - m_out[:, None, :])            # (B,Q,H)
        cmat = decay_in[:, :, None, None] * cmat + torch.einsum(
            "bqhd,bqhe->bhde", kk * wk[..., None], vv)
        nvec = decay_in[:, :, None] * nvec + torch.einsum("bqh,bqhd->bhd", wk, kk)
        m = m_out
    out = torch.cat(outs, dim=1)
    if return_state:
        return out, (cmat, nvec, m)
    return out


def mlstm_decode(q, k, v, i_pre, f_pre, state):
    """One mLSTM step.  q, k, v (B,H,D); i_pre, f_pre (B,H); state (C, n, m)
    as :func:`mlstm_chunked` returns it.  Returns (h (B,H,D), state)."""
    c, n, m = state
    d = q.shape[-1]
    qf = q.to(_F32) * d ** -0.5
    log_f = _log_sigmoid(f_pre.to(_F32))
    log_i = i_pre.to(_F32)
    m_new = torch.maximum(log_f + m, log_i)
    f_s = torch.exp(log_f + m - m_new)
    i_s = torch.exp(log_i - m_new)
    kf, vf = k.to(_F32), v.to(_F32)
    c = f_s[..., None, None] * c + i_s[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n = f_s[..., None] * n + i_s[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, c)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(), torch.exp(-m_new))
    return num / den[..., None], (c, n, m_new)


def slstm_scan(x_gates: torch.Tensor, r: torch.Tensor, *, initial=None,
               return_state: bool = False):
    """sLSTM over time.  x_gates (B,S,H,4,D): the input pre-activations of
    (z, i, f, o); r (H,4,D,D): recurrent weights applied to h_{t-1}.  A time
    loop of S steps, each a handful of small launches (JAX scans it the same
    way; the package has no kernel for it).  Returns h (B,S,H,D) float32 and,
    with ``return_state``, (h, c, n, m) of the last step."""
    b, s, h, _, d = x_gates.shape
    if initial is None:
        hid, c, n, m = (torch.zeros((b, h, d), dtype=_F32, device=x_gates.device)
                        for _ in range(4))
    else:
        hid, c, n, m = initial
    # rec[b, h, g, e] = sum_d hid[b, h, d] r[h, g, d, e], one bmm over the heads
    rf = r.to(_F32).permute(0, 2, 1, 3).reshape(h, d, 4 * d)
    gates = x_gates.to(_F32)
    outs = []
    for t in range(s):
        rec = torch.bmm(hid.transpose(0, 1), rf).view(h, b, 4, d).transpose(0, 1)
        pre = gates[:, t] + rec
        z = torch.tanh(pre[:, :, 0])
        i_t = pre[:, :, 1]
        o = torch.sigmoid(pre[:, :, 3])
        log_f = _log_sigmoid(pre[:, :, 2])
        m_new = torch.maximum(log_f + m, i_t)
        i_s = torch.exp(i_t - m_new)
        f_s = torch.exp(log_f + m - m_new)
        c = f_s * c + i_s * z
        n = f_s * n + i_s
        hid = o * c / n.clamp_min(1e-6)
        m = m_new
        outs.append(hid)
    out = torch.stack(outs, dim=1)                          # (B,S,H,D)
    if return_state:
        return out, (hid, c, n, m)
    return out


__all__ = ["MoeRoutes", "attention_decode", "attention_train", "dot", "mamba2_decode",
           "mamba2_dims", "mamba2_scan", "mlp", "mlstm_chunked", "mlstm_decode", "moe",
           "moe_capacity", "moe_routes", "rms_norm", "rope", "silu", "slstm_scan"]
