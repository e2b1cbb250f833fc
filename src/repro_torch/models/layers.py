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

Under an active mesh (:func:`repro_torch.models.sharding.use_mesh`, the
tensors DTensors), the same functions run sharded, as JAX's do under
``pjit``: :func:`attention_train` pins q's heads (or, when ``n_heads`` is
not a multiple of 16, its query sequence) over ``tp`` with JAX's two
``shard()`` constraints, and runs attention (B6 or a plain version) on
each rank's local tensors
(:func:`_attention_sharded`); ``decode_attn="sharded_lse"`` decodes over a
sequence-sharded cache (:func:`_sharded_lse_decode`), and
``moe_impl="ep"`` routes each rank's own experts (:func:`_moe_ep`).
``native_out`` (bf16 partial sums under tensor parallelism) has no effect:
the port's row-parallel partial sums are added in the output's dtype by
DTensor's all-reduce either way.

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

from . import sharding
from .sharding import is_dtensor, shard

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

def _whole(x: torch.Tensor, dim: int, outer: int) -> torch.Tensor:
    """Before splitting axis ``dim`` into (``outer``, rest): a DTensor split
    over that axis more ways than ``outer`` divides is gathered on it
    (DTensor unflattens an axis only along whole outer blocks).  Anything
    else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh, dim = x.device_mesh, dim % x.ndim
    places = [Replicate() if isinstance(pl, Shard) and pl.dim % x.ndim == dim
              and outer % mesh.size(i) else pl for i, pl in enumerate(x.placements)]
    return x if places == list(x.placements) else x.redistribute(mesh, places)


def _batch_only(x: torch.Tensor) -> torch.Tensor:
    """A DTensor laid out over its batch axis (0) alone: every other split
    or partial sum gathered."""
    from torch.distributed.tensor import Replicate, Shard

    places = [pl if isinstance(pl, Shard) and pl.dim % x.ndim == 0 else Replicate()
              for pl in x.placements]
    return sharding.redistribute(x, x.device_mesh, places)


def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    return _whole(x, -1, n).reshape(x.shape[:-1] + (n, d))


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
    # attention activation sharding: heads over tp when divisible, otherwise
    # context-parallel (query-sequence over tp) — DESIGN §5.
    if hq % 16 == 0:
        q = shard(q.transpose(1, 2), "dp", "tp", None, None)   # (B, Hq, S, Dh)
    else:
        q = shard(q.transpose(1, 2), "dp", None, "tp", None)
    k = k.transpose(1, 2)                                # (B, Hkv, Sk, Dh)
    v = v.transpose(1, 2)

    is_causal = causal and kv_x is None
    attend = {"flash": flash_attention, "blockwise": _blockwise_attention}.get(
        getattr(cfg, "attn_impl", "ref"), _dense_attention)
    if is_dtensor(q):
        o = _attention_sharded(attend, q, k, v, causal=is_causal, window=cfg.window)
    else:
        o = attend(q, k, v, causal=is_causal, window=cfg.window)
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    y = dot(o, p["wo"], native_out=getattr(cfg, "bf16_reduce", False))
    if return_kv:
        return y, (k, v)
    return y


def _attention_sharded(attend, q, k, v, *, causal: bool, window: int | None):
    """Attention under a mesh: each rank runs ``attend`` (B6, whose
    ``ctypes`` launch takes no DTensor, or a plain version) on local
    tensors, ``shard_map``'s body.

    Heads over ``tp`` (q's placement ``Shard(1)``): each rank runs its own
    q heads against the KV heads they read -- k and v split over ``tp``
    with q when the KV heads divide, else gathered and each q head given
    its own copy of its KV head (their gradients then partial sums over
    ``tp``).  Query sequence over ``tp``: B6 has no query-offset argument,
    so q is gathered and every rank runs the whole sequence, as XLA's
    partitioner must for an opaque custom call.  The output keeps q's
    placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    tp_dim = (mesh.mesh_dim_names.index("model")
              if "model" in mesh.mesh_dim_names else None)
    heads = tp_dim is not None and q.placements[tp_dim] == Shard(1)
    places = list(q.placements)
    for i, p in enumerate(places):
        if isinstance(p, Shard) and p.dim != 0 and not (heads and i == tp_dim):
            places[i] = Replicate()
    q = sharding.redistribute(q, mesh, places)
    hq, hkv = q.shape[1], k.shape[1]
    tp = mesh.size(tp_dim) if heads else 1
    if heads and hkv % tp == 0:
        k, v = (sharding.redistribute(t, mesh, places).to_local() for t in (k, v))
    else:
        kv_places = [Replicate() if i == tp_dim else p for i, p in enumerate(places)]
        grads = [Partial() if heads and i == tp_dim else p for i, p in enumerate(kv_places)]
        k, v = (sharding.redistribute(t, mesh, kv_places).to_local(grad_placements=grads)
                for t in (k, v))
        if heads:                         # each local q head's own KV head
            lo = sharding.axis_index(mesh, "model") * (hq // tp)
            idx = torch.arange(lo, lo + hq // tp, device=k.device) // (hq // hkv)
            k, v = k.index_select(1, idx), v.index_select(1, idx)
    o = attend(q.to_local(), k, v, causal=causal, window=window)
    return DTensor.from_local(o, mesh, places, run_check=False)


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
    other value raises.  ``sharded_lse`` takes :func:`_sharded_lse_decode`
    under an active mesh, and the local path otherwise, as in JAX.  Under a
    mesh the local path runs on DTensors; a sharded cache takes the new
    token on the rank that owns its position
    (:func:`~repro_torch.models.sharding.write_at`)."""
    if getattr(cfg, "decode_attn", "auto") not in DECODE_ATTN:
        raise ValueError(f"decode_attn {cfg.decode_attn!r} is not one of {DECODE_ATTN}")
    b = x_t.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = _split_heads(dot(x_t, p["wq"]), hq, hd)          # (B,1,Hq,Dh)
    g = hq // hkv
    sharded = (getattr(cfg, "decode_attn", "auto") == "sharded_lse" and not cross
               and sharding.active_mesh() is not None)   # needs an active mesh
    if not cross:
        k_new = _split_heads(dot(x_t, p["wk"]), hkv, hd)
        v_new = _split_heads(dot(x_t, p["wv"]), hkv, hd)
        q, k_new = _qk_normalize(q, k_new, p, cfg)
        q = rope(q, pos[None], cfg.rope_theta)
        k_new = rope(k_new, pos[None], cfg.rope_theta)
        if sharded:
            qg = _whole(q[:, 0], 1, hkv).reshape(b, hkv, g, hd)
            o, cache_k, cache_v = _sharded_lse_decode(
                qg, k_new.transpose(1, 2).to(cache_k.dtype),
                v_new.transpose(1, 2).to(cache_v.dtype), cache_k, cache_v, pos, cfg)
            o = o.reshape(b, 1, hq * hd).to(x_t.dtype)
            return dot(o, p["wo"]), cache_k, cache_v
        if is_dtensor(cache_k):
            sharding.write_at(cache_k, 2, pos, k_new.transpose(1, 2).to(cache_k.dtype))
            sharding.write_at(cache_v, 2, pos, v_new.transpose(1, 2).to(cache_v.dtype))
        else:
            at = pos.reshape(1).to(torch.int64)
            cache_k.index_copy_(2, at, k_new.transpose(1, 2).to(cache_k.dtype))
            cache_v.index_copy_(2, at, v_new.transpose(1, 2).to(cache_v.dtype))
        valid_len = pos + 1
    else:
        if cfg.qk_norm:
            q, _ = _qk_normalize(q, q, p, cfg)
        valid_len = pos

    qg = _whole(q[:, 0], 1, hkv).reshape(b, hkv, g, hd)
    if is_dtensor(cache_k):
        # the query whole on every rank of its batch slice: the products
        # with a sequence-sharded cache come out split over the sequence
        qg = _batch_only(qg)
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


def _sharded_lse_decode(qg, k_new, v_new, cache_k, cache_v, pos, cfg):
    """Flash-decoding over a sequence-sharded KV cache (§Perf C).

    Each ``tp`` rank holds a contiguous sequence slice of the cache.  The
    owning rank performs a 1-token read-modify-write (never a full-shard
    masked rewrite), every rank computes partial attention over its slice,
    and the ranks merge with a log-sum-exp correction: one MAX and two SUM
    all-reduces over ``tp`` (JAX's pmax / psum).

    qg (B,Hkv,G,Dh), k_new / v_new (B,Hkv,1,Dh) replicated over tp; caches
    (B,Hkv,S,Dh) laid out P(dp,·,tp,·), written in place.  Returns (o
    (B,Hkv,G,Dh) float32 replicated over tp, cache_k, cache_v).  Raises with
    no mesh active (the caller takes the local path then).
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = sharding.active_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        raise RuntimeError("decode_attn=sharded_lse requires an active mesh")
    hd = qg.shape[-1]
    scale = hd ** -0.5
    window = cfg.window
    tp_dim = mesh.mesh_dim_names.index("model")
    for name, c in (("cache_k", cache_k), ("cache_v", cache_v)):
        if (not is_dtensor(c) or c.placements[tp_dim] != Shard(2)
                or any(isinstance(pl, Shard) and pl.dim != 0 and i != tp_dim
                       for i, pl in enumerate(c.placements))):
            raise ValueError(f"sharded_lse: {name} must be a DTensor laid out "
                             "P(dp, ., tp, .)")
    # q and the new token: the cache's batch layout, replicated over tp
    rep4 = tuple(Replicate() if i == tp_dim else pl for i, pl in enumerate(cache_k.placements))
    qg_l, kn_l, vn_l = (sharding.local(sharding.redistribute(t, mesh, rep4))
                        for t in (qg, k_new, v_new))
    ck_l, cv_l = cache_k.to_local(), cache_v.to_local()
    pos = sharding.local(pos)                       # replicated: every rank's is whole
    tp_i = sharding.axis_index(mesh, "model")
    s_loc = ck_l.shape[2]
    start = tp_i * s_loc
    rel = pos.to(torch.int64) - start
    in_range = (rel >= 0) & (rel < s_loc)
    relc = rel.clamp(0, s_loc - 1).reshape(1)
    # 1-token read-modify-write on the local slice
    for c_l, n_l in ((ck_l, kn_l), (cv_l, vn_l)):
        old = c_l.index_select(2, relc)
        c_l.index_copy_(2, relc, torch.where(in_range, n_l.to(c_l.dtype), old))
    # partial attention over the local slice
    s = torch.matmul(qg_l.to(ck_l.dtype).to(_F32),
                     ck_l.to(_F32).transpose(-1, -2)) * scale       # (B,Hkv,G,S_loc)
    k_pos = start + torch.arange(s_loc, device=ck_l.device)
    mask = k_pos <= pos
    if window is not None:
        mask &= k_pos > pos - window
    s = torch.where(mask, s, _NEG)
    m_loc = s.amax(dim=-1)                                           # (B,Hkv,G)
    p_ = torch.where(mask, torch.exp(s - m_loc[..., None]), 0.0)
    l_loc = p_.sum(dim=-1)
    o_loc = torch.matmul(p_.to(cv_l.dtype).to(_F32), cv_l.to(_F32))
    m_g = sharding.all_reduce(m_loc.clone(), "max", mesh, "model")
    corr = torch.exp(m_loc - m_g)
    l_g = sharding.all_reduce(l_loc * corr, "sum", mesh, "model")
    o = sharding.all_reduce(o_loc * corr[..., None], "sum", mesh, "model")
    o = o / torch.clamp(l_g, min=1e-30)[..., None]
    return DTensor.from_local(o, mesh, rep4, run_check=False), cache_k, cache_v


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

    ``cfg.moe_impl == "ep"`` (requires E % tp == 0 and an active mesh with
    a ``"model"`` axis): expert-parallel (:func:`_moe_ep`).  Otherwise, as
    in JAX, the dense route (under a mesh on DTensors)."""
    mesh = sharding.active_mesh()
    if (getattr(cfg, "moe_impl", "dense") == "ep" and mesh is not None
            and "model" in mesh.mesh_dim_names
            and cfg.n_experts % sharding.mesh_size(mesh, "model") == 0):
        return _moe_ep(x, p, cfg, mesh)
    r = moe_routes(x, p, cfg)
    return _moe_dispatch(x, r, r.keep, r.experts, cfg.n_experts,
                         p.get("w_gate"), p["w_up"], p["w_down"], cfg)


def _moe_dispatch(x, r: MoeRoutes, keep, experts, e: int, w_gate, w_up, w_down, cfg):
    """The expert products of :func:`moe` over ``e`` experts: the kept
    routes (``keep``) to ``experts`` (indices into the ``e`` experts of
    ``w_gate`` / ``w_up`` / ``w_down``) fill the (E, B cap, d) buffer, and
    each token gets its k contributions added in x's dtype."""
    b, s, d = x.shape
    k = cfg.top_k
    slot = r.rank.clamp(max=r.cap - 1)
    tok = torch.arange(s, device=x.device).repeat_interleave(k)
    row = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    src = torch.where(keep[..., None], x[:, tok], 0.0)    # (B, S*k, d)
    buf = x.new_zeros((e, b, r.cap, d))
    buf.index_put_((experts, row, slot), src, accumulate=True)
    xe = buf.view(e, b * r.cap, d)
    if cfg.mlp_type == "swiglu":
        h = silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    else:
        h = F.gelu(torch.bmm(xe, w_up), approximate="tanh")
    out = torch.bmm(h, w_down).view(e, b, r.cap, d)
    gathered = out[experts, row, slot]                     # (B, S*k, d)
    contrib = (gathered.to(_F32) * (r.gates * keep)[..., None]).to(x.dtype)
    contrib = contrib.view(b, s, k, d)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y


def _moe_ep(x: torch.Tensor, p: Params, cfg, mesh) -> torch.Tensor:
    """Expert-parallel MoE over the tp axis (see :func:`moe`).

    Each tp rank owns E/tp experts outright (``param_shardings``' ep
    layout; gathered to it otherwise), routes the tokens of its local batch
    slice with the full router, keeps its own experts' routes -- a route's
    rank among its expert's routes is the same as on the dense route -- and
    the ranks' partial outputs are added with one SUM all-reduce over tp.
    x (B,S,d) is laid out P(dp,·,·); so is the output."""
    from torch.distributed.tensor import DTensor

    e = cfg.n_experts
    ep = sharding.mesh_size(mesh, "model")
    e_loc = e // ep
    lo = sharding.axis_index(mesh, "model") * e_loc
    dp = sharding.resolve(("dp",))[0]
    x_l = sharding.local(sharding.shard(x, dp, None, None))
    router = sharding.full(p["router"])
    w = [None if p.get(n) is None else
         sharding.local(sharding.shard(p[n], "tp", None, None))
         for n in ("w_gate", "w_up", "w_down")]
    r = moe_routes(x_l, {"router": router}, cfg)
    mine = (r.experts >= lo) & (r.experts < lo + e_loc)
    loc_e = (r.experts - lo).clamp(0, e_loc - 1)
    y = _moe_dispatch(x_l, r, r.keep & mine, loc_e, e_loc, *w, cfg)
    y = sharding.all_reduce(y, "sum", mesh, "model")   # combine shards' expert outputs
    out = DTensor.from_local(y, mesh, sharding.placements(mesh, (dp, None, None)),
                             run_check=False)
    return out if is_dtensor(x) else out.full_tensor()


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
