"""Whisper-style encoder-decoder (``repro/models/encdec.py``).  The conv /
audio frontend is a stub, as in the JAX package: ``batch["frames"]`` (B, T,
d) holds precomputed frame embeddings (``models.api.input_specs``).

The encoder is bidirectional and rotary: each of its ``encoder_layers``
blocks runs :func:`layers.attention_train` with ``causal=False`` and no
``kv_x``, so RoPE applies to q and k and no mask does.  Each decoder layer
is a causal rotary self-attention, a cross-attention over the encoder's
output (``kv_x``: no RoPE on either side, no mask) and the MLP.

Parameters live in an :class:`EncDecLM` module under JAX's names:
``embed`` (V, d), ``enc_blocks`` and ``blocks`` (stacked attention + MLP
blocks, :func:`lm.dense_block_params`), ``cross_blocks`` (``ln``, ``wq``,
``wk``, ``wv``, ``wo`` stacked over the decoder's layers: no ``ln2``, no
MLP), ``ln_enc``, ``ln_f`` and ``lm_head`` (never tied).

The cache is JAX's dict ``{"k", "v": (L, B, Hkv, S, Dh), "ck", "cv": (L, B,
Hkv, T, Dh), "pos"}``.  ``ck`` / ``cv`` hold the raw projections of the
encoder's output (no ``_qk_normalize``), in the model's dtype, as JAX
caches them; :func:`prefill` writes every tensor of it in place and
:func:`decode_step` writes the new token's self key and value at ``pos``,
attends every frame across (``pos`` = ``frontend_tokens``) and leaves
``ck`` / ``cv`` as they are.  A flash prefill launches B6
``encoder_layers + 2 n_layers`` times; decode launches it never.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import layers as L
from .sharding import is_dtensor, serving, shard, write_at
from .lm import (ParamDraws, ParamTree, _embed, _logits, dense_block_params, frozen,
                 sharded_cache,
                 next_token_loss, stacked_layers)

_STACKS = ("enc_blocks", "blocks", "cross_blocks")


class EncDecLM(ParamTree):
    """The parameters of an encoder-decoder, under the JAX names."""

    def __init__(self, tree: dict):
        super().__init__()
        self.embed = frozen(tree["embed"])
        for name in _STACKS:
            setattr(self, name, nn.ParameterDict({k: frozen(v) for k, v in tree[name].items()}))
        for name in ("ln_enc", "ln_f", "lm_head"):
            setattr(self, name, frozen(tree[name]))

    def stack(self, name: str) -> list[dict[str, torch.Tensor]]:
        """Every layer's tensors of the stack ``name`` (``enc_blocks``,
        ``blocks`` or ``cross_blocks``; :func:`lm.stacked_layers`)."""
        return stacked_layers(dict(self[name].items()))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg, device=None) -> EncDecLM:
    """Random parameters from the JAX package's distributions: the embedding,
    the head and the cross-attention projections N(0, 0.02^2), the two
    block stacks as :func:`lm.dense_block_params` (output projections scaled
    by 0.02 / sqrt(2 ``n_layers``) in the encoder too), norms at 1."""
    draw = ParamDraws(generator, cfg, device)
    normal, ones = draw.normal, draw.ones
    d, v, n = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    embed = normal(v, d)
    enc_blocks = dense_block_params(draw, cfg, cfg.encoder_layers)
    blocks = dense_block_params(draw, cfg, n)
    cross = {"ln": ones(n, d), "wq": normal(n, d, hq * hd), "wk": normal(n, d, hkv * hd),
             "wv": normal(n, d, hkv * hd), "wo": normal(n, hq * hd, d)}
    return EncDecLM({"embed": embed, "enc_blocks": enc_blocks, "blocks": blocks,
                     "cross_blocks": cross, "ln_enc": ones(d), "ln_f": ones(d),
                     "lm_head": normal(d, v)})


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _maybe_remat(fn, cfg):
    """``fn`` under ``checkpoint`` when ``cfg.remat`` asks for it and a
    gradient is being recorded (JAX checkpoints the scan body); remat
    changes memory, not values."""
    if cfg.remat and torch.is_grad_enabled():
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    return fn


def _enc_block(x, bp, cfg, positions):
    h = L.attention_train(L.rms_norm(x, bp["ln1"]), bp, cfg, positions=positions,
                          causal=False)
    x = x + h
    return shard(x + L.mlp(L.rms_norm(x, bp["ln2"]), bp, cfg), "dp", None, None)


def encode(params: EncDecLM, frames: torch.Tensor, cfg) -> torch.Tensor:
    """The bidirectional encoder over stub frame embeddings (B, T, d), in
    the frames' dtype (callers cast them to ``cfg.dtype``, as JAX does)."""
    positions = torch.arange(frames.shape[1], device=frames.device)
    block = _maybe_remat(lambda h, bp: _enc_block(h, bp, cfg, positions), cfg)
    x = shard(frames, "dp", None, None)
    for bp in params.stack("enc_blocks"):
        x = block(x, bp)
    return L.rms_norm(x, params["ln_enc"])


def _frames(batch, cfg) -> torch.Tensor:
    return batch["frames"].to(getattr(torch, cfg.dtype))


def _dec_block(x, bp, cp, enc_out, cfg, positions):
    x = x + L.attention_train(L.rms_norm(x, bp["ln1"]), bp, cfg, positions=positions)
    x = x + L.attention_train(L.rms_norm(x, cp["ln"]), cp, cfg, positions=positions,
                              kv_x=enc_out)
    return shard(x + L.mlp(L.rms_norm(x, bp["ln2"]), bp, cfg), "dp", None, None)


def _decoder(params: EncDecLM, tokens: torch.Tensor, enc_out: torch.Tensor, cfg):
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    block = _maybe_remat(lambda h, bp, cp: _dec_block(h, bp, cp, enc_out, cfg, positions), cfg)
    for bp, cp in zip(params.stack("blocks"), params.stack("cross_blocks")):
        x = block(x, bp, cp)
    return L.rms_norm(x, params["ln_f"])


def train_loss(params: EncDecLM, batch, cfg) -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder over ``batch["tokens"]``,
    given ``batch["frames"]``."""
    enc_out = encode(params, _frames(batch, cfg), cfg)
    x = _decoder(params, batch["tokens"], enc_out, cfg)
    return next_token_loss(_logits(params, x, cfg), batch["tokens"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, max_len: int, dtype=None, device=None) -> dict:
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    hkv, hd, n = cfg.n_kv_heads, cfg.head_dim_, cfg.n_layers
    zeros = lambda s: torch.zeros((n, batch_size, hkv, s, hd), dtype=dtype, device=dev)
    return {"k": zeros(max_len), "v": zeros(max_len),
            "ck": zeros(cfg.frontend_tokens), "cv": zeros(cfg.frontend_tokens),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


@serving
def prefill(params: EncDecLM, batch, cfg, *, max_len: int | None = None):
    """Encode the frames, cache the cross keys and values, prefill the
    decoder's self-attention cache; return (last-position float32 logits
    (B, V), the cache with ``max_len`` self slots and ``pos`` = prompt
    length)."""
    enc_out = encode(params, _frames(batch, cfg), cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt ({s})")
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len, dtype=x.dtype, device=x.device)
    sharded = is_dtensor(enc_out)
    if sharded:
        cache = sharded_cache(cfg, cache)
    for i, (bp, cp) in enumerate(zip(params.stack("blocks"), params.stack("cross_blocks"))):
        att, (k, v) = L.attention_train(L.rms_norm(x, bp["ln1"]), bp, cfg,
                                        positions=positions, return_kv=True)
        ck = L._split_heads(L.dot(enc_out, cp["wk"]), hkv, hd).transpose(1, 2)
        cv = L._split_heads(L.dot(enc_out, cp["wv"]), hkv, hd).transpose(1, 2)
        if sharded:
            for name, t in (("k", k), ("v", v), ("ck", ck), ("cv", cv)):
                write_at(cache[name][i], 2, 0, t)
        else:
            cache["k"][i, :, :, :s] = k
            cache["v"][i, :, :, :s] = v
            cache["ck"][i] = ck
            cache["cv"][i] = cv
        x = x + att
        x = x + L.attention_train(L.rms_norm(x, cp["ln"]), cp, cfg, positions=positions,
                                  kv_x=enc_out)
        x = shard(x + L.mlp(L.rms_norm(x, bp["ln2"]), bp, cfg), "dp", None, None)
    x = L.rms_norm(x[:, -1:], params["ln_f"])
    logits = _logits(params, x, cfg)[:, 0]
    cache["pos"].fill_(s)
    return logits, cache


@serving
def decode_step(params: EncDecLM, batch, cache: dict, cfg):
    """One-token decode.  batch = {"next_token": (B,)}; ``cache`` from
    :func:`prefill`, its self keys and values written in place and ``pos``
    advanced by one; the cross cache is read, never written."""
    x = _embed(params, batch["next_token"][:, None], cfg)
    pos = cache["pos"]
    for i, (bp, cp) in enumerate(zip(params.stack("blocks"), params.stack("cross_blocks"))):
        att, _, _ = L.attention_decode(L.rms_norm(x, bp["ln1"]), bp, cfg,
                                       cache["k"][i], cache["v"][i], pos)
        x = x + att
        catt, _, _ = L.attention_decode(L.rms_norm(x, cp["ln"]), cp, cfg,
                                        cache["ck"][i], cache["cv"][i], cfg.frontend_tokens,
                                        cross=True)
        x = x + catt
        x = x + L.mlp(L.rms_norm(x, bp["ln2"]), bp, cfg)
    x = L.rms_norm(x, params["ln_f"])
    logits = _logits(params, x, cfg)[:, 0]
    cache["pos"] = pos + 1
    return logits, cache


__all__ = ["EncDecLM", "decode_step", "encode", "init_cache", "init_params", "prefill",
           "train_loss"]
