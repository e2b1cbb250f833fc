"""Zamba2-style hybrid (``repro/models/hybrid.py``): a Mamba2 backbone and
one attention + MLP block whose weights are SHARED by all its applications.

The layer schedule is JAX's: ``G = L // attn_every`` full groups of
[shared block -> ``attn_every`` Mamba2 layers], then, when ``L %
attn_every`` is not 0, a tail group of [shared block -> the remaining
layers].  Each application has its KV-cache slot: ``n_attn_apps(cfg)``
slots (14 for zamba2-7b's 81 layers: 13 full groups and a tail of 3), so a
flash prefill launches B6 ``n_attn_apps(cfg)`` times, not ``n_layers``.

Parameters live in a :class:`HybridLM` module under JAX's names: ``embed``
(V, d), ``mamba`` (each tensor stacked over the L Mamba2 layers), ``shared``
(the attention + MLP block, unstacked), ``ln_f`` and ``lm_head``.  The JAX
package scans over the groups; the port loops.  The cache is JAX's dict
``{"ssm": (L, B, heads, head width, state) float32, "conv": (L, B, K - 1,
C), "k" / "v": (apps, B, Hkv, S, Dh), "pos"}``, written in place by
:func:`prefill` and :func:`decode_step` (as ``models.lm`` writes its KV
cache); ``conv`` holds the raw, pre-activation tail of each layer's ``xbc``
stream in ``cfg.dtype``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import layers as L
from .sharding import is_dtensor, serving, shard, write_at
from .lm import (ParamDraws, ParamTree, _embed, _logits, frozen, next_token_loss, sharded_cache,
                 stacked_layers)


class HybridLM(ParamTree):
    """The parameters of a Mamba2 + shared-attention hybrid, under the JAX
    names; :meth:`layer` gives Mamba2 layer ``i``'s tensors."""

    def __init__(self, tree: dict):
        super().__init__()
        self.embed = frozen(tree["embed"])
        self.mamba = nn.ParameterDict({k: frozen(v) for k, v in tree["mamba"].items()})
        self.shared = nn.ParameterDict({k: frozen(v) for k, v in tree["shared"].items()})
        self.ln_f = frozen(tree["ln_f"])
        self.lm_head = frozen(tree["lm_head"])

    def layer(self, i: int) -> dict[str, torch.Tensor]:
        """Mamba2 layer ``i``'s tensors (views of the stacked ones)."""
        return {name: t[i] for name, t in self.mamba.items()}

    def layers(self) -> list[dict[str, torch.Tensor]]:
        return stacked_layers(dict(self.mamba.items()))


def group_split(cfg) -> tuple[int, int]:
    """(full groups, tail layers)."""
    return cfg.n_layers // cfg.attn_every, cfg.n_layers % cfg.attn_every


def n_attn_apps(cfg) -> int:
    """Applications of the shared block: the full groups, and the tail's."""
    g, t = group_split(cfg)
    return g + (1 if t else 0)


def _groups(cfg) -> list[range]:
    """The Mamba2 layers after each application of the shared block."""
    g, t = group_split(cfg)
    ae = cfg.attn_every
    groups = [range(i * ae, (i + 1) * ae) for i in range(g)]
    return groups + [range(g * ae, cfg.n_layers)] if t else groups


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg, device=None) -> HybridLM:
    """Random parameters from the JAX package's distributions: projections
    N(0, 0.02^2), ``conv_w`` N(0, 0.2^2), ``out_proj`` times 0.02 / sqrt(2 L),
    ``conv_b`` 0, ``dt_bias`` and ``a_log`` 0 and ``d_skip`` 1 (those three in
    float32), norms 1 (:class:`models.lm.ParamDraws`)."""
    draw = ParamDraws(generator, cfg, device)
    normal, ones, zeros = draw.normal, draw.ones, draw.zeros
    f32 = torch.float32
    d, f, v, n = cfg.d_model, cfg.d_ff, cfg.padded_vocab, cfg.n_layers
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    d_in, nh, ds, _ = L.mamba2_dims(cfg)
    conv_ch = d_in + 2 * ds
    mamba = {
        "ln": ones(n, d),
        "in_proj": normal(n, d, 2 * d_in + 2 * ds + nh),
        "conv_w": normal(n, cfg.ssm_conv, conv_ch, scale=0.2),
        "conv_b": zeros(n, conv_ch),
        "dt_bias": zeros(n, nh, dtype=f32),
        "a_log": zeros(n, nh, dtype=f32),
        "d_skip": ones(n, nh, dtype=f32),
        "norm": ones(n, d_in),
        "out_proj": normal(n, d_in, d, scale=0.02 / math.sqrt(2 * n)),
    }
    shared = {
        "ln1": ones(d), "ln2": ones(d),
        "wq": normal(d, hq * hd), "wk": normal(d, hkv * hd), "wv": normal(d, hkv * hd),
        "wo": normal(hq * hd, d),
        "w_gate": normal(d, f), "w_up": normal(d, f), "w_down": normal(f, d),
    }
    return HybridLM({"embed": normal(v, d), "mamba": mamba, "shared": shared,
                     "ln_f": ones(d), "lm_head": normal(d, v)})


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _shared_block(x, sp, cfg, positions, *, return_kv: bool = False):
    out = L.attention_train(L.rms_norm(x, sp["ln1"]), sp, cfg, positions=positions,
                            return_kv=return_kv)
    att, kv = out if return_kv else (out, None)
    x = x + att
    x = x + L.mlp(L.rms_norm(x, sp["ln2"]), sp, cfg)
    return (x, kv) if return_kv else x


def train_loss(params: HybridLM, batch, cfg) -> torch.Tensor:
    """Mean next-token cross-entropy; with ``cfg.remat`` each full group runs
    under ``checkpoint`` (JAX checkpoints its group body; the tail group
    runs outside it)."""
    tokens = batch["tokens"]
    x = shard(_embed(params, tokens, cfg), "dp", None, None)
    positions = torch.arange(x.shape[1], device=x.device)
    sp = params["shared"]
    layers = params.layers()

    def group(h, idx):
        h = _shared_block(h, sp, cfg, positions)
        for i in idx:
            h = shard(h + L.mamba2_scan(L.rms_norm(h, layers[i]["ln"]), layers[i], cfg),
                      "dp", None, None)
        return h

    full, _ = group_split(cfg)
    for a, idx in enumerate(_groups(cfg)):
        if cfg.remat and a < full:
            x = checkpoint(group, x, idx, use_reentrant=False)
        else:
            x = group(x, idx)
    x = L.rms_norm(x, params["ln_f"])
    return next_token_loss(_logits(params, x, cfg), tokens)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, max_len: int, dtype=None, device=None) -> dict:
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    d_in, nh, ds, hd_ssm = L.mamba2_dims(cfg)
    kv = (n_attn_apps(cfg), batch_size, cfg.n_kv_heads, max_len, cfg.head_dim_)
    return {
        "ssm": torch.zeros((cfg.n_layers, batch_size, nh, hd_ssm, ds), dtype=torch.float32,
                           device=dev),
        "conv": torch.zeros((cfg.n_layers, batch_size, cfg.ssm_conv - 1, d_in + 2 * ds),
                            dtype=dtype, device=dev),
        "k": torch.zeros(kv, dtype=dtype, device=dev),
        "v": torch.zeros(kv, dtype=dtype, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _put_state(cache: dict, i: int, h, conv) -> None:
    """Layer ``i``'s Mamba2 state and conv window into the cache (a sharded
    cache takes each rank's pieces)."""
    if is_dtensor(cache["ssm"]):
        write_at(cache["ssm"][i], 0, 0, h)
        write_at(cache["conv"][i], 0, 0, conv)
    else:
        cache["ssm"][i] = h
        cache["conv"][i] = conv


@serving
def prefill(params: HybridLM, batch, cfg, *, max_len: int | None = None):
    """Forward the prompt; return (last-position float32 logits (B, V), the
    cache with ``max_len`` KV slots and ``pos`` = prompt length)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt ({s})")
    x = shard(_embed(params, tokens, cfg), "dp", None, None)
    positions = torch.arange(s, device=x.device)
    sp = params["shared"]
    cache = init_cache(cfg, b, max_len, dtype=x.dtype, device=x.device)
    sharded = is_dtensor(x)
    if sharded:
        cache = sharded_cache(cfg, cache)
    for a, idx in enumerate(_groups(cfg)):
        x, (k, v) = _shared_block(x, sp, cfg, positions, return_kv=True)
        if sharded:
            write_at(cache["k"][a], 2, 0, k)
            write_at(cache["v"][a], 2, 0, v)
        else:
            cache["k"][a, :, :, :s] = k
            cache["v"][a, :, :, :s] = v
        for i in idx:
            mp = params.layer(i)
            y, (h, conv) = L.mamba2_scan(L.rms_norm(x, mp["ln"]), mp, cfg, return_state=True)
            x = shard(x + y, "dp", None, None)
            _put_state(cache, i, h, conv)
    x = L.rms_norm(x[:, -1:], params["ln_f"])
    logits = _logits(params, x, cfg)[:, 0]
    cache["pos"].fill_(s)
    return logits, cache


@serving
def decode_step(params: HybridLM, batch, cache: dict, cfg):
    """One-token decode.  batch = {"next_token": (B,)}; ``cache`` from
    :func:`init_cache` or :func:`prefill`, updated in place and returned
    with ``pos`` advanced by one."""
    x = _embed(params, batch["next_token"][:, None], cfg)
    pos = cache["pos"]
    sp = params["shared"]
    for a, idx in enumerate(_groups(cfg)):
        att, _, _ = L.attention_decode(L.rms_norm(x, sp["ln1"]), sp, cfg,
                                       cache["k"][a], cache["v"][a], pos)
        x = x + att
        x = x + L.mlp(L.rms_norm(x, sp["ln2"]), sp, cfg)
        for i in idx:
            mp = params.layer(i)
            y, h, conv = L.mamba2_decode(L.rms_norm(x, mp["ln"]), mp, cfg,
                                         cache["ssm"][i], cache["conv"][i])
            _put_state(cache, i, h, conv)
            x = x + y
    x = L.rms_norm(x, params["ln_f"])
    logits = _logits(params, x, cfg)[:, 0]
    cache["pos"] = pos + 1
    return logits, cache


__all__ = ["HybridLM", "decode_step", "group_split", "init_cache", "init_params",
           "n_attn_apps", "prefill", "train_loss"]
