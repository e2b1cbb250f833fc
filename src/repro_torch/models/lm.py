"""Decoder-only LM, dense, MoE or with the vision stub: parameters, prefill
and cached decode (``repro/models/lm.py``).

Parameters live in a :class:`DecoderLM` module under the JAX names and
layouts: ``embed`` (V, d), ``blocks`` (each tensor stacked over layers,
(L, ...)), ``ln_f`` (d,), ``lm_head`` (d, V) unless the embeddings are
tied and ``patch_proj`` (d, d) for the vision stub; ``params["embed"]``
reads as in JAX, so carrying JAX weights over is a copy, name for name
(``repro_torch.convert.model_params``).

The JAX package scans over the stacked layers; the port loops over them.
The KV cache is the JAX dict ``{"k": (L, B, Hkv, S, Dh), "v": ..., "pos"}``,
but the port writes into it in place: :func:`prefill` writes each layer's
keys and values straight into a preallocated cache, and :func:`decode_step`
writes the new token's at ``pos`` and returns the same dict with ``pos``
advanced (JAX returns a new cache built in a donated buffer).  Both run
under ``torch.inference_mode()``.

Training: :func:`train_loss` is JAX's mean next-token cross-entropy, run
outside inference mode through a differentiable :func:`_run_blocks`
(``cfg.remat`` checkpoints each block, and each group of
``n_layers / scan_groups`` blocks, with ``torch.utils.checkpoint``, as JAX
nests ``jax.checkpoint``).  Parameters are created frozen; a trainer calls
:meth:`DecoderLM.trainable` (``models.api.init_state`` does).

A block's MLP is :func:`layers.moe` when ``cfg.n_experts`` is set (its
``router`` (L, d, E), ``w_gate`` / ``w_up`` (L, E, d, f) and ``w_down``
(L, E, f, d)), else :func:`layers.mlp`.

The vision stub (``cfg.frontend == "vision_stub"``, phi-3-vision) reads
``batch["patches"]`` (B, P, d), precomputed patch embeddings: cast to the
model's dtype, projected by ``patch_proj`` (d, d) and prepended to the text
embeddings (:func:`_embed_sequence`).  Positions run over patches and text,
0 .. S_total - 1; the cache's ``pos`` is S_total, so ``max_len`` counts the
patches; the loss covers the text positions only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import layers as L

_F32 = torch.float32


def frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def stacked_layers(stack: dict[str, torch.Tensor]) -> list[dict[str, torch.Tensor]]:
    """Every layer's tensors from layer-stacked (L, ...) tensors, from one
    ``unbind`` of each: under autograd the layers' gradients are stacked
    once, where indexing layer by layer would add a full-size gradient for
    each layer."""
    per_name = {name: t.unbind(0) for name, t in stack.items()}
    return [{name: ts[i] for name, ts in per_name.items()}
            for i in range(len(next(iter(per_name.values()))))]


class ParamTree(nn.Module):
    """The parameters of one of the port's models, under the JAX names, as a
    module: ``params["embed"]`` reads as in JAX, and :meth:`layer` gives one
    layer's tensors.  Parameters are created frozen; a trainer calls
    :meth:`trainable`.  :meth:`tensors` / :meth:`from_tensors` give the flat
    form (dotted names) that gradients, optimizer moments and checkpoints
    take."""

    def __getitem__(self, name: str):
        return getattr(self, name)

    def trainable(self):
        """Let every parameter require grad (in place); returns ``self``."""
        for p in self.parameters():
            p.requires_grad_(True)
        return self

    def tensors(self) -> dict[str, torch.Tensor]:
        """The parameters by dotted name (``embed``, ``blocks.wq``, ...,
        ``ln_f``, ``lm_head``)."""
        return dict(self.named_parameters())

    @classmethod
    def from_tensors(cls, named: dict[str, torch.Tensor]):
        """The inverse of :meth:`tensors` (frozen parameters)."""
        tree: dict = {}
        for name, t in named.items():
            *heads, leaf = name.split(".")
            node = tree
            for head in heads:
                node = node.setdefault(head, {})
            node[leaf] = t
        return cls(tree)


class DecoderLM(ParamTree):
    """The parameters of a decoder LM (dense or MoE), under the JAX names."""

    def __init__(self, tree: dict):
        super().__init__()
        self.embed = frozen(tree["embed"])
        self.blocks = nn.ParameterDict({k: frozen(v) for k, v in tree["blocks"].items()})
        self.ln_f = frozen(tree["ln_f"])
        for name in ("lm_head", "patch_proj"):      # untied head; the vision stub's
            if tree.get(name) is None:
                self.register_parameter(name, None)
            else:
                setattr(self, name, frozen(tree[name]))

    def layer(self, i: int) -> dict[str, torch.Tensor]:
        """Layer ``i``'s block tensors (views of the stacked ones)."""
        return {name: t[i] for name, t in self.blocks.items()}

    def layers(self) -> list[dict[str, torch.Tensor]]:
        """Every layer's block tensors (:func:`stacked_layers`)."""
        return stacked_layers(dict(self.blocks.items()))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class ParamDraws:
    """Random parameters from the JAX package's distributions, drawn from
    ``generator`` (which must live on ``device``) and stored in ``cfg.dtype``
    unless a dtype is given.  Same distributions, not the same bits."""

    def __init__(self, generator: torch.Generator, cfg, device=None):
        self.generator = generator
        self.dtype = getattr(torch, cfg.dtype)
        self.device = resolve_device(device)

    def normal(self, *shape, scale: float = 0.02) -> torch.Tensor:
        """N(0, scale^2), drawn in float32 and scaled in place: one float32
        draw alive at a time (nemotron's (18 432, 256 000) lm_head is 18.9 GB
        in float32)."""
        t = torch.randn(shape, generator=self.generator, dtype=_F32, device=self.device)
        return t.mul_(scale).to(self.dtype)

    def ones(self, *shape, dtype=None) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype or self.dtype, device=self.device)

    def zeros(self, *shape, dtype=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype or self.dtype, device=self.device)


def dense_block_params(draw: ParamDraws, cfg, n: int) -> dict[str, torch.Tensor]:
    """``n`` stacked attention + MLP blocks (JAX's ``_dense_block_params``):
    normal times 0.02, the output projections times 0.02 / sqrt(2
    ``cfg.n_layers``) whatever ``n`` is (the encoder's stack too), norms at
    1."""
    normal, ones = draw.normal, draw.ones
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    blocks = {
        "ln1": ones(n, d), "ln2": ones(n, d),
        "wq": normal(n, d, hq * hd), "wk": normal(n, d, hkv * hd),
        "wv": normal(n, d, hkv * hd), "wo": normal(n, hq * hd, d, scale=out_scale),
    }
    if cfg.qk_norm:
        blocks["q_scale"] = ones(n, hd)
        blocks["k_scale"] = ones(n, hd)
    if cfg.n_experts:
        e = cfg.n_experts
        blocks["router"] = normal(n, d, e)
        blocks["w_gate"] = normal(n, e, d, f)
        blocks["w_up"] = normal(n, e, d, f)
        blocks["w_down"] = normal(n, e, f, d, scale=out_scale)
    else:
        if cfg.mlp_type == "swiglu":
            blocks["w_gate"] = normal(n, d, f)
        blocks["w_up"] = normal(n, d, f)
        blocks["w_down"] = normal(n, f, d, scale=out_scale)
    return blocks


def init_params(generator: torch.Generator, cfg, device=None) -> DecoderLM:
    """Random parameters from the JAX package's distributions
    (:func:`dense_block_params`; the embedding, head and ``patch_proj`` at
    0.02), drawn in float32 from ``generator`` and cast to ``cfg.dtype``
    (:class:`ParamDraws`)."""
    draw = ParamDraws(generator, cfg, device)
    d, v = cfg.d_model, cfg.padded_vocab
    blocks = dense_block_params(draw, cfg, cfg.n_layers)
    tree = {"embed": draw.normal(v, d), "blocks": blocks, "ln_f": draw.ones(d)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = draw.normal(d, v)
    if cfg.frontend == "vision_stub":
        tree["patch_proj"] = draw.normal(d, d)
    return DecoderLM(tree)


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------

def _embed(params: DecoderLM, tokens: torch.Tensor, cfg) -> torch.Tensor:
    x = F.embedding(tokens, params["embed"])
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)


def _embed_sequence(params: DecoderLM, batch, cfg):
    """Tokens (and, for the vision stub, the projected patches before them)
    -> (B, S_total, d), and the number of prefix (non-text) positions."""
    x = _embed(params, batch["tokens"], cfg)
    if cfg.frontend != "vision_stub":
        return x, 0
    patches = L.dot(batch["patches"].to(x.dtype), params["patch_proj"])   # (B, P, d)
    return torch.cat([patches, x], dim=1), patches.shape[1]


def _logits(params: DecoderLM, x: torch.Tensor, cfg) -> torch.Tensor:
    """Float32 logits (the bf16 operands' products summed in float32), the
    padded vocabulary masked to -1e30."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x.to(_F32), head.to(_F32))
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _block_tail(x: torch.Tensor, bp, cfg) -> torch.Tensor:
    z = L.rms_norm(x, bp["ln2"])
    return x + (L.moe(z, bp, cfg) if cfg.n_experts else L.mlp(z, bp, cfg))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _block(x: torch.Tensor, bp, cfg, positions: torch.Tensor) -> torch.Tensor:
    h = L.attention_train(L.rms_norm(x, bp["ln1"]), bp, cfg, positions=positions)
    return _block_tail(x + h, bp, cfg)


def _run_blocks(x: torch.Tensor, params: DecoderLM, cfg,
                positions: torch.Tensor) -> torch.Tensor:
    """The blocks in order, differentiable.  With ``cfg.remat`` each block
    runs under ``checkpoint`` (its activations recomputed in the backward)
    and, when ``scan_groups`` > 1 divides ``n_layers``, so does each group
    of ``n_layers / scan_groups`` blocks around them: JAX's two-level remat
    scan.  Remat changes memory, not values.  ``remat_policy`` names which
    activations JAX saves inside a checkpoint; the port recomputes all."""
    layers = params.layers()
    if cfg.remat:
        block = lambda h, bp: checkpoint(_block, h, bp, cfg, positions, use_reentrant=False)
    else:
        block = lambda h, bp: _block(h, bp, cfg, positions)

    def run(h, group):
        for bp in group:
            h = block(h, bp)
        return h

    g = max(1, cfg.scan_groups)
    if g > 1 and cfg.n_layers % g == 0:
        k = cfg.n_layers // g
        for start in range(0, cfg.n_layers, k):
            group = layers[start:start + k]
            x = (checkpoint(run, x, group, use_reentrant=False) if cfg.remat
                 else run(x, group))
        return x
    return run(x, layers)


def train_loss(params: DecoderLM, batch, cfg) -> torch.Tensor:
    """Mean next-token cross-entropy over text positions, from float32
    logits (the padded vocabulary masked as in :func:`_logits`)."""
    x, prefix = _embed_sequence(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_blocks(x, params, cfg, positions)
    x = L.rms_norm(x, params["ln_f"])
    logits = _logits(params, x, cfg)                       # (B, S_total, V) f32
    return next_token_loss(logits[:, prefix:], batch["tokens"])


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of float32 text logits (B, S, V) against the next
    tokens."""
    pred = logits[:, :-1]
    tgt = tokens[:, 1:].long()
    lse = torch.logsumexp(pred, dim=-1)
    true = torch.gather(pred, -1, tgt[..., None])[..., 0]
    return torch.mean(lse - true)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, max_len: int, dtype=None, device=None) -> dict:
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_len, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.inference_mode()
def prefill(params: DecoderLM, batch, cfg, *, max_len: int | None = None):
    """Forward the prompt; return (last-position float32 logits (B, V), the
    KV cache with ``max_len`` slots and ``pos`` = prompt length)."""
    x, _ = _embed_sequence(params, batch, cfg)
    b, s_total = x.shape[:2]
    max_len = max_len or s_total
    if max_len < s_total:
        raise ValueError(f"max_len {max_len} is shorter than the prompt ({s_total})")
    positions = torch.arange(s_total, device=x.device)
    cache = init_cache(cfg, b, max_len, dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        bp = params.layer(i)
        att, (k, v) = L.attention_train(L.rms_norm(x, bp["ln1"]), bp, cfg,
                                        positions=positions, return_kv=True)
        cache["k"][i, :, :, :s_total] = k
        cache["v"][i, :, :, :s_total] = v
        x = _block_tail(x + att, bp, cfg)
    x = L.rms_norm(x[:, -1:], params["ln_f"])
    logits = _logits(params, x, cfg)[:, 0]
    cache["pos"].fill_(s_total)
    return logits, cache


@torch.inference_mode()
def decode_step(params: DecoderLM, batch, cache: dict, cfg):
    """One-token decode.  batch = {"next_token": (B,)}; ``cache`` from
    :func:`init_cache` or :func:`prefill`, updated in place and returned
    with ``pos`` advanced by one."""
    x = _embed(params, batch["next_token"][:, None], cfg)
    pos = cache["pos"]
    for i in range(cfg.n_layers):
        bp = params.layer(i)
        att, _, _ = L.attention_decode(L.rms_norm(x, bp["ln1"]), bp, cfg,
                                       cache["k"][i], cache["v"][i], pos)
        x = _block_tail(x + att, bp, cfg)
    x = L.rms_norm(x, params["ln_f"])
    logits = _logits(params, x, cfg)[:, 0]                 # (B, V)
    cache["pos"] = pos + 1
    return logits, cache


__all__ = ["DecoderLM", "ParamDraws", "ParamTree", "decode_step", "dense_block_params",
           "init_cache", "init_params", "next_token_loss", "prefill", "train_loss"]
