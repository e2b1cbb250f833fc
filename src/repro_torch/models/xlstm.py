"""xLSTM (``repro/models/xlstm.py``): mLSTM blocks (matrix memory,
chunk-parallel) with sLSTM blocks (scalar memory, a time loop) at
``cfg.slstm_at``.  The model runs no attention.

Parameters live in an :class:`XLSTMLM` module under JAX's names: ``embed``
(V, d), ``blocks`` (one dict a block, of two kinds, :func:`block_types`;
dotted names ``blocks.0.w_up``, ...), ``ln_f`` and ``lm_head``.  The mLSTM
head is ``2 d / H`` wide (384 for xlstm-125m), the sLSTM head ``d / H``
(192); ``cfg.head_dim`` is read by no module.

The state is O(1) in the sequence length.  The cache is JAX's dict
``{"blocks": (...), "pos"}``: an mLSTM block's entry is ((C (B,H,D,D), n
(B,H,D), m (B,H)) in float32, the last 3 inputs of its causal conv), an
sLSTM block's (h, c, n, m), each (B,H,D) float32.  :func:`decode_step`
runs the blocks on one token (an mLSTM chunk of 1, as JAX does) and puts
the new states into the cache dict it returns.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import layers as L
from .sharding import serving, shard
from .lm import ParamDraws, ParamTree, _embed, _logits, frozen, next_token_loss

_CONV = 4       # the mLSTM block's causal conv width


class XLSTMLM(ParamTree):
    """The parameters of an xLSTM, under the JAX names; :meth:`layer` gives
    block ``i``'s tensors."""

    def __init__(self, tree: dict):
        super().__init__()
        blocks = tree["blocks"]
        if isinstance(blocks, dict):                   # from_tensors: keys "0", "1", ...
            blocks = [blocks[str(i)] for i in range(len(blocks))]
        self.embed = frozen(tree["embed"])
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: frozen(v) for k, v in bp.items()}) for bp in blocks)
        self.ln_f = frozen(tree["ln_f"])
        self.lm_head = frozen(tree["lm_head"])

    def layer(self, i: int) -> dict[str, torch.Tensor]:
        return dict(self.blocks[i].items())


def block_types(cfg) -> list[str]:
    return ["slstm" if i in cfg.slstm_at else "mlstm" for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg, device=None) -> XLSTMLM:
    """Random parameters from the JAX package's distributions: projections
    and ``r`` N(0, 0.02^2), the conv N(0, 0.2^2), ``conv_b`` 0, ``b_if`` 0 in
    float32, norms 1 (:class:`models.lm.ParamDraws`)."""
    draw = ParamDraws(generator, cfg, device)
    normal, ones, zeros = draw.normal, draw.ones, draw.zeros
    d, h, v = cfg.d_model, cfg.n_heads, cfg.padded_vocab
    d_in, dh = 2 * d, d // h
    f = ((4 * d // 3) + 63) // 64 * 64         # the sLSTM GLU: 4 d / 3, up to 64s
    blocks = []
    for kind in block_types(cfg):
        if kind == "mlstm":
            blocks.append({
                "ln": ones(d), "w_up": normal(d, 2 * d_in),
                "conv_w": normal(_CONV, d_in, scale=0.2), "conv_b": zeros(d_in),
                "wq": normal(d_in, d_in), "wk": normal(d_in, d_in), "wv": normal(d_in, d_in),
                "w_if": normal(d_in, 2 * h), "b_if": zeros(2 * h, dtype=torch.float32),
                "gn": ones(d_in), "w_down": normal(d_in, d),
            })
        else:
            blocks.append({
                "ln": ones(d), "w_gates": normal(d, 4 * d), "r": normal(h, 4, dh, dh),
                "gn": ones(d), "w_o": normal(d, d), "ln2": ones(d),
                "w1": normal(d, 2 * f), "w2": normal(f, d),
            })
    return XLSTMLM({"embed": normal(v, d), "blocks": blocks, "ln_f": ones(d),
                    "lm_head": normal(d, v)})


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def mlstm_chunk(s: int) -> int:
    """JAX's chunk rule: 128 when it divides the sequence, else one chunk
    (a sequence shorter than 128, or a ragged one, runs whole)."""
    chunk = min(128, s) if s % 128 != 0 else 128
    return chunk if s % chunk == 0 else s


def _mlstm_block(x, p, cfg, *, state=None, return_state: bool = False):
    b, s, d = x.shape
    h = cfg.n_heads
    d_in = 2 * d
    dh = d_in // h
    up = L.dot(L.rms_norm(x, p["ln"]), p["w_up"])
    x_in, gate = up.chunk(2, dim=-1)
    if state is None:
        conv_in, cell_in = x_in, None
    else:
        cell_in, conv_state = state
        conv_in = torch.cat([conv_state.to(x_in.dtype), x_in], dim=1)
    conv_state_out = conv_in[:, -(_CONV - 1):]
    x_c = L.silu(L._causal_conv(conv_in, p["conv_w"], p["conv_b"])[:, -s:])

    q = L._split_heads(L.dot(x_c, p["wq"]), h, dh)
    k = L._split_heads(L.dot(x_c, p["wk"]), h, dh)
    v = L._split_heads(L.dot(x_in, p["wv"]), h, dh)
    if_pre = L.dot(x_in, p["w_if"]).to(torch.float32) + p["b_if"]
    i_pre, f_pre = if_pre.chunk(2, dim=-1)                 # (B,S,H)

    mlstm = L.mlstm_sharded if L.is_dtensor(q) else L.mlstm_chunked
    out = mlstm(q, k, v, i_pre, f_pre, chunk=mlstm_chunk(s), initial=cell_in,
                return_state=return_state)
    if return_state:
        out, cell = out
    hid = L.rms_norm(L.merge_heads(out).to(x.dtype), p["gn"])
    y = x + L.dot(hid * L.silu(gate), p["w_down"])
    return (y, (cell, conv_state_out)) if return_state else y


def _slstm_block(x, p, cfg, *, state=None, return_state: bool = False):
    b, s, d = x.shape
    h = cfg.n_heads
    gates = L._whole(L.dot(L.rms_norm(x, p["ln"]), p["w_gates"]), -1, 4).reshape(
        b, s, 4, h, d // h)
    slstm = L.slstm_sharded if L.is_dtensor(gates) else L.slstm_scan
    out = slstm(gates.transpose(2, 3), p["r"], initial=state,
                return_state=return_state)                 # gates (B,S,H,4,D)
    if return_state:
        out, new_state = out
    hid = L.rms_norm(L.merge_heads(out).to(x.dtype), p["gn"])
    y = x + L.dot(hid, p["w_o"])
    # post GLU MLP (proj factor 4/3)
    a, g = L.dot(L.rms_norm(y, p["ln2"]), p["w1"]).chunk(2, dim=-1)
    y = y + L.dot(a * L.silu(g), p["w2"])
    return (y, new_state) if return_state else y


def _forward(params: XLSTMLM, tokens, cfg, caches=None, return_states: bool = False,
             remat: bool = False):
    x = shard(_embed(params, tokens, cfg), "dp", None, None)
    states = []
    for i, kind in enumerate(block_types(cfg)):
        blk = _slstm_block if kind == "slstm" else _mlstm_block
        p = params.layer(i)
        if return_states:
            x, st = blk(x, p, cfg, state=caches[i], return_state=True)
            states.append(st)
        elif remat:
            x = checkpoint(blk, x, p, cfg, use_reentrant=False)
        else:
            x = blk(x, p, cfg)
    x = L.rms_norm(x, params["ln_f"])
    return (x, states) if return_states else x


def train_loss(params: XLSTMLM, batch, cfg) -> torch.Tensor:
    """Mean next-token cross-entropy; with ``cfg.remat`` each block runs
    under ``checkpoint``, as JAX checkpoints each block."""
    tokens = batch["tokens"]
    x = _forward(params, tokens, cfg, remat=cfg.remat)
    return next_token_loss(_logits(params, x, cfg), tokens)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, max_len: int, dtype=None, device=None) -> dict:
    """The initial state (``max_len`` is not used: the state is O(1) in the
    sequence length).  The mLSTM stabiliser starts at -inf."""
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    d, h = cfg.d_model, cfg.n_heads
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    caches = []
    for kind in block_types(cfg):
        if kind == "mlstm":
            dh = 2 * d // h
            cell = (zeros(batch_size, h, dh, dh), zeros(batch_size, h, dh),
                    torch.full((batch_size, h), -torch.inf, device=dev))
            conv = torch.zeros((batch_size, _CONV - 1, 2 * d), dtype=dtype, device=dev)
            caches.append((cell, conv))
        else:
            caches.append(tuple(zeros(batch_size, h, d // h) for _ in range(4)))
    return {"blocks": tuple(caches), "pos": torch.zeros((), dtype=torch.int32, device=dev)}


@serving
def prefill(params: XLSTMLM, batch, cfg, *, max_len: int | None = None):
    """Forward the prompt from the initial state; return (last-position
    float32 logits (B, V), the cache with ``pos`` = prompt length)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    start = init_cache(cfg, b, 0, device=tokens.device)
    x, states = _forward(params, tokens, cfg, caches=start["blocks"], return_states=True)
    logits = _logits(params, x[:, -1:], cfg)[:, 0]
    start["pos"].fill_(s)
    return logits, {"blocks": tuple(states), "pos": start["pos"]}


@serving
def decode_step(params: XLSTMLM, batch, cache: dict, cfg):
    """One-token decode.  batch = {"next_token": (B,)}; returns (logits,
    ``cache``) with the new states in ``cache["blocks"]`` and ``pos``
    advanced by one."""
    x, states = _forward(params, batch["next_token"][:, None], cfg, caches=cache["blocks"],
                         return_states=True)
    logits = _logits(params, x, cfg)[:, 0]
    cache["blocks"] = tuple(states)
    cache["pos"] = cache["pos"] + 1
    return logits, cache


__all__ = ["XLSTMLM", "block_types", "decode_step", "init_cache", "init_params",
           "mlstm_chunk", "prefill", "train_loss"]
