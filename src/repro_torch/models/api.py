"""Public model API of the port: family dispatch and the ``make_*_step``
functions (``repro/models/api.py``).

  * :func:`get_model`         — family -> (init_params, train_loss, prefill,
                                decode_step, init_cache): ``encdec``,
                                ``hybrid``, ``xlstm`` and ``lm`` (dense, MoE
                                and the vision stub);
  * :func:`attention_calls`   — full-sequence attention calls a prefill
                                makes (B6's launches under ``flash``);
  * :func:`make_train_step`   — loss + grad + microbatch accumulation +
                                AdamW; :func:`init_state` its state;
  * :func:`make_prefill_step` / :func:`make_serve_step` — serving;
  * :func:`input_specs`       — the inputs of a cell as meta-device tensors
                                (shapes and dtypes, no storage);
  * :func:`make_batch`        — a random batch of those inputs from a
                                ``torch.Generator``.

Every step function runs under :func:`float32_split_k_sums`.
``grad_shardings``, the ``abstract_*`` shapes and the sharding rules wait
for the multi-card slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import NO_BACKWARD
from repro_torch.optim import TrainState, adamw_init, adamw_update, cosine_warmup
from repro_torch.runtime.fault_tolerance import split_batch

from . import encdec, hybrid, lm, xlstm


class Model(NamedTuple):
    init_params: Callable
    train_loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def _family(cfg: ArchConfig):
    """The model module, in JAX's order: encoder-decoder, hybrid, xLSTM
    (``ssm`` with ``d_ff == 0``), else the decoder LM (which holds the
    vision stub)."""
    if cfg.is_encdec:
        return encdec
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family == "ssm" and cfg.d_ff == 0:
        return xlstm
    return lm


def get_model(cfg: ArchConfig) -> Model:
    """The family's (init_params, train_loss, prefill, decode_step,
    init_cache)."""
    mod = _family(cfg)
    return Model(mod.init_params, mod.train_loss, mod.prefill, mod.decode_step,
                 mod.init_cache)


def attention_calls(cfg: ArchConfig) -> int:
    """Full-sequence attention calls one prefill makes, so B6's launches
    under ``attn_impl="flash"``: one a layer for the decoder LM (the vision
    stub included), one an application of the shared block for the hybrid
    (``hybrid.n_attn_apps``), none for xLSTM, and for the encoder-decoder
    one an encoder layer and two a decoder layer (self and cross)."""
    mod = _family(cfg)
    if mod is encdec:
        return cfg.encoder_layers + 2 * cfg.n_layers
    if mod is hybrid:
        return hybrid.n_attn_apps(cfg)
    return 0 if mod is xlstm else cfg.n_layers


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict[str, torch.Tensor]:
    """A cell's inputs as meta-device tensors: JAX's ``ShapeDtypeStruct``
    stand-ins, the same shapes and dtypes, no storage.  A train or
    prefill cell gives ``tokens`` (B, S) int32; the vision stub's ``seq_len``
    counts its patches, so its ``tokens`` are (B, S - P) and ``patches``
    (B, P, d); the audio stub adds ``frames`` (B, T, d); both in
    ``cfg.dtype``.  A decode cell gives ``next_token`` (B,) int32."""
    b, s = cell.global_batch, cell.seq_len
    spec = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    i32, f = torch.int32, getattr(torch, cfg.dtype)
    if cell.kind not in ("train", "prefill"):
        return {"next_token": spec((b,), i32)}
    front = (b, cfg.frontend_tokens, cfg.d_model)
    if cfg.frontend == "vision_stub":
        return {"tokens": spec((b, s - cfg.frontend_tokens), i32), "patches": spec(front, f)}
    if cfg.frontend == "audio_stub":
        return {"tokens": spec((b, s), i32), "frames": spec(front, f)}
    return {"tokens": spec((b, s), i32)}


def make_batch(cfg: ArchConfig, cell: ShapeCell, generator: torch.Generator,
               device=None) -> dict[str, torch.Tensor]:
    """A random batch of :func:`input_specs`' inputs, drawn in their order
    from ``generator`` (which lives on ``device``): integers in [0,
    ``vocab_size``), float inputs standard normal in float32 cast to their
    dtype."""
    dev = resolve_device(device)
    out = {}
    for name, sd in input_specs(cfg, cell).items():
        if sd.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, sd.shape, generator=generator,
                                      dtype=torch.int32, device=dev)
        else:
            out[name] = torch.randn(sd.shape, generator=generator, dtype=torch.float32,
                                    device=dev).to(sd.dtype)
    return out


@contextlib.contextmanager
def float32_split_k_sums():
    """bf16 GEMMs add their split-K partials in float32 inside the block.

    PyTorch lets cuBLAS add them in bf16 by default
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``);
    the JAX package asks for float32 (``preferred_element_type``).  The flag
    is process-wide, so the caller's value is put back on the way out.
    """
    flags = torch.backends.cuda.matmul
    before = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = before


def loss_and_grads(params, batch, cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """``train_loss`` and its gradients by parameter name (``params.tensors()``
    names; each in its parameter's dtype, as ``jax.value_and_grad`` gives)."""
    tensors = params.tensors()
    loss = get_model(cfg).train_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, list(tensors.values()))
    return loss.detach(), dict(zip(tensors, grads))


def make_train_step(cfg: ArchConfig, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, grad_transform: Callable | None = None):
    """(TrainState, batch) -> (TrainState, {"loss", "grad_norm"}) with
    microbatch gradient accumulation (``cfg.microbatch``).

    ``accum_mode="grads"`` adds each microbatch's gradients in
    ``grad_accum_dtype``, then divides by the count and casts to float32;
    ``"loss_scan"`` takes one gradient of the mean microbatch loss, each
    microbatch's forward checkpointed.  ``grad_transform(grads) -> grads``
    (gradient compression, coded-DP decode) runs before AdamW.  The state's
    tensors are updated in place.  A config with ``attn_impl="flash"``
    raises here: B6 has no backward pass.
    """
    if cfg.attn_impl == "flash":
        raise RuntimeError(NO_BACKWARD)
    model = get_model(cfg)
    mb = max(1, cfg.microbatch)

    def train_step(state: TrainState, batch):
        with float32_split_k_sums():
            if mb == 1:
                loss, grads = loss_and_grads(state.params, batch, cfg)
            elif cfg.accum_mode == "loss_scan":
                tensors = state.params.tensors()
                micro = lambda sub: model.train_loss(state.params, sub, cfg)
                total = None
                for sub in split_batch(batch, mb):
                    part = checkpoint(micro, sub, use_reentrant=False)
                    total = part if total is None else total + part
                total = total / mb
                grads = dict(zip(tensors, torch.autograd.grad(total, list(tensors.values()))))
                loss = total.detach()
            else:
                acc_dt = getattr(torch, cfg.grad_accum_dtype)
                loss, grads = None, None
                for sub in split_batch(batch, mb):
                    loss_i, g_i = loss_and_grads(state.params, sub, cfg)
                    g_i = {name: g.to(acc_dt) for name, g in g_i.items()}
                    if grads is None:
                        loss, grads = loss_i, g_i
                    else:
                        loss = loss + loss_i
                        grads = {name: grads[name] + g_i[name] for name in grads}
                loss = loss / mb
                grads = {name: (g / mb).to(torch.float32) for name, g in grads.items()}
            if grad_transform is not None:
                grads = grad_transform(grads)
            lr = cosine_warmup(state.step + 1, peak_lr=peak_lr, warmup=warmup,
                               total=total_steps)
            new_state, om = adamw_update(state, grads, lr)
        return new_state, {"loss": loss, **om}

    return train_step


def init_state(cfg: ArchConfig, generator: torch.Generator, device=None) -> TrainState:
    """Trainable random parameters (``init_params`` on ``device``, where
    ``generator`` lives) and zero moments in ``cfg.opt_state_dtype``."""
    params = get_model(cfg).init_params(generator, cfg, device=device).trainable()
    return adamw_init(params, getattr(torch, cfg.opt_state_dtype))


def make_prefill_step(cfg: ArchConfig, *, max_len: int | None = None,
                      attn_impl: str | None = None):
    """(params, batch) -> (last-position logits, cache).

    As in JAX, a prefill with ``max_len >= 8192`` and no ``attn_impl``
    given runs ``blockwise`` whatever ``cfg.attn_impl`` says; a long flash
    prefill must pass ``attn_impl="flash"``.
    """
    if attn_impl is None and max_len is not None and max_len >= 8192:
        attn_impl = "blockwise"
    if attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    model = get_model(cfg)

    def prefill_step(params, batch):
        with float32_split_k_sums():
            return model.prefill(params, batch, cfg, max_len=max_len)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """(params, cache, batch) -> (logits, cache); the cache is updated in
    place."""
    model = get_model(cfg)

    def serve_step(params, cache, batch):
        with float32_split_k_sums():
            return model.decode_step(params, batch, cache, cfg)

    return serve_step


__all__ = ["Model", "attention_calls", "float32_split_k_sums", "get_model", "init_state",
           "input_specs", "loss_and_grads", "make_batch", "make_prefill_step",
           "make_serve_step", "make_train_step"]
