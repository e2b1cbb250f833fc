"""Public model API of the port: family dispatch and the serving step
builders (``repro/models/api.py``).

  * :func:`get_model`         — family -> (init_params, prefill, decode_step,
                                init_cache); the dense ``lm`` family only;
  * :func:`make_prefill_step` / :func:`make_serve_step` — each call runs
                                under :func:`float32_split_k_sums`;
  * :func:`make_batch`        — a random batch from a ``torch.Generator``.

Training (``train_loss``, ``make_train_step``, ``optim``), the input specs
and the sharding rules wait for later slices.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.device import resolve_device

from . import lm


class Model(NamedTuple):
    init_params: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def get_model(cfg: ArchConfig) -> Model:
    """The dense decoder LM; every other family raises
    ``NotImplementedError`` naming what it waits for."""
    if cfg.is_encdec:
        family = "encoder-decoder"
    elif cfg.family == "hybrid":
        family = "hybrid (Mamba2 + shared attention)"
    elif cfg.family == "ssm" and cfg.d_ff == 0:
        family = "xLSTM"
    elif cfg.n_experts:
        family = "MoE"
    elif cfg.frontend is not None:
        family = f"{cfg.frontend} frontend"
    else:
        return Model(lm.init_params, lm.prefill, lm.decode_step, lm.init_cache)
    raise NotImplementedError(
        f"{cfg.name}: the {family} models are not ported yet; a later slice of "
        "the LM zoo brings them (ROADMAP.md, Queue A)")


def make_batch(cfg: ArchConfig, cell: ShapeCell, generator: torch.Generator,
               device=None) -> dict[str, torch.Tensor]:
    """Random tokens in [0, vocab_size): (B, S) for a train or prefill cell,
    ``next_token`` (B,) for a decode cell.  ``generator`` lives on ``device``."""
    dev = resolve_device(device)
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend is not ported yet")
    draw = lambda *shape: torch.randint(0, cfg.vocab_size, shape, generator=generator,
                                        device=dev)
    if cell.kind in ("train", "prefill"):
        return {"tokens": draw(cell.global_batch, cell.seq_len)}
    return {"next_token": draw(cell.global_batch)}


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


__all__ = ["Model", "float32_split_k_sums", "get_model", "make_batch", "make_prefill_step", "make_serve_step"]
