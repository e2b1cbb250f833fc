"""AdamW with global-norm clipping and a configurable moment dtype
(``repro/optim/adamw.py``), in plain PyTorch.

The state is ``TrainState(params, m, v, step)``: ``params`` a module whose
``tensors()`` gives its parameters by dotted name (``models.lm.ParamTree``),
``m`` and ``v`` dicts under the same names, stored in ``opt_state_dtype``
(float32, or bf16 for nemotron), and ``step`` an int32 0-d tensor.  The
arithmetic is JAX's, in float32.  Unlike JAX, :func:`adamw_update` writes
the new parameters and moments into the state's tensors in place.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

_F32 = torch.float32


class TrainState(NamedTuple):
    params: Any
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    step: torch.Tensor


def jax_order(names) -> list[str]:
    """Dotted names in the order JAX flattens the same tree: dict keys
    sorted level by level, tuple positions (the digit parts, xLSTM's
    ``blocks.10``) in numeric order."""
    part = lambda p: (0, int(p), "") if p.isdigit() else (1, 0, p)
    return sorted(names, key=lambda name: tuple(part(p) for p in name.split(".")))


def adamw_init(params, state_dtype=_F32) -> TrainState:
    tensors = params.tensors()
    zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
    return TrainState(
        params=params,
        m={name: zeros(p) for name, p in tensors.items()},
        v={name: zeros(p) for name, p in tensors.items()},
        step=torch.zeros((), dtype=torch.int32, device=next(iter(tensors.values())).device),
    )


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaves added in
    JAX's order."""
    total = None
    for name in jax_order(grads):
        sq = torch.sum(grads[name].to(_F32) ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    state: TrainState,
    grads: dict[str, torch.Tensor],
    lr: torch.Tensor | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float | None = 1.0,
) -> tuple[TrainState, dict]:
    """One AdamW step on ``grads`` (a dict under the parameters' names);
    returns the state (its tensors updated in place, ``step`` advanced) and
    ``{"grad_norm"}``, the norm before clipping."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = None
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.to(_F32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=_F32, device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=_F32, device=stepf.device), stepf)
    lr = torch.as_tensor(lr, dtype=_F32, device=stepf.device)
    for name, p in state.params.tensors().items():
        gf = grads[name].to(_F32)          # JAX promotes g * scale to float32
        if scale is not None:
            gf = gf * scale
        m, v = state.m[name], state.v[name]
        m32 = m.to(_F32) * b1 + gf * (1 - b1)
        v32 = v.to(_F32) * b2 + gf * gf * (1 - b2)
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + eps) + weight_decay * p.to(_F32)
        p.copy_(p.to(_F32) - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return state._replace(step=step), {"grad_norm": gnorm}


__all__ = ["TrainState", "adamw_init", "adamw_update", "global_norm", "jax_order"]
