"""Dispatcher for exact GF(p) linear algebra, p = 2^31 - 1.

Entry points the coding layer uses:

  * :func:`matmul_gf`          — exact (m, c) @ (c, n) mod p
  * :func:`bmm_gf`             — exact (..., m, c) @ (..., c, n) mod p
  * :func:`lagrange_basis_gf`  — batched Lagrange basis matrices over GF(p)
                                 (generator / erasure-pattern decode builder)

The route follows the tensor (:mod:`repro_torch.kernels.dispatch`), with no
``impl=`` or ``interpret=`` switch: a CUDA tensor goes to the hand-written
kernel (``matmul_gf_cuda`` / ``bmm_gf_cuda``, one launch for a whole batch),
which takes an int32 operand as it lies (any values, any view with a
unit-stride inner axis: it reduces mod p as it loads, so the round's x~ and
its transposed view x~^T pay no ``to_gf`` pass and no copy); other integer
dtypes go through ``to_gf`` first.  A CPU tensor goes to
:func:`matmul_gf_dot`, the JAX package's route off the TPU and the kernel's
plain version, after ``to_gf``:

  * residues are split into four 8-bit limbs and contracted as ONE
    (4m, kc) @ (kc, 4n) float32 GEMM per 256-wide K-chunk (256 * 255^2 <
    2^24, so every float32 partial sum is an exactly representable integer
    in any reduction order), then the limb planes are recombined with
    Mersenne rotations (2^31 === 1);
  * the GEMMs must run in true float32: TF32 (10-bit mantissa) or bf16
    would round the limb products and return wrong residues in silence.
    The JAX package pins ``Precision.HIGHEST``; here the call raises if
    PyTorch is set to allow reduced-precision float32 matmuls.

Residues are exact, so every route returns the same int32 residues — the
tests assert equality across them.

``lagrange_basis_gf`` is plain int64 PyTorch on the device of its inputs
(it is not a Pallas kernel in the JAX package either).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import PLAIN, route

from .kernel import bmm_gf_cuda, kernel_layout, matmul_gf_cuda
from .ref import (FIELD_P, _norm, lagrange_basis_gf_ref, matmul_gf_ref,
                  to_gf)

# K-chunk bound for the float32 limb GEMM: 256 terms of (2^8-1)^2 products
# sum to 16_646_400 < 2^24, the largest integer float32 represents exactly.
_DOT_CHUNK = 256
_LIMBS = 4          # 31 bits as 8+8+8+7


def full_fp32_matmul() -> bool:
    """Do float32 matmuls run in true float32 (no TF32, no bf16)?"""
    try:
        return torch.get_float32_matmul_precision() == "highest"
    except RuntimeError:
        # the per-backend precision API is in use: PyTorch refuses the
        # legacy query, so read the CUDA backend's own setting
        return getattr(torch.backends.cuda.matmul, "fp32_precision", "") == "ieee"


def _limbs_f32(x: torch.Tensor) -> torch.Tensor:
    """(...,) int32 residues -> (4, ...) float32 8-bit limb planes (exact)."""
    return torch.stack([((x >> (8 * i)) & 0xFF).to(torch.float32)
                        for i in range(_LIMBS)])


def matmul_gf_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact mod-p matmul of int32 residues via limb float32 GEMMs.

    (..., m, c) @ (..., c, n) -> (..., m, n) int32 (leading axes batch).
    The 16 limb-pair products are laid out as ONE (4m, kc) @ (kc, 4n) block
    GEMM per K-chunk, then the (i, j) blocks are recombined with Mersenne
    rotations: block (i, j) carries the weight 2^(8(i+j)), and
    2^s === 2^(s mod 31).
    """
    if not full_fp32_matmul():
        raise RuntimeError(
            "matmul_gf_dot needs true float32 GEMMs, but PyTorch allows "
            "reduced precision (TF32/bf16) for float32 matmuls, which would "
            "round the limb products; call torch.set_float32_matmul_precision"
            "('highest') first")
    *lead, m, c = a.shape
    n = b.shape[-1]
    a_l = torch.movedim(_limbs_f32(a), 0, -3).reshape(*lead, _LIMBS * m, c)
    b_l = torch.movedim(_limbs_f32(b), 0, -1).reshape(*lead, c, _LIMBS * n)
    acc = torch.zeros((*lead, m, n), dtype=torch.int64, device=a.device)
    for k0 in range(0, c, _DOT_CHUNK):
        k1 = min(k0 + _DOT_CHUNK, c)
        part = torch.matmul(a_l[..., k0:k1], b_l[..., k0:k1, :])  # exact ints
        part = part.to(torch.int64).reshape(*lead, _LIMBS, m, n, _LIMBS)
        for i in range(_LIMBS):
            for j in range(_LIMBS):
                s = (8 * (i + j)) % 31
                x = part[..., i, :, :, j]                  # < 2^24
                rot = ((x << s) & FIELD_P) + (x >> (31 - s)) if s else x
                acc = _norm(acc + _norm(rot))
    return acc.to(torch.int32)


# Elements of operands the card route passed over before a launch: reduced
# by to_gf (an integer dtype other than int32) or copied contiguous (a view
# with no unit-stride inner axis), and the most in one pass.  The exact
# round's x~ must add to neither.
_CARD_PASSES = {"to_gf": 0, "contiguous": 0, "largest": 0}


def operand_passes() -> dict[str, int]:
    """Elements of card operands reduced by ``to_gf`` or copied contiguous
    before a launch since the last :func:`reset_operand_passes`, and the
    largest operand so passed over."""
    return dict(_CARD_PASSES)


def reset_operand_passes() -> None:
    for name in _CARD_PASSES:
        _CARD_PASSES[name] = 0


def _count_pass(kind: str, elements: int) -> None:
    _CARD_PASSES[kind] += elements
    _CARD_PASSES["largest"] = max(_CARD_PASSES["largest"], elements)


def _card_operand(x) -> torch.Tensor:
    """An operand for the kernel: an int32 tensor as it lies (the kernel
    reduces it as it loads) or, where it cannot read it coalesced, a
    contiguous copy (:func:`kernel_layout`); any other integer dtype
    through :func:`to_gf`."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.int32:
        laid = kernel_layout(x) if x.dim() >= 2 else x
        if laid is not x:
            _count_pass("contiguous", x.numel())
        return laid
    x = to_gf(x)
    _count_pass("to_gf", x.numel())
    return x


def _operands(a, b) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) as their route takes them: on the card (either is a CUDA
    tensor) :func:`_card_operand`, else canonical residues from ``to_gf``."""
    if any(isinstance(x, torch.Tensor) and x.device.type == "cuda" for x in (a, b)):
        return _card_operand(a), _card_operand(b)
    return to_gf(a), to_gf(b)


def matmul_gf(a, b) -> torch.Tensor:
    """Exact (m, c) @ (c, n) mod p.  Any int dtype in, int32 residues out."""
    a, b = _operands(a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_gf: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if route(a) == PLAIN:
        return matmul_gf_dot(a, b)
    return matmul_gf_cuda(a, b)


def bmm_gf(a, b) -> torch.Tensor:
    """Exact batched (..., m, c) @ (..., c, n) mod p.

    Leading axes must match exactly (no broadcasting — the coded-computing
    callers batch over worker chunks, which both operands carry).  On the
    card the whole batch is one kernel launch.  2-D inputs fall through to
    :func:`matmul_gf`.
    """
    a, b = _operands(a, b)
    if a.dim() < 2 or b.dim() < 2 or a.dim() != b.dim():
        raise ValueError(f"bmm_gf: bad ranks {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"bmm_gf: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dim() == 2:
        return matmul_gf(a, b)
    if route(a) == PLAIN:
        return matmul_gf_dot(a, b)
    lead = a.shape[:-2]
    out = bmm_gf_cuda(a.reshape((-1,) + a.shape[-2:]), b.reshape((-1,) + b.shape[-2:]))
    return out.reshape(lead + out.shape[-2:])


def lagrange_basis_gf(eval_pts, nodes) -> torch.Tensor:
    """Batched exact Lagrange basis M[..., e, j] over GF(p).

    ``eval_pts`` (E,), ``nodes`` (..., J) — leading axes of ``nodes`` batch
    over node sets, so a (B, K*) batch of erasure patterns builds all B
    decode matrices in one call, on the device of ``nodes``.
    """
    return lagrange_basis_gf_ref(eval_pts, nodes)


__all__ = [
    "FIELD_P", "bmm_gf", "bmm_gf_cuda", "full_fp32_matmul", "lagrange_basis_gf",
    "matmul_gf", "matmul_gf_cuda", "matmul_gf_dot", "matmul_gf_ref", "operand_passes",
    "reset_operand_passes",
]
