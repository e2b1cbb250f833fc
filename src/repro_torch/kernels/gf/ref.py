"""GF(p) field primitives and plain reference implementations, p = 2^31 - 1.

The arithmetic core of the exact coded-computing path, and the oracle the
CUDA kernel (``kernel.py``) is held against.  The JAX package builds every
product from 16-bit limbs because it runs without 64-bit integers; PyTorch
has int64 on every device, so here:

  * canonical residues in [0, p) are stored as **int32** (every residue is
    below 2^31; PyTorch's ``uint32`` supports few operators).  Where the JAX
    package returns uint32, these functions return int32 holding the same
    values;
  * arithmetic runs in **int64**, where the product of two residues
    (< 2^62) fits, and is reduced with the Mersenne identity
    2^31 === 1 (mod p).

Residues are exact, so every correct implementation (numpy int64, the
JAX package's limb arithmetic, the limb GEMM route, the CUDA kernel) gives
the same integers; the tests assert equality, not closeness.

Reference entry points:

  * :func:`matmul_gf_ref`         — (m, c) @ (c, n) mod p, blocks of folded
                                    int64 products summed exactly
  * :func:`lagrange_basis_gf_ref` — batched Lagrange basis matrices over
                                    GF(p), Fermat inversion of the
                                    denominators
"""

from __future__ import annotations

import numpy as np
import torch

# Mersenne prime 2^31 - 1 (shared with repro_torch.core.lagrange.FIELD_P).
FIELD_P = (1 << 31) - 1
_MASK31 = FIELD_P

# Contraction terms per block of matmul_gf_ref: a (m, 64, n) int64 block.
_REF_CHUNK = 64


def _i64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2p) -> [0, p), int64."""
    return torch.where(x >= _MASK31, x - _MASK31, x)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """One Mersenne fold of a non-negative int64: hi * 2^31 + lo -> hi + lo."""
    return (x & _MASK31) + (x >> 31)


def norm31(x) -> torch.Tensor:
    """One conditional subtract: [0, 2p) -> [0, p).  int32 out."""
    return _norm(_i64(x)).to(torch.int32)


def fold31(x) -> torch.Tensor:
    """Exact mod-p reduction of any non-negative integer below 2^62.

    2^31 === 1 (mod p), so x = hi * 2^31 + lo === hi + lo.  Two folds bring
    any value below 2^62 under 2^31 + 2, and one :func:`norm31` makes it
    canonical.  Covers every uint32 the JAX package's ``fold31`` takes.
    """
    return _norm(_fold(_fold(_i64(x)))).to(torch.int32)


def to_gf(x) -> torch.Tensor:
    """Any integer array-like -> canonical int32 residues in [0, p).

    Signed values may be negative (the Python-sign remainder maps them into
    [0, p)); unsigned values are reduced the same way.  Floats and bools
    raise ``TypeError``, as in the JAX package.
    """
    if isinstance(x, np.ndarray) or not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        if arr.dtype.kind not in "iu":
            raise TypeError(f"GF(p) arrays must be integer-typed, got {arr.dtype}")
        x = torch.from_numpy(arr.astype(np.int64))
    elif x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool:
        raise TypeError(f"GF(p) arrays must be integer-typed, got {x.dtype}")
    return torch.remainder(x.to(torch.int64), FIELD_P).to(torch.int32)


def canonical_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 v -> v mod p in [0, p), int32: :func:`to_gf` without int64.

    The plain mirror of the CUDA kernel's loaders (``canonical`` in
    ``kernels/csrc/gf_matmul.cu``): v = hi 2^31 + lo with lo = v & p and
    hi = v >> 31 in {0, -1}; 2^31 = 1 (mod p), so v = lo + hi (mod p), a
    value in [-1, p].  Only v = -2^31 gives -1 (+ p) and only v = p gives
    p (- p).
    """
    if x.dtype != torch.int32:
        raise TypeError(f"canonical_i32 takes int32, got {x.dtype}")
    s = (x & FIELD_P) + (x >> 31)
    s = torch.where(s < 0, s + FIELD_P, s)
    return torch.where(s >= FIELD_P, s - FIELD_P, s)


def from_gf(x: torch.Tensor) -> torch.Tensor:
    """Canonical residues -> int32 (values < p < 2^31 always fit)."""
    return x.to(torch.int32)


def add_gf(a, b) -> torch.Tensor:
    """(a + b) mod p for canonical residues (sum < 2p: one norm)."""
    return _norm(_i64(a) + _i64(b)).to(torch.int32)


def sub_gf(a, b) -> torch.Tensor:
    """(a - b) mod p for canonical residues (a + (p - b) < 2p)."""
    return _norm(_i64(a) + (_MASK31 - _i64(b))).to(torch.int32)


def _mul64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int64 residues (< 2^31) -> int64 canonical (a * b) mod p.

    One remainder of the product (< 2^62): two launches on the card, where
    the decode-matrix build is a chain of hundreds of these small products.
    """
    return torch.remainder(a * b, FIELD_P)


def mul_gf(a, b) -> torch.Tensor:
    """(a * b) mod p for any a, b < 2^31 (canonical residues and p itself).

    The int64 product is below 2^62, reduced once into [0, p).
    """
    return _mul64(_i64(a), _i64(b)).to(torch.int32)


def rot_gf(x, s: int) -> torch.Tensor:
    """(x * 2^s) mod p for x < 2^31 — a rotate within the low 31 bits.

    ``s`` is a Python int (reduced mod 31, since 2^31 === 1).
    """
    s = int(s) % 31
    x = _i64(x)
    if s == 0:
        return _norm(x).to(torch.int32)
    lo_bits = 31 - s
    hi = x >> lo_bits
    lo = (x & ((1 << lo_bits) - 1)) << s
    return _norm(lo + hi).to(torch.int32)


def _inv64(a: torch.Tensor) -> torch.Tensor:
    """int64 residues -> int64 a^(p-2) mod p (square-and-multiply)."""
    e = FIELD_P - 2
    result = torch.ones_like(a)
    base = a
    for bit in range(31):
        if (e >> bit) & 1:
            result = _mul64(result, base)
        if bit != 30:
            base = _mul64(base, base)
    return result


def inv_gf(a) -> torch.Tensor:
    """Modular inverse via Fermat: a^(p-2) mod p; inv_gf(0) = 0 (callers
    guarantee nonzero denominators — distinct interpolation nodes)."""
    return _inv64(_i64(a)).to(torch.int32)


# ---------------------------------------------------------------------------
# plain reference implementations
# ---------------------------------------------------------------------------

def matmul_gf_ref(a, b) -> torch.Tensor:
    """Exact (m, c) @ (c, n) mod p — the oracle of the CUDA kernel.

    Each product is folded once below 2^32 and blocks of folded terms are
    summed in int64 (exact below 2^31 terms); one fold-and-norm at the end.
    Inputs any int dtype; output int32 canonical residues.
    """
    a = to_gf(a)
    b = to_gf(b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_gf: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    m, c = a.shape
    acc = torch.zeros((m, b.shape[1]), dtype=torch.int64, device=a.device)
    for k0 in range(0, c, _REF_CHUNK):
        k1 = min(k0 + _REF_CHUNK, c)
        terms = a64[:, k0:k1, None] * b64[None, k0:k1, :]     # (m, kc, n) < 2^62
        acc = _norm(_fold(_fold(acc + _fold(terms).sum(dim=1))))
    return acc.to(torch.int32)


def _prod_gf(x: torch.Tensor) -> torch.Tensor:
    """int64 product over the last axis mod p, as a pairwise tree (exact,
    so the order is free); an empty axis gives 1."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
        x = _mul64(x[..., 0::2], x[..., 1::2])
    if x.shape[-1] == 0:
        return torch.ones(x.shape[:-1], dtype=torch.int64, device=x.device)
    return x[..., 0]


def lagrange_basis_gf_ref(eval_pts, nodes) -> torch.Tensor:
    """Batched exact Lagrange basis: M[..., e, j] = prod_{l != j}
    (x_e - u_l) / (u_j - u_l) over GF(p).

    ``eval_pts`` is (E,); ``nodes`` is (..., J) — leading axes batch over
    node sets (erasure patterns).  Division is Fermat inversion of the
    (..., J) denominator products.  Runs on the device of ``nodes``; equal
    to the numpy host oracle (``core.lagrange._lagrange_basis_modp``) by
    exactness.
    """
    u = to_gf(nodes).to(torch.int64)                        # (..., J)
    x = to_gf(eval_pts).to(u.device, torch.int64)           # (E,)
    if x.dim() != 1:
        raise ValueError(f"eval_pts must be 1-D, got {tuple(x.shape)}")
    j_count = u.shape[-1]
    eye = torch.eye(j_count, dtype=torch.bool, device=u.device)
    diff = _norm(x[:, None] + (_MASK31 - u[..., None, :]))  # (..., E, J) over l
    # num[..., e, j] = prod_{l != j} diff[..., e, l]: a (..., E, J, J) table
    # with the diagonal set to 1, multiplied out over l
    table = diff[..., :, None, :].expand(*diff.shape[:-1], j_count, j_count)
    num = _prod_gf(torch.where(eye, 1, table))              # (..., E, J)
    pair = _norm(u[..., :, None] + (_MASK31 - u[..., None, :]))   # (..., J, J)
    den = _prod_gf(torch.where(eye, 1, pair))               # (..., J)
    return _mul64(num, _inv64(den)[..., None, :]).to(torch.int32)


__all__ = [
    "FIELD_P", "add_gf", "canonical_i32", "fold31", "from_gf", "inv_gf", "lagrange_basis_gf_ref",
    "matmul_gf_ref", "mul_gf", "norm31", "rot_gf", "sub_gf", "to_gf",
]
