"""Exact GF(2^31 - 1) linear algebra: field primitives, the plain limb GEMM
route and the hand-written CUDA matmul kernel (``csrc/gf_matmul.cu``).

The names of the JAX package's ``repro.kernels.gf``, with ``matmul_gf_cuda``
and ``bmm_gf_cuda`` in the place of ``matmul_gf_pallas``.
"""

from .kernel import launch_counts, reset_launch_counts  # noqa: F401
from .ops import (  # noqa: F401
    FIELD_P,
    bmm_gf,
    bmm_gf_cuda,
    full_fp32_matmul,
    lagrange_basis_gf,
    matmul_gf,
    matmul_gf_cuda,
    matmul_gf_dot,
    matmul_gf_ref,
    operand_passes,
    reset_operand_passes,
)
from .ref import (  # noqa: F401
    add_gf,
    canonical_i32,
    from_gf,
    inv_gf,
    lagrange_basis_gf_ref,
    mul_gf,
    sub_gf,
    to_gf,
)

__all__ = [
    "FIELD_P", "add_gf", "bmm_gf", "bmm_gf_cuda", "canonical_i32", "from_gf", "full_fp32_matmul", "inv_gf",
    "lagrange_basis_gf", "lagrange_basis_gf_ref", "launch_counts",
    "matmul_gf", "matmul_gf_cuda", "matmul_gf_dot", "matmul_gf_ref", "mul_gf",
    "operand_passes", "reset_launch_counts", "reset_operand_passes", "sub_gf", "to_gf",
]
