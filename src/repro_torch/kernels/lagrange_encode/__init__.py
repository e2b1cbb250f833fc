"""Lagrange encode (and same-shaped decode) GEMM: plain version and the
hand-written CUDA kernel (``csrc/lagrange_encode.cu``)."""

from .kernel import (encode_matrix_cuda, encode_route, launch_counts,  # noqa: F401
                     reset_launch_counts)
from .ops import encode, encode_matrix  # noqa: F401
from .ref import encode_matrix_ref, encode_ref  # noqa: F401
