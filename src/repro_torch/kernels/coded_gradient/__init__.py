"""Fused worker-side degree-2 gradient X~^T (X~ W - Y): plain version and
the hand-written CUDA kernel (``csrc/coded_gradient.cu``)."""

from .kernel import (coded_gradient_cuda, gradient_route, launch_counts,  # noqa: F401
                     reset_launch_counts, residual_path, row_plan, shared_residual_limit)
from .ops import coded_gradient  # noqa: F401
from .ref import chunk_gradient_ref, coded_gradient_ref  # noqa: F401
