"""Causal / sliding-window GQA flash attention (forward): the plain
versions and the hand-written CUDA kernel (``csrc/flash_attention.cu``)."""

from .kernel import (flash_attention_cuda, flash_route, head_dim_instance,  # noqa: F401
                     launch_counts, reset_launch_counts, tma_geometry)
from .ops import flash_attention  # noqa: F401
from .ref import attention_ref, flash_attention_ref  # noqa: F401
