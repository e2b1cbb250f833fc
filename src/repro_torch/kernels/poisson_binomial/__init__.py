from .kernel import launch_counts, reset_launch_counts  # noqa: F401
from .ops import (  # noqa: F401
    success_tails,
    success_tails_cuda,
    success_tails_cuda_w,
    success_tails_ref,
)
