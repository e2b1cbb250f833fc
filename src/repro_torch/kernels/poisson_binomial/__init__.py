from .kernel import (ALLOCATE_MAX_N, allocate_masked_cuda,  # noqa: F401
                     launch_counts, reset_launch_counts, threshold_geometry)
from .ops import (  # noqa: F401
    success_tails,
    success_tails_cuda,
    success_tails_cuda_w,
    success_tails_ref,
)
