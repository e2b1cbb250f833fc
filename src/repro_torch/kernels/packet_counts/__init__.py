"""Both decode modes' per-packet counts of the fault engine: plain version
(the mask composition) and the hand-written CUDA kernel
(``csrc/packet_counts.cu``)."""

from .kernel import (launch_counts, packet_counts_cuda, reset_launch_counts,  # noqa: F401
                     vector_width)
from .ops import decode_counts  # noqa: F401
from .ref import packet_counts_ref  # noqa: F401
