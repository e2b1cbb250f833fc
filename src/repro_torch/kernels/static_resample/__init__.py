"""The static strategies' rejection resampler, one try at a time: plain
version and the hand-written CUDA kernel (``csrc/static_resample.cu``)."""

from .kernel import StaticResampleCuda, launch_counts, reset_launch_counts  # noqa: F401
from .ops import count_try, engagement, reset_engagement, static_resampler  # noqa: F401
from .ref import StaticResampleRef  # noqa: F401
