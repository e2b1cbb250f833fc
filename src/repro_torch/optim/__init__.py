"""AdamW and its learning-rate schedule (``repro/optim``), in plain PyTorch."""

from .adamw import TrainState, adamw_init, adamw_update, global_norm  # noqa: F401
from .schedule import cosine_warmup  # noqa: F401
