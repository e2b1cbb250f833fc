"""Atomic, async checkpointing with resume (``repro/checkpoint``)."""

from .ckpt import CheckpointManager, latest_step, restore, save  # noqa: F401
