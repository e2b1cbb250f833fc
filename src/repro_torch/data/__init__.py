"""The synthetic token pipeline with a restorable cursor (``repro/data``)."""

from .pipeline import DataPipeline, PipelineState  # noqa: F401
