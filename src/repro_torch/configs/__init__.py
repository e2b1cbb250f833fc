"""The port's configs: the paper's own workloads (``paper_lea``) and the
language-model architectures it holds (``base.list_configs()``), copied from
the JAX package."""

from .base import (ArchConfig, SHAPE_CELLS, ShapeCell, get_config,  # noqa: F401
                   get_smoke_config, list_configs)
