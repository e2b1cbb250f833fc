"""Deterministic synthetic token pipeline with a restorable cursor
(``repro/data/pipeline.py``), a copy of the JAX package's numpy code.

Each host materialises only its shard of the global batch (host-sharded
loading); the cursor (step, seed) lives in the checkpoint, so restarts are
sample-exact.  The corpus is a seeded Zipf-ish integer stream.  Every row
comes from numpy's ``default_rng`` seeded by (seed, step, host, row), so the
tokens are bit-equal to the JAX package's for the same arguments.

The stub frontends' float inputs (JAX's ``extra_specs``) are not ported:
JAX seeds them with Python's salted ``hash(name)``, which differs between
processes unless ``PYTHONHASHSEED`` is set.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PipelineState:
    step: int = 0
    seed: int = 0

    def to_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineState":
        return cls(step=int(d["step"]), seed=int(d["seed"]))


class DataPipeline:
    """Yields ``{"tokens": (global_batch / host_count, seq)}`` int32 numpy
    batches, deterministically; ``host_id`` / ``host_count`` carve the global
    batch so each host touches only its rows."""

    def __init__(self, vocab_size: int, global_batch: int, seq_len: int,
                 *, seed: int = 0, host_id: int = 0, host_count: int = 1,
                 extra_specs: dict | None = None):
        if global_batch % host_count:
            raise ValueError(f"global batch {global_batch} does not split over "
                             f"{host_count} hosts")
        if extra_specs:
            raise NotImplementedError(
                "extra_specs (the stub frontends' inputs) are not ported yet")
        self.vocab = vocab_size
        self.global_batch = global_batch
        self.seq = seq_len
        self.host_id = host_id
        self.host_count = host_count
        self.state = PipelineState(seed=seed)

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.host_count

    def _batch_at(self, step: int) -> dict[str, np.ndarray]:
        rows = []
        base = step * self.global_batch + self.host_id * self.host_batch
        for r in range(self.host_batch):
            rng = np.random.default_rng(self.state.seed * 1_000_003 + base + r)
            # Zipf-ish marginal over the vocab: realistic embedding access skew
            z = rng.zipf(1.3, size=self.seq).astype(np.int64)
            rows.append((z % self.vocab).astype(np.int32))
        return {"tokens": np.stack(rows)}

    def next(self) -> dict[str, np.ndarray]:
        batch = self._batch_at(self.state.step)
        self.state.step += 1
        return batch

    def restore(self, state: PipelineState | dict) -> None:
        self.state = state if isinstance(state, PipelineState) else PipelineState.from_dict(state)


__all__ = ["DataPipeline", "PipelineState"]
