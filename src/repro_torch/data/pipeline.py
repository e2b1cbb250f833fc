"""Deterministic synthetic token pipeline with a restorable cursor
(``repro/data/pipeline.py``), a copy of the JAX package's numpy code.

Each host materialises only its shard of the global batch (host-sharded
loading); the cursor (step, seed) lives in the checkpoint, so restarts are
sample-exact.  The corpus is a seeded Zipf-ish integer stream.  Every row
comes from numpy's ``default_rng`` seeded by (seed, step, host, row), so the
tokens are bit-equal to the JAX package's for the same arguments.

The stub frontends' float inputs (``extra_specs``: ``frames``, ``patches``)
are standard normal float32, one stream a name and step, seeded as JAX
seeds them, with Python's ``hash(name)``.  That hash is salted per process
unless ``PYTHONHASHSEED`` is set, so, as in JAX, these inputs are bit-equal
to the JAX package's within one process and differ between processes.
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
    batch so each host touches only its rows.

    ``extra_specs`` maps a name to anything with a ``.shape`` (the meta
    tensors of ``models.api.input_specs``); each batch then also holds that
    name as float32 (host batch, ``*shape[1:]``), standard normal (see the
    module's note on its seed)."""

    def __init__(self, vocab_size: int, global_batch: int, seq_len: int,
                 *, seed: int = 0, host_id: int = 0, host_count: int = 1,
                 extra_specs: dict | None = None):
        if global_batch % host_count:
            raise ValueError(f"global batch {global_batch} does not split over "
                             f"{host_count} hosts")
        self.vocab = vocab_size
        self.global_batch = global_batch
        self.seq = seq_len
        self.host_id = host_id
        self.host_count = host_count
        self.state = PipelineState(seed=seed)
        self.extra_specs = extra_specs or {}

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
        out = {"tokens": np.stack(rows)}
        for name, sd in self.extra_specs.items():
            rng = np.random.default_rng(self.state.seed * 7_000_003 + base + hash(name) % 1000)
            shape = (self.host_batch,) + tuple(sd.shape[1:])
            out[name] = rng.standard_normal(shape).astype(np.float32)
        return out

    def next(self) -> dict[str, np.ndarray]:
        batch = self._batch_at(self.state.step)
        self.state.step += 1
        return batch

    def restore(self, state: PipelineState | dict) -> None:
        self.state = state if isinstance(state, PipelineState) else PipelineState.from_dict(state)


__all__ = ["DataPipeline", "PipelineState"]
