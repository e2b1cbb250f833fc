"""GPipe-style pipeline parallelism over a mesh axis
(``repro/runtime/pipeline_parallel.py``), on ``torch.distributed``.

Fill-drain schedule: with S stages and M microbatches the loop runs
M + S - 1 ticks; stage s computes microbatch t-s at tick t and forwards its
activation to stage s+1 (JAX's ``ppermute``: a send and a receive between
neighbours, :func:`repro_torch.models.sharding.send_recv`).  Used on the
``pod`` axis when ``pipeline_stages > 1`` -- the cross-pod link then carries
one activation per tick instead of a full gradient all-reduce.

The paper's LEA layer composes: each *stage group* is a worker in the
Markov model, and the allocator decides microbatch counts per group.
"""

from __future__ import annotations

import torch

from repro_torch.models import sharding


def _stage_slice(leaf: torch.Tensor, stage: int) -> torch.Tensor:
    """Stage ``stage``'s parameters: the rank's own (1, ...) piece of a
    DTensor sharded over the stage axis, or row ``stage`` of a full
    (S, ...) tensor."""
    if sharding.is_dtensor(leaf):
        return leaf.to_local()[0]
    return leaf[stage]


def pipeline_forward(stage_fn, stage_params: dict, x_microbatches: torch.Tensor, mesh,
                     axis: str = "pod") -> torch.Tensor:
    """Run ``stage_fn(params_s, x) -> x`` over S pipeline stages.

    stage_params: dict of (S, ...) tensors -- full on every rank, or
                  DTensors sharded over ``axis``; rank s uses stage s's
    x_microbatches: (M, mb, ...)            -- the same on every rank
    Returns (M, mb, ...) final-stage outputs on every rank: stage s runs
    microbatch t - s at tick t (only ticks where 0 <= t - s < M; JAX also
    runs the bubbles and discards them), sends it to stage s + 1, and the
    last stage's buffer is replicated with a masked SUM all-reduce.
    """
    s_count = sharding.mesh_size(mesh, axis)
    m_count = x_microbatches.shape[0]
    stage = sharding.axis_index(mesh, axis)
    params_local = {name: _stage_slice(leaf, stage) for name, leaf in stage_params.items()}
    outbuf = torch.zeros_like(x_microbatches)
    recv = torch.empty_like(x_microbatches[0])
    for t in range(m_count + s_count - 1):
        mb = t - stage
        if not 0 <= mb < m_count:
            continue
        if stage > 0:
            sharding.send_recv(None, None, recv, stage - 1, mesh, axis)
        inp = x_microbatches[mb] if stage == 0 else recv
        out = stage_fn(params_local, inp)
        if stage < s_count - 1:
            sharding.send_recv(out, stage + 1, None, None, mesh, axis)
        else:
            outbuf[mb] = out
    # replicate the last stage's buffer to every stage (masked psum)
    mask = float(stage == s_count - 1)
    return sharding.all_reduce(outbuf * mask, "sum", mesh, axis)


def reference_forward(stage_fn, stage_params: dict, x_microbatches: torch.Tensor) -> torch.Tensor:
    """Sequential oracle for tests: apply all stages to every microbatch."""
    s_count = next(iter(stage_params.values())).shape[0]

    def apply_all(x):
        for s in range(s_count):
            x = stage_fn({name: leaf[s] for name, leaf in stage_params.items()}, x)
        return x

    return torch.stack([apply_all(x) for x in x_microbatches])


__all__ = ["pipeline_forward", "reference_forward"]
