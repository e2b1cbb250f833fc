"""Meshes and the multi-process entry point: joining a ``torch.distributed``
group.

:func:`make_production_mesh` is the JAX package's production mesh, (16,
16) ``("data", "model")`` or (2, 16, 16) with a leading ``"pod"`` axis, and
:func:`make_host_mesh` a small mesh over the ranks of the joined group
(tests, examples, the card's ranks); both are ``DeviceMesh`` objects and
need a group of at least their size (the dry run joins a fake one).

:func:`init_distributed` joins a group when the ``REPRO_COORDINATOR`` /
``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` environment (or explicit
arguments) describe one, and is a strict no-op at world size 1: a
single-process run never touches ``torch.distributed``, so its behaviour
and bits are the plain path's.  :func:`world` reports ``(rank,
world_size)`` either way.  The sweep executor
(:func:`repro_torch.sweeps.run_multihost`) splits scenario ROWS over the
processes, each on its own device, and carries them back through spool
files, so the group needs no collective: the ``gloo`` backend, on the CPU,
serves as the rendezvous.  ``init_distributed(backend=)`` takes another.

Left out of the JAX package's module, by design:

  * ``make_sweep_mesh``: the port's sweep runs one device per process, so
    it has no mesh to build;
  * the TPU v5e roofline constants (``PEAK_FLOPS_BF16``, ``HBM_BW``,
    ``ICI_BW``) describe another chip; no TPU number enters the port (the
    dry run's roofline uses the H100's data-sheet numbers,
    ``launch.dryrun``).
"""

from __future__ import annotations

import math
import os

_DIST = {"joined": False}


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device=None):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {have} "
            "(join a group of at least that many first: init_distributed)")
    from repro_torch.device import resolve_device
    from repro_torch.models.sharding import stage_gloo_cuda_all_gather

    dev = resolve_device(device).type
    if dev == "cuda":
        stage_gloo_cuda_all_gather()
    return DeviceMesh(dev, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device=None):
    """Small mesh over the first ``prod(shape)`` ranks of the joined group
    -- tests/examples.  Every rank of the group calls it (it makes the
    axes' sub-groups); it raises when the group is too small.  ``device``
    is the mesh's device type: ``cuda`` unless ``"cpu"`` is asked for.  A
    CUDA mesh over a gloo group stages DTensor's all-gather through the host
    (``models.sharding.stage_gloo_cuda_all_gather``)."""
    return _mesh(tuple(shape), tuple(axes), device)


def init_distributed(
    *,
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "gloo",
) -> tuple[int, int]:
    """Join a ``torch.distributed`` group if one is configured; returns
    :func:`world`.

    Configuration comes from the arguments or, when omitted, the
    environment: ``REPRO_COORDINATOR`` (``host:port``, the address rank 0
    listens on), ``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID``.  With no
    coordinator or ``num_processes <= 1`` this is a STRICT no-op returning
    ``(0, 1)``.  Safe to call twice (a joined group is not re-joined).
    ``backend`` is the group's (``gloo`` by default; ``nccl`` for one GPU a
    rank).
    """
    coord = coordinator if coordinator is not None else os.environ.get(
        "REPRO_COORDINATOR")
    n = num_processes if num_processes is not None else int(
        os.environ.get("REPRO_NUM_PROCESSES", "1"))
    if not coord or n <= 1:
        return (0, 1)
    pid = process_id if process_id is not None else int(
        os.environ.get("REPRO_PROCESS_ID", "0"))
    if not _DIST["joined"]:
        import torch.distributed as dist

        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                world_size=n, rank=pid)
        _DIST["joined"] = True
    return world()


def world() -> tuple[int, int]:
    """``(rank, world_size)`` -- ``(0, 1)`` outside any group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return (dist.get_rank(), dist.get_world_size())
    return (0, 1)


__all__ = ["init_distributed", "make_host_mesh", "make_production_mesh", "world"]
