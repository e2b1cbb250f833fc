"""The multi-process entry point: joining a ``torch.distributed`` group.

:func:`init_distributed` joins a group when the ``REPRO_COORDINATOR`` /
``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` environment (or explicit
arguments) describe one, and is a strict no-op at world size 1: a
single-process run never touches ``torch.distributed``, so its behaviour
and bits are the plain path's.  :func:`world` reports ``(rank,
world_size)`` either way.  The sweep executor
(:func:`repro_torch.sweeps.run_multihost`) splits scenario ROWS over the
processes, each on its own device, and carries them back through spool
files, so the group needs no collective: the ``gloo`` backend, on the CPU,
serves as the rendezvous.

Left out of the JAX package's module, by design:

  * ``make_sweep_mesh``, ``make_production_mesh`` and ``make_host_mesh``
    build ``jax.sharding`` meshes; the port's sweep runs one device per
    process, so it has no mesh to build;
  * the TPU v5e roofline constants (``PEAK_FLOPS_BF16``, ``HBM_BW``,
    ``ICI_BW``) describe another chip; no TPU number enters the port.
"""

from __future__ import annotations

import os

_DIST = {"joined": False}


def init_distributed(
    *,
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Join a ``torch.distributed`` group if one is configured; returns
    :func:`world`.

    Configuration comes from the arguments or, when omitted, the
    environment: ``REPRO_COORDINATOR`` (``host:port``, the address rank 0
    listens on), ``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID``.  With no
    coordinator or ``num_processes <= 1`` this is a STRICT no-op returning
    ``(0, 1)``.  Safe to call twice (a joined group is not re-joined).
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

        dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                                world_size=n, rank=pid)
        _DIST["joined"] = True
    return world()


def world() -> tuple[int, int]:
    """``(rank, world_size)`` -- ``(0, 1)`` outside any group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return (dist.get_rank(), dist.get_world_size())
    return (0, 1)


__all__ = ["init_distributed", "world"]
