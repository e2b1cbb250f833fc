"""Fixed-capacity, mask-padded request queue on the device.

The queue is a NamedTuple of (..., Q) tensors — per-slot load parameters,
absolute deadline, arrival round and a validity (``occupied``) mask — with
any leading batch axes (the serving engine carries (strategies, rows)).
Every operation (admit, EDF ordering, slot recycling) is a handful of
tensor ops with no read back to the host, so the serving loop runs on the
card without a sync.  A free slot is padding: it demands nothing, receives
nothing, and its parameter entries are ignored.

Ordering is EDF with FIFO tie-breaks: earliest absolute deadline first,
ties by arrival round, remaining ties by slot index (two STABLE argsorts,
as ``jnp.argsort`` is in the JAX package; ``torch.argsort`` is stable only
when asked).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

# sort key for empty slots: past any reachable deadline / arrival round
_EMPTY_SLOT_KEY = 2**30


class RequestSpec(NamedTuple):
    """Request parameters (scalars, (rows,) rows or (rounds,) rows).

    Every arrival in round t enters the queue with round t's values:

      * ``kstar`` / ``ell_g`` / ``ell_b`` — the request's own recovery
        threshold and two-level loads (a queue slot is a pool row);
      * ``deadline_rel``     — lifetime in rounds: a request arriving in
        round t is on time iff it completes by round t + deadline_rel;
      * ``admit_threshold``  — admission control: admit only when the
        policy's predicted best-prefix success probability for this spec
        on the full pool is at least this (0.0 = no prediction gate);
      * ``reserve_cap``      — admission control: admit only while the
        summed minimal worker demand of the queue (incl. the newcomer)
        stays within ``reserve_cap * n_valid`` workers (huge = no
        capacity gate).  :data:`ADMIT_ALL_CAP` disables it.
    """

    kstar: object
    ell_g: object
    ell_b: object
    deadline_rel: object = 0
    admit_threshold: object = 0.0
    reserve_cap: object = 2.0**20


# reserve_cap value that disables the capacity gate for any reachable pool
ADMIT_ALL_CAP = 2.0**20


class RequestQueue(NamedTuple):
    """One round's queue state: (..., Q) per-slot tensors, ``occupied`` the mask."""

    occupied: torch.Tensor      # (..., Q) bool — True = live request
    kstar: torch.Tensor         # (..., Q) int32
    ell_g: torch.Tensor         # (..., Q) int32
    ell_b: torch.Tensor         # (..., Q) int32
    deadline_abs: torch.Tensor  # (..., Q) int32 — last on-time completion round
    arrival: torch.Tensor       # (..., Q) int32 — admission round

    @property
    def capacity(self) -> int:
        """The queue capacity Q (a shape)."""
        return self.occupied.shape[-1]


def empty_queue(capacity: int, batch: tuple[int, ...] = (), *, device=None) -> RequestQueue:
    """An all-free queue of ``capacity`` slots with leading axes ``batch``."""
    dev = resolve_device(device)
    shape = tuple(batch) + (capacity,)
    z = lambda: torch.zeros(shape, dtype=torch.int32, device=dev)
    return RequestQueue(occupied=torch.zeros(shape, dtype=torch.bool, device=dev),
                        kstar=z(), ell_g=z(), ell_b=z(), deadline_abs=z(), arrival=z())


def _as_int32(v, dev):
    """A Python int as it is (a kernel argument, no copy to the device), any
    other value an int32 tensor on ``dev``."""
    return v if isinstance(v, int) else torch.as_tensor(v, dtype=torch.int32, device=dev)


def _slot_value(v, dev):
    """:func:`_as_int32`, a tensor gaining the slot axis."""
    v = _as_int32(v, dev)
    return v if isinstance(v, int) else v[..., None]


def admit(queue: RequestQueue, t, count, kstar, ell_g, ell_b, deadline_rel
          ) -> tuple[RequestQueue, torch.Tensor]:
    """Admit up to ``count`` copies of round t's request spec.

    Newcomers fill the lowest-index free slots (slot index never encodes
    priority — ordering is :func:`edf_order`'s job), each stamped with
    ``deadline_abs = t + deadline_rel`` and ``arrival = t``.  ``count`` and
    the spec broadcast against the queue's leading axes.  Returns the
    updated queue and the number actually admitted (``min(count, free
    slots)``); the caller accounts the remainder as rejected.
    """
    dev = queue.occupied.device
    free = ~queue.occupied
    free_i = free.to(torch.int32)
    n_admit = free_i.sum(dim=-1, dtype=torch.int32).clamp(max=_as_int32(count, dev))
    free_rank = torch.cumsum(free_i, dim=-1, dtype=torch.int32) - 1     # rank among free
    take = free & (free_rank < n_admit[..., None])
    stamp = lambda v, old: torch.where(take, _slot_value(v, dev), old)
    return RequestQueue(
        occupied=queue.occupied | take,
        kstar=stamp(kstar, queue.kstar),
        ell_g=stamp(ell_g, queue.ell_g),
        ell_b=stamp(ell_b, queue.ell_b),
        deadline_abs=stamp(_as_int32(deadline_rel, dev) + t, queue.deadline_abs),
        arrival=stamp(t, queue.arrival),
    ), n_admit


def edf_order(queue: RequestQueue) -> torch.Tensor:
    """(..., Q) slot indices, most urgent first (EDF, FIFO + slot tie-breaks).

    Free slots sort last.  Two stable argsorts compose a lexicographic
    (deadline_abs, arrival, slot index) order without wide integer keys.
    """
    arr = torch.where(queue.occupied, queue.arrival, _EMPTY_SLOT_KEY)
    dl = torch.where(queue.occupied, queue.deadline_abs, _EMPTY_SLOT_KEY)
    by_arrival = torch.argsort(arr, dim=-1, stable=True)                 # FIFO, idx ties
    by_deadline = torch.argsort(torch.gather(dl, -1, by_arrival), dim=-1,
                                stable=True)                            # keeps FIFO
    return torch.gather(by_arrival, -1, by_deadline)


def release(queue: RequestQueue, done: torch.Tensor) -> RequestQueue:
    """Recycle ``done`` slots: freed in place, parameters left stale (a free
    slot's entries are padding by convention and never read)."""
    return queue._replace(occupied=queue.occupied & ~done)


__all__ = ["ADMIT_ALL_CAP", "RequestQueue", "RequestSpec", "admit", "edf_order",
           "empty_queue", "release"]
