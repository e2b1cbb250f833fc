"""In-run telemetry taps: block aggregates delivered to the host mid-run.

The ``telemetry=`` flag returns per-round streams *with* the result; the
``tap=`` flag (a sibling, threaded through the same engines) instead
delivers BLOCK AGGREGATES — rounds done, timely throughput so far,
estimator error so far, queue admissions, fault counts — to registered
host handlers DURING the run: at every ``round_chunk`` block boundary of
the chunked engine, at ``tap_stride`` boundaries of the serving loop
(which the engine runs segment by segment), and at ``tap_stride``
boundaries of the one-pass engines (the unchunked engine, the fault
sweep), whose aggregates are prefix sums of their per-round streams.

Where the JAX package traces ``io_callback`` into its computations, the
port's engines are host loops over device tensors, so :func:`emit` is a
plain host call: at a boundary the engine copies that boundary's block
aggregates to the host ONCE (:func:`to_host`, one device-to-host copy and
so one sync) and delivers one event per row (and per strategy for
serving), before it enqueues the next segment's work.

Contract (as in the JAX package):

  * ``tap=False`` (the default) is the pre-existing code path: the same
    outputs, no copy, no event;
  * ``tap=True`` leaves the primary outputs bit-identical (events are read
    from the same tensors);
  * events arrive IN ORDER per (engine, row, strategy).

Event schema: each event is a flat dict with ``engine`` (one of
:data:`TAP_ENGINES`), ``host_time`` (``time.perf_counter()`` at delivery)
and the engine's streams from :data:`EVENT_STREAMS` — numpy scalars or
small per-strategy vectors.  Batched engines add ``row`` (the batch index,
-1 for unbatched calls); serving adds ``strategy``.

Handlers are looked up at delivery time, so a handler registered between
two calls receives the second call's events.  A handler that raises is
dropped from that event, never the run — the never-raise convention of
``repro_torch.obs``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

Handler = Callable[[dict], None]

# engine identifiers stamped into every event
TAP_ENGINES = ("engine.pool", "faults.sweep", "serving")

# per-engine payload streams (beyond the common engine/block/row/host_time);
# the catalogue validate_event checks against
EVENT_STREAMS: dict[str, tuple[str, ...]] = {
    "engine.pool": (
        "rounds_done", "succ_so_far", "throughput_so_far", "est_err_so_far",
    ),
    "faults.sweep": (
        "rounds_done", "recovered_aon_so_far", "recovered_conserve_so_far",
        "partial_so_far", "preempted_so_far", "packets_lost_so_far",
    ),
    "serving": (
        "rounds_done", "admitted_so_far", "served_on_time_so_far",
        "served_late_so_far", "rejected_so_far", "expired_so_far",
        "occupancy", "strategy",
    ),
}

_COMMON_KEYS = ("engine", "block", "row", "host_time")

_HANDLERS: dict[str, Handler] = {}
_LOCK = threading.Lock()


def add_tap(name: str, handler: Handler) -> None:
    """Register (or replace) a tap handler under ``name``.

    The handler receives one dict per event (see module docstring) on the
    thread that runs the engine, so it should be quick.
    """
    if not callable(handler):
        raise TypeError(f"tap handler {name!r} is not callable: {handler!r}")
    with _LOCK:
        _HANDLERS[name] = handler


def remove_tap(name: str) -> None:
    """Unregister a handler; unknown names are a no-op (teardown-safe)."""
    with _LOCK:
        _HANDLERS.pop(name, None)


def tap_names() -> tuple[str, ...]:
    """Registered handler names, sorted."""
    with _LOCK:
        return tuple(sorted(_HANDLERS))


@contextlib.contextmanager
def capture_taps() -> Iterator[list[dict]]:
    """Collect every tap event delivered inside the block into the yielded
    list.  Delivery is synchronous, so the list holds exactly the block's
    events::

        with obs.capture_taps() as events:
            run_group(group, tap=True)
        assert events and events[-1]["rounds_done"] == rounds
    """
    events: list[dict] = []
    name = f"_capture_{id(events)}"
    add_tap(name, events.append)
    try:
        yield events
    finally:
        remove_tap(name)


def _dispatch(event: dict[str, Any]) -> None:
    with _LOCK:
        handlers = list(_HANDLERS.values())
    for handler in handlers:
        try:
            handler(dict(event))
        except Exception:  # never-raise: a broken sink must not kill the run
            pass


def emit(engine: str, **streams) -> None:
    """Deliver one event of host values to every registered handler."""
    event: dict[str, Any] = {"engine": engine, "host_time": time.perf_counter()}
    for k, v in streams.items():
        a = np.asarray(v)
        event[k] = a[()] if a.ndim == 0 else a
    _dispatch(event)


def emit_rows(engine: str, **streams) -> None:
    """One :func:`emit` per leading index of the host arrays ``streams``
    (all of one leading length), in index order."""
    arrays = {k: np.asarray(v) for k, v in streams.items()}
    lengths = {a.shape[0] for a in arrays.values()}
    if len(lengths) != 1:
        raise ValueError(f"tap streams disagree on their leading length: {lengths}")
    for i in range(lengths.pop()):
        emit(engine, **{k: a[i] for k, a in arrays.items()})


def pack_words(*tensors: torch.Tensor) -> tuple[torch.Tensor, list]:
    """int32 / float32 / bool tensors of one device bit-cast to int32 words
    and joined into one (W,) int32 tensor on that device, with the layout
    :func:`unpack_words` splits it by (bool travels as int32)."""
    words, layout = [], []
    for t in tensors:
        dtype = t.dtype
        w = t.to(torch.int32) if dtype == torch.bool else t
        if w.dtype not in (torch.int32, torch.float32):
            raise TypeError(f"to_host takes int32, float32 or bool tensors, not {dtype}")
        words.append(w.contiguous().view(torch.int32).reshape(-1))
        layout.append((tuple(t.shape), dtype))
    flat = torch.cat(words) if words else torch.zeros(0, dtype=torch.int32)
    return flat, layout


def unpack_words(flat: np.ndarray, layout: list) -> list[np.ndarray]:
    """The numpy arrays a host copy of :func:`pack_words`' words holds."""
    out, at = [], 0
    for shape, dtype in layout:
        size = int(np.prod(shape, dtype=np.int64))
        chunk = flat[at:at + size].reshape(shape)
        at += size
        if dtype == torch.float32:
            chunk = chunk.view(np.float32)
        elif dtype == torch.bool:
            chunk = chunk.astype(bool)
        out.append(chunk)
    return out


def to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Numpy copies of int32 / float32 / bool tensors of one device in ONE
    device-to-host copy: each is bit-cast to int32 words, the words are
    joined, copied and split (bool comes back as bool)."""
    flat, layout = pack_words(*tensors)
    return unpack_words(flat.cpu().numpy(), layout)


def prefix_sums_at(tap_stride: int | None, *streams: torch.Tensor):
    """``(boundaries, host arrays)``: each (B, M, ...) stream's prefix sums
    over the M rounds at the ``tap_stride`` boundaries, (B, len(boundaries),
    ...), in one device-to-host copy — the block aggregates of an engine
    that computes every round in one pass.  Integer and bool streams sum in
    int32, float streams in float32."""
    rounds = streams[0].shape[1]
    bounds = stride_boundaries(rounds, resolve_stride(rounds, tap_stride))
    at = torch.tensor([b - 1 for b in bounds], device=streams[0].device)
    sums = [(x.cumsum(dim=1) if x.is_floating_point()
             else x.to(torch.int32).cumsum(dim=1, dtype=torch.int32))[:, at] for x in streams]
    return bounds, to_host(*sums)


def validate_event(event: dict) -> None:
    """Raise ``ValueError`` unless ``event`` matches the tap schema.

    Checks the common keys, the engine id, the engine's exact stream set
    and the monotonicity preconditions a single event can carry
    (``rounds_done`` positive, ``block`` non-negative).
    """
    missing = [k for k in _COMMON_KEYS if k not in event]
    if missing:
        raise ValueError(f"tap event missing common keys {missing}: {sorted(event)}")
    engine = event["engine"]
    if engine not in EVENT_STREAMS:
        raise ValueError(f"unknown tap engine {engine!r}; known: {TAP_ENGINES}")
    want = set(EVENT_STREAMS[engine])
    got = set(event) - set(_COMMON_KEYS)
    if got != want:
        raise ValueError(
            f"{engine} event streams mismatch: missing {sorted(want - got)}, "
            f"unexpected {sorted(got - want)}"
        )
    if int(np.asarray(event["rounds_done"])) <= 0:
        raise ValueError(f"rounds_done must be positive: {event['rounds_done']}")
    if int(np.asarray(event["block"])) < 0:
        raise ValueError(f"block must be non-negative: {event['block']}")


def resolve_stride(rounds: int, tap_stride: int | None) -> int:
    """The emission stride of an engine without blocks of its own.

    ``None`` means one final aggregate at round M (the cheapest honest
    default); an explicit positive stride emits at every multiple (and
    always at M).  Validated here so every engine rejects bad strides the
    same way.
    """
    if tap_stride is None:
        return rounds
    if tap_stride <= 0:
        raise ValueError(f"tap_stride must be positive, got {tap_stride}")
    return min(tap_stride, rounds)


def stride_boundaries(rounds: int, stride: int) -> tuple[int, ...]:
    """Emission boundaries: stride, 2*stride, ..., and always M."""
    bounds = list(range(stride, rounds + 1, stride))
    if not bounds or bounds[-1] != rounds:
        bounds.append(rounds)
    return tuple(bounds)
