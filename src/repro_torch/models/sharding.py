"""Sharding on ``torch.distributed`` (``repro/models/sharding.py``): the
mesh context, the logical axis names, activation constraints and the
per-rank pieces of a sharded tensor.

JAX's vocabulary maps onto PyTorch's own:

  * a ``Mesh`` with axis names is a ``DeviceMesh`` with ``mesh_dim_names``
    ``("data", "model")`` or ``("pod", "data", "model")``;
  * a ``PartitionSpec`` is :func:`resolve`'s tuple of mesh-axis names per
    tensor dimension (an entry may name several axes), and a
    ``NamedSharding`` is :class:`NamedSharding`: a mesh and such a spec,
    whose :attr:`~NamedSharding.placements` are the DTensor placements
    (``Shard(d)`` / ``Replicate()``), one per mesh dimension;
  * ``jax.device_put(x, sharding)`` is :func:`distribute` (each rank keeps
    its own slice: no communication), ``with_sharding_constraint`` is
    :func:`shard` (a DTensor ``redistribute``), and ``shard_map``'s body is
    plain code on :func:`local` tensors with :func:`all_reduce` over a mesh
    axis (``psum`` / ``pmax``).

The model code calls :func:`shard` at JAX's points with logical names;
outside a mesh (one card, the CPU tests) it returns its input, so every
single-card path is unchanged.  Inside :func:`use_mesh` the model's tensors
are DTensors and plain tensors it makes (positions, masks) count as
replicated (``implicit_replication``).

Logical names: ``dp`` -- the batch axis (``("pod", "data")`` or
``"data"``), ``tp`` -- the tensor axis (``"model"``), ``fsdp`` -- the
parameter shard axis (``"data"``).

Gloo and CUDA tensors: gloo takes CUDA tensors for all-reduce,
reduce-scatter, all-to-all and the non-functional all-gather, but on the
H100 machine's PyTorch (2.11) send / recv fail ("writev: Bad address") and
the functional all-gather that DTensor issues
(``_c10d_functional.all_gather_into_tensor``) kills the process; phase 19 of
``chip_smoke.py`` probes each.  Those two, named in
:data:`GLOO_HOST_STAGED`, are staged through the host: :func:`send_recv`
copies its tensors, and :func:`stage_gloo_cuda_all_gather` (called by
``launch.mesh.make_host_mesh`` for a CUDA mesh over a gloo group) puts a
CUDA kernel for the functional all-gather in place that gathers a host
copy and copies the result back.  :func:`staged_bytes` counts the bytes so
staged.  The compute stays on the device; nothing else changes device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, NamedTuple

import torch

_state = threading.local()

# Collectives that gloo refuses on CUDA tensors, staged through the host by
# :func:`all_reduce` / :func:`send_recv` (the H100 probe of phase 19 says
# which; PERF.md records it).
GLOO_HOST_STAGED: set[str] = {"send_recv", "all_gather"}
_STAGED = {"bytes": 0, "all_gather_lib": None}


class MeshShape(NamedTuple):
    """A mesh's shape and axis names with no process group behind it: the
    sharding rules are pure functions of these two (``DeviceMesh`` has the
    same two attributes)."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def _current() -> tuple[Any, dict[str, Any]]:
    return getattr(_state, "mesh", None), getattr(_state, "axes", {})


def active_mesh():
    """The mesh of the innermost :func:`use_mesh`, or ``None``."""
    return _current()[0]


def _is_device_mesh(mesh) -> bool:
    return mesh is not None and not isinstance(mesh, MeshShape)


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate a mesh for activation-sharding constraints.

    Logical-axis resolution: ``dp`` -> ("pod","data") when a 'pod' axis
    exists else "data"; ``tp`` -> "model"; ``fsdp`` -> "data".  A
    ``DeviceMesh`` also turns on DTensor's implicit replication for the
    block: plain tensors mixed with DTensors count as replicated (once: a
    nested ``use_mesh`` leaves it to the outer one).
    """
    prev = _current()
    if mesh is None:
        _state.mesh, _state.axes = None, {}
    else:
        names = mesh.mesh_dim_names
        _state.mesh, _state.axes = mesh, {
            "dp": ("pod", "data") if "pod" in names else "data",
            "fsdp": "data",
            "tp": "model",
        }
    try:
        if _is_device_mesh(mesh) and not _is_device_mesh(prev[0]):
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
        else:
            yield
    finally:
        _state.mesh, _state.axes = prev


def resolve(spec: tuple) -> tuple:
    """Map logical names in a spec tuple to mesh axis names (JAX's
    ``PartitionSpec`` entries: ``None``, a name, or a tuple of names)."""
    _, axes = _current()
    out = []
    for s in spec:
        if s is None:
            out.append(None)
        elif isinstance(s, str):
            out.append(axes.get(s, s))
        else:  # tuple of logical names
            flat = []
            for t in s:
                r = axes.get(t, t)
                flat.extend(r if isinstance(r, tuple) else (r,))
            out.append(tuple(flat))
    return tuple(out)


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def mesh_size(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of a resolved spec: ``Shard(d)`` on every mesh
    dimension that tensor dimension ``d`` names, ``Replicate()`` on the
    rest.  A dimension over several axes is split in mesh order, as JAX
    splits ``P(("pod", "data"))``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        for name in _names(entry):
            out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a resolved spec (one entry per tensor dimension, or fewer:
    the rest unsharded)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def named_sharding(mesh, *spec) -> NamedSharding:
    with use_mesh(mesh):
        return NamedSharding(mesh, resolve(spec))


def axis_size(mesh, logical: str) -> int:
    """The number of shards a logical axis makes on ``mesh`` (1 when it
    names no axis of the mesh)."""
    with use_mesh(mesh):
        spec = resolve((logical,))[0]
    names = [n for n in _names(spec) if n in mesh.mesh_dim_names]
    return int(math.prod(mesh_size(mesh, n) for n in names))


def divisible(dim: int, mesh, axis: str) -> bool:
    """Can `dim` shard over mesh axis `axis`?  (axis may be a logical name)."""
    if mesh is None:
        return False
    with use_mesh(mesh):
        p = resolve((axis,))[0]
    if p is None:
        return False
    return dim % int(math.prod(mesh_size(mesh, n) for n in _names(p))) == 0


def block_state_spec(shape, dp: int, tp: int) -> tuple:
    """The cache rule of a recurrent block's state (B, ...) as a logical
    spec: batch over ``dp``, the biggest tail dimension (the first of equals)
    over ``tp``, each where it divides."""
    spec: list = [None] * len(shape)
    if dp > 1 and shape[0] % dp == 0:
        spec[0] = "dp"
    if len(shape) > 1:
        tail = max(range(1, len(shape)), key=lambda i: (shape[i], -i))
        if tp > 1 and shape[tail] % tp == 0:
            spec[tail] = "tp"
    return tuple(spec)


def serving(fn):
    """Decorator of the models' prefill and decode: ``torch.inference_mode``
    on one card, ``torch.no_grad`` under a mesh (DTensors do not run on
    inference tensors)."""
    import functools

    @functools.wraps(fn)
    def run(*args, **kwargs):
        ctx = torch.no_grad() if _is_device_mesh(active_mesh()) else torch.inference_mode()
        with ctx:
            return fn(*args, **kwargs)

    return run


# ---------------------------------------------------------------------------
# DTensors: placing, constraining, reading
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local_region(shape, mesh, places) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(offsets, sizes) of this rank's piece of a tensor of ``shape`` laid
    out by ``places``: every ``Shard(d)`` splits dimension ``d`` evenly, in
    mesh order (the rules shard only dimensions the shard count divides)."""
    from torch.distributed.tensor import Shard

    offsets, sizes = [0] * len(shape), list(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(places):
        if isinstance(p, Shard):
            d, n = p.dim % len(shape), mesh.size(i)
            if sizes[d] % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not split {n} ways")
            sizes[d] //= n
            offsets[d] += coord[i] * sizes[d]
    return tuple(offsets), tuple(sizes)


def _piece(t: torch.Tensor, offsets, sizes) -> torch.Tensor:
    for d, (o, n) in enumerate(zip(offsets, sizes)):
        if n != t.shape[d]:
            t = t.narrow(d, o, n)
    return t


def distribute(t: torch.Tensor, sharding: NamedSharding, *, device=None):
    """``jax.device_put``: a DTensor whose every rank keeps its own slice of
    the full tensor ``t`` (which every rank holds), moved to ``device``
    (default: ``t``'s).  No communication; a DTensor input is gathered
    first (:func:`full`)."""
    from torch.distributed.tensor import DTensor

    t = full(t)
    mesh, places = sharding.mesh, sharding.placements
    if mesh.get_coordinate() is None:   # a rank outside the mesh holds nothing
        return DTensor.from_local(t.new_empty(0), mesh, places, run_check=False,
                                  shape=t.shape, stride=_dense_stride(t.shape))
    offsets, sizes = local_region(t.shape, mesh, places)
    piece = _piece(t, offsets, sizes)
    piece = piece.to(device=device or piece.device, copy=True).contiguous()
    return DTensor.from_local(piece, mesh, places, run_check=False,
                              shape=t.shape, stride=_dense_stride(t.shape))


def _dense_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def full(x):
    """The whole tensor on every rank (``full_tensor()``, a collective) of a
    DTensor; anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def local(x):
    """This rank's piece of a DTensor (a view: writes land in it); anything
    else as it is."""
    return x.to_local() if is_dtensor(x) else x


def shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """with_sharding_constraint with logical axis names; no-op without mesh.

    A DTensor is redistributed to the spec's placements; a plain tensor
    (replicated) becomes a DTensor holding this rank's slice.  A dimension
    its axes do not divide stays whole (a microbatch of one row under a
    data axis of two), as the parameter rules leave such dimensions."""
    mesh, _ = _current()
    if not _is_device_mesh(mesh):
        return x
    spec = tuple(e if e is None or x.shape[d] % math.prod(
        mesh_size(mesh, n) for n in _names(e)) == 0 else None
        for d, e in enumerate(resolve(spec)))
    return redistribute(x, mesh, NamedSharding(mesh, spec).placements)


def redistribute(x: torch.Tensor, mesh, places) -> torch.Tensor:
    """``x`` laid out by ``places`` on ``mesh``: a DTensor redistributed
    (nothing when it is laid out so already), a plain (replicated) tensor
    sliced to this rank's piece."""
    places = tuple(places)
    if is_dtensor(x):
        return x if tuple(x.placements) == places else x.redistribute(mesh, places)
    from torch.distributed.tensor import DTensor

    offsets, sizes = local_region(x.shape, mesh, places)
    return DTensor.from_local(_piece(x, offsets, sizes), mesh, places, run_check=False)


def write_at(dst: torch.Tensor, dim: int, start, src: torch.Tensor) -> None:
    """``dst.narrow(dim, start, n).copy_(src)`` for a DTensor ``dst``: a
    rank writes only the part of ``src`` that falls in its own piece of
    ``dst`` (the owning rank's read-modify-write); ``src`` holds the values
    of that region in full.  ``start`` may be a 0-d tensor."""
    n = src.shape[dim]
    piece = dst.to_local()
    if piece.is_meta:                   # the dry run: no data to write
        return
    src = full(src)
    start = int(start)
    offsets, sizes = local_region(dst.shape, dst.device_mesh, dst.placements)
    lo, hi = max(start, offsets[dim]), min(start + n, offsets[dim] + sizes[dim])
    if lo >= hi:
        return
    # every other sharded dimension: this rank's slice of src
    src_off = list(offsets)
    src_off[dim] = lo - start
    src_sz = list(sizes)
    src_sz[dim] = hi - lo
    piece.narrow(dim, lo - offsets[dim], hi - lo).copy_(_piece(src, src_off, src_sz))


# ---------------------------------------------------------------------------
# collectives on local tensors (shard_map bodies)
# ---------------------------------------------------------------------------

def axis_index(mesh, axis: str) -> int:
    """``jax.lax.axis_index``: this rank's coordinate on ``axis``."""
    return int(mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)])


def _group(mesh, axis: str):
    return mesh.get_group(mesh.mesh_dim_names.index(axis))


def _staged(t: torch.Tensor, collective: str, group) -> bool:
    import torch.distributed as dist

    return (t.device.type == "cuda" and collective in GLOO_HOST_STAGED
            and dist.get_backend(group) == "gloo")


def _all_gather_through_host(inp: torch.Tensor, group_size: int, group_name: str):
    """The CUDA kernel :func:`stage_gloo_cuda_all_gather` installs: gather
    a host copy over the (gloo) group, copy the result back."""
    ops = torch.ops._c10d_functional
    host = inp.cpu()
    out = ops.wait_tensor(ops.all_gather_into_tensor(host, group_size, group_name))
    _STAGED["bytes"] += host.numel() * host.element_size() + out.numel() * out.element_size()
    return out.to(inp.device)


def stage_gloo_cuda_all_gather() -> bool:
    """Route the functional all-gather of CUDA tensors through the host
    (:func:`_all_gather_through_host`) when the default group's backend is
    gloo; once a process.  Returns whether the staging is in place.  A
    process whose group is NCCL keeps PyTorch's own kernel."""
    import torch.distributed as dist

    if _STAGED["all_gather_lib"] is not None:
        return True
    if not (dist.is_initialized() and dist.get_backend() == "gloo"):
        return False
    import warnings

    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():       # "overriding a previously registered kernel"
        warnings.simplefilter("ignore")
        lib.impl("all_gather_into_tensor", _all_gather_through_host, "CUDA")
    _STAGED["all_gather_lib"] = lib
    return True


def staged_bytes() -> int:
    """Bytes copied to the host and back for gloo (both ways counted once)."""
    return _STAGED["bytes"]


def reset_staged_bytes() -> None:
    _STAGED["bytes"] = 0


class _SumToReplicated(torch.autograd.Function):
    """A SUM all-reduce whose output every rank then uses alike (a
    replicated value): the gradient of each rank's summand is the output's
    gradient itself, so the backward passes it through (Megatron's "reduce
    from the model-parallel region")."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        with torch.no_grad():
            return all_reduce(t.clone(), "sum", mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def all_reduce(t: torch.Tensor, op: str, mesh, axis: str) -> torch.Tensor:
    """``psum`` (``op="sum"``) or ``pmax`` (``"max"``) of a local tensor
    over one mesh axis, in place; returns ``t``.  Under autograd a sum
    returns a new tensor, differentiable on the rule of
    :class:`_SumToReplicated`: the result must be used as a replicated
    value (a ``Replicate()`` DTensor, the same on every rank of ``axis``)."""
    import torch.distributed as dist

    if mesh_size(mesh, axis) == 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        if op != "sum":
            raise ValueError("only a sum all-reduce is differentiable")
        return _SumToReplicated.apply(t, mesh, axis)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(t, red, group=_group(mesh, axis))
    return t


def send_recv(send: torch.Tensor | None, to: int | None, recv: torch.Tensor | None,
              frm: int | None, mesh, axis: str) -> None:
    """``ppermute`` step between neighbours on one mesh axis: send ``send``
    to coordinate ``to`` and receive ``recv`` (in place) from ``frm``, each
    optional."""
    import torch.distributed as dist

    group = _group(mesh, axis)
    ranks = dist.get_process_group_ranks(group)
    stage = any(t is not None and _staged(t, "send_recv", group) for t in (send, recv))
    host_send = send.cpu() if stage and send is not None else send
    host_recv = torch.empty(recv.shape, dtype=recv.dtype) if stage and recv is not None else recv
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, host_send.contiguous(), ranks[to], group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, host_recv, ranks[frm], group))
    for work in dist.batch_isend_irecv(ops) if ops else []:
        work.wait()
    if stage:
        _STAGED["bytes"] += sum(t.numel() * t.element_size()
                                for t in (send, recv) if t is not None)
        if recv is not None:
            recv.copy_(host_recv)


__all__ = ["GLOO_HOST_STAGED", "MeshShape", "NamedSharding", "active_mesh", "all_reduce",
           "axis_index", "axis_size", "distribute", "divisible", "full", "is_dtensor",
           "local", "local_region", "mesh_size", "named_sharding", "placements",
           "redistribute", "reset_staged_bytes", "resolve", "send_recv", "serving", "shard",
           "stage_gloo_cuda_all_gather", "staged_bytes",
           "use_mesh", "write_at"]
