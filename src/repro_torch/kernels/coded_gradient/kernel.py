"""CUDA wrapper of the fused coded-gradient kernel (sm_90a).

:func:`coded_gradient_cuda` replaces ``coded_gradient_pallas``; the CUDA
source (``kernels/csrc/coded_gradient.cu``) states the design and bound.
It keeps the JAX wrapper's footprint check (:func:`check_footprint`), so the
same inputs raise ``ValueError`` in both packages, and that is the only
refusal.  Two routes, picked from the shape alone (:func:`gradient_route`):

  * ``rows`` for P <= 8 and C * next_pow2(P) <= 4096: blocks stream rows of
    x through a ring in shared memory and use each once for both products;
    a chunk's rows are split over a cluster of 1-8 blocks (:func:`row_plan`)
    whose partials are added in a fixed order;
  * ``chunk`` otherwise: one block a chunk, its (R, P) residual in shared
    memory up to :func:`shared_residual_limit` floats (what the device lets
    a block opt in to, read at run time; 58 112 on the H100), and past that
    in a global scratch of nr * R * P floats that the wrapper allocates
    (:func:`residual_path`).

Inputs are float32, contiguous, on one CUDA device.  The wrapper checks
that, allocates its output with ``torch.empty``, launches on the current
stream, raises if the launch reports an error, and adds one to its launch
count.  It never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.obs import counters as _obs_counters

# The JAX kernel's VMEM budget for one chunk's working set (its kernel.py).
VMEM_BUDGET_BYTES = 12 * 1024 * 1024

_LAUNCHES = {"coded_gradient_cuda": 0}

ROW_THREADS = 256          # a block of the rows route
ROW_REG_FLOATS = 16        # a thread's x floats a row times P's tile (registers)
MAX_CLUSTER = 8            # the portable thread block cluster size
TARGET_BLOCKS = 4 * 132    # four blocks per SM of the H100


def p_tile(p: int) -> int:
    """The rows route's register tile over P: the next power of two <= 8."""
    return 1 if p <= 1 else 2 if p <= 2 else 4 if p <= 4 else 8


def gradient_route(r_rows: int, c: int, p: int) -> str:
    """The kernel that takes chunks of shape (R, C) with P targets:
    ``"rows"`` where a thread's share of a row and of w fits its registers
    (P <= 8 and C * next_pow2(P) <= 4096), else ``"chunk"``."""
    del r_rows    # any R streams through the ring
    if p <= 8 and c * p_tile(p) <= ROW_THREADS * ROW_REG_FLOATS:
        return "rows"
    return "chunk"


def row_vec(c: int, p: int, aligned: bool) -> int:
    """Floats a copy of the rows route: 4 (16 bytes) where rows are whole
    16-byte vectors on a 16-byte boundary and a 4-float piece fits the
    register budget beside P's tile, else 1."""
    return 4 if c % 4 == 0 and aligned and 4 * p_tile(p) <= ROW_REG_FLOATS else 1


class RowPlan(NamedTuple):
    vec: int              # floats a copy: 4 (16 bytes) or 1
    tc: int               # threads a row (a power of two)
    k: int                # pieces of vec columns a thread owns
    tr: int               # rows a block takes a step
    cluster: int          # blocks a chunk
    rows_per_block: int


@functools.lru_cache(maxsize=256)
def row_plan(nr: int, r_rows: int, c: int, p: int, vec: int) -> RowPlan:
    """The rows route's launch: the fewest threads a row that keep a
    thread's pieces within its registers, then the most blocks a chunk
    (a power of two <= 8) that bring nr * cluster up to four blocks per SM
    while each block keeps a step of rows."""
    kmax = ROW_REG_FLOATS // (vec * p_tile(p))
    cv = -(-c // vec)
    tc = 1
    while -(-cv // tc) > kmax:
        tc *= 2
    k = max(1, -(-cv // tc))
    tr = ROW_THREADS // tc
    steps = -(-r_rows // tr)
    want = -(-TARGET_BLOCKS // max(nr, 1))
    cluster = 1
    while cluster < MAX_CLUSTER and cluster < want and 2 * cluster <= steps:
        cluster *= 2
    return RowPlan(vec, tc, k, tr, cluster, max(1, -(-steps // cluster)) * tr)


def launch_counts() -> dict[str, int]:
    """Launches of the wrapper since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


_obs_counters.register_launches("coded_gradient", launch_counts, reset_launch_counts)


def check_footprint(r_rows: int, c: int, p: int) -> None:
    """The JAX wrapper's per-chunk working-set check, bytes for bytes."""
    footprint = 4 * (r_rows * c + r_rows * p + 2 * c * p)
    if footprint > VMEM_BUDGET_BYTES:
        raise ValueError(
            f"chunk working set {footprint/2**20:.1f} MiB exceeds VMEM budget; "
            "shrink chunk rows R or split C externally"
        )


_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built library with its C signature declared (first use builds)."""
    global _LIB
    if _LIB is None:
        lib = build.load("coded_gradient")
        lib.coded_gradient.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.coded_gradient.restype = ctypes.c_int
        lib.coded_gradient_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            *[ctypes.c_int] * 9, ctypes.c_void_p,
        ]
        lib.coded_gradient_rows.restype = ctypes.c_int
        lib.coded_gradient_shared_limit.argtypes = []
        lib.coded_gradient_shared_limit.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def shared_residual_limit() -> int:
    """The largest R * P whose residual the kernel keeps in shared memory on
    the current CUDA device (builds on first use); above it the residual
    goes through global memory."""
    return int(_library().coded_gradient_shared_limit())


def residual_path(r_rows: int, p: int) -> str:
    """``"shared"`` or ``"global"``: where the chunk route keeps an (R, P)
    residual on the current CUDA device."""
    return "shared" if r_rows * p <= shared_residual_limit() else "global"


def coded_gradient_cuda(x_tilde: torch.Tensor, y_tilde: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """(nr,R,C), (nr,R,P), (C,P) float32 CUDA tensors -> (nr,C,P) float32."""
    for name, t, dim in (("x_tilde", x_tilde, 3), ("y_tilde", y_tilde, 3),
                         ("w", w, 2)):
        if t.device.type != "cuda":
            raise ValueError(f"CUDA kernel called on a {t.device} tensor ({name})")
        if t.dtype != torch.float32 or t.dim() != dim:
            raise ValueError(f"{name} must be a {dim}-D float32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nr, r_rows, c = x_tilde.shape
    p = y_tilde.shape[2]
    if (y_tilde.shape[:2] != (nr, r_rows) or w.shape != (c, p)
            or not x_tilde.device == y_tilde.device == w.device):
        raise ValueError(
            f"coded_gradient: bad shapes {tuple(x_tilde.shape)}, "
            f"{tuple(y_tilde.shape)}, {tuple(w.shape)} or devices")
    check_footprint(r_rows, c, p)
    out = torch.empty((nr, c, p), dtype=torch.float32, device=w.device)
    if out.numel() == 0:
        return out
    stream = torch._C._cuda_getCurrentRawStream(w.device.index)   # the current stream
    if gradient_route(r_rows, c, p) == "rows":
        plan = row_plan(nr, r_rows, c, p, row_vec(c, p, x_tilde.data_ptr() % 16 == 0))
        err = _library().coded_gradient_rows(
            x_tilde.data_ptr(), y_tilde.data_ptr(), w.data_ptr(), out.data_ptr(),
            nr, r_rows, c, p, plan.vec, plan.tc, plan.k, plan.cluster,
            plan.rows_per_block, stream)
    else:
        scratch = None
        if residual_path(r_rows, p) == "global":
            scratch = torch.empty((nr, r_rows, p), dtype=torch.float32, device=w.device)
        err = _library().coded_gradient(
            x_tilde.data_ptr(), y_tilde.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), nr, r_rows, c, p, stream)
    if err != 0:
        raise RuntimeError(f"coded_gradient kernel launch failed: cudaError {err}")
    _LAUNCHES["coded_gradient_cuda"] += 1
    return out


__all__ = ["VMEM_BUDGET_BYTES", "RowPlan", "check_footprint", "coded_gradient_cuda",
           "gradient_route", "launch_counts", "reset_launch_counts", "residual_path",
           "row_plan", "row_vec", "shared_residual_limit"]
