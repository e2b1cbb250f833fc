"""CUDA wrapper of the fused coded-gradient kernel (sm_90a).

:func:`coded_gradient_cuda` replaces ``coded_gradient_pallas``; the CUDA
source (``kernels/csrc/coded_gradient.cu``) states the design and bound.
It keeps the JAX wrapper's footprint check (:func:`check_footprint`), so the
same inputs raise ``ValueError`` in both packages, and that is the only
refusal: a chunk's (R, P) residual stays in the block's shared memory up to
:func:`shared_residual_limit` floats (what the device lets a block opt in
to, read at run time; 58 112 on the H100), and a larger one goes to a
global scratch of nr * R * P floats that the wrapper allocates.

Inputs are float32, contiguous, on one CUDA device.  The wrapper checks
that, allocates its output with ``torch.empty``, launches on the current
stream, raises if the launch reports an error, and adds one to its launch
count.  It never falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# The JAX kernel's VMEM budget for one chunk's working set (its kernel.py).
VMEM_BUDGET_BYTES = 12 * 1024 * 1024

_LAUNCHES = {"coded_gradient_cuda": 0}


def launch_counts() -> dict[str, int]:
    """Launches of the wrapper since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


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
    """``"shared"`` or ``"global"``: where the kernel keeps an (R, P)
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
    scratch = None
    if residual_path(r_rows, p) == "global":
        scratch = torch.empty((nr, r_rows, p), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = _library().coded_gradient(
        x_tilde.data_ptr(), y_tilde.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), nr, r_rows, c, p, stream)
    if err != 0:
        raise RuntimeError(f"coded_gradient kernel launch failed: cudaError {err}")
    _LAUNCHES["coded_gradient_cuda"] += 1
    return out


__all__ = ["VMEM_BUDGET_BYTES", "check_footprint", "coded_gradient_cuda",
           "launch_counts", "reset_launch_counts", "residual_path",
           "shared_residual_limit"]
