"""CUDA wrapper of the Lagrange encode GEMM kernel (sm_90a).

:func:`encode_matrix_cuda` replaces ``encode_matrix_pallas``; the CUDA
source (``kernels/csrc/lagrange_encode.cu``) states the design and bound.
Inputs are float32, contiguous, on one CUDA device.  The wrapper checks
that, allocates its output with ``torch.empty``, launches on the current
stream, raises if the launch reports an error, and adds one to its launch
count.  It never falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_LAUNCHES = {"encode_matrix_cuda": 0}
_INT_MAX = 2**31 - 1


def launch_counts() -> dict[str, int]:
    """Launches of the wrapper since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built library with its C signature declared (first use builds)."""
    global _LIB
    if _LIB is None:
        lib = build.load("lagrange_encode")
        lib.lagrange_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.lagrange_encode.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def encode_matrix_cuda(g: torch.Tensor, x2d: torch.Tensor) -> torch.Tensor:
    """(nr, k) @ (k, cols) float32 CUDA tensors -> (nr, cols) float32."""
    for name, t in (("g", g), ("x2d", x2d)):
        if t.device.type != "cuda":
            raise ValueError(f"CUDA kernel called on a {t.device} tensor ({name})")
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D float32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nr, k = g.shape
    if x2d.shape[0] != k or x2d.device != g.device:
        raise ValueError(f"encode: bad shapes {tuple(g.shape)} @ "
                         f"{tuple(x2d.shape)} or devices {g.device}, {x2d.device}")
    cols = x2d.shape[1]
    if max(nr, k, cols) > _INT_MAX:
        raise ValueError(f"encode: dimensions {nr, k, cols} exceed int32")
    out = torch.empty((nr, cols), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = _library().lagrange_encode(g.data_ptr(), x2d.data_ptr(),
                                     out.data_ptr(), nr, k, cols, stream)
    if err != 0:
        raise RuntimeError(f"lagrange_encode kernel launch failed: cudaError {err}")
    _LAUNCHES["encode_matrix_cuda"] += 1
    return out


__all__ = ["encode_matrix_cuda", "launch_counts", "reset_launch_counts"]
