"""CUDA wrapper of the Lagrange encode GEMM kernel (sm_90a).

:func:`encode_matrix_cuda` replaces ``encode_matrix_pallas``; the CUDA
source (``kernels/csrc/lagrange_encode.cu``) states the design and bound.
Inputs are float32, contiguous, on one CUDA device.  The wrapper checks
that, picks the kernel's route from the shapes alone (:func:`encode_route`),
allocates its output with ``torch.empty``, launches on the current stream,
raises if the launch reports an error, and adds one to its launch count.  It
never falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.obs import counters as _obs_counters

_LAUNCHES = {"encode_matrix_cuda": 0}
_INT_MAX = 2**31 - 1
STREAM_MAX_K = 16          # the most k the streaming kernel keeps in registers
ROUTES = {"tiled": 0, "stream": 1, "stream_scalar": 2}


def encode_route(k: int, cols: int, aligned: bool = True) -> str:
    """The kernel that takes (nr, k) @ (k, cols): ``"stream"`` (each thread
    holds a 4-column strip of x in registers and streams 16-byte stores) for
    1 <= k <= 16 with cols a multiple of 4 and x 16-byte ``aligned``;
    ``"stream_scalar"`` (the same with 4-byte accesses) for other cols;
    ``"tiled"`` (64 x 128 output tiles, k staged through shared memory) for
    k = 0 and k > 16."""
    if not 1 <= k <= STREAM_MAX_K:
        return "tiled"
    return "stream" if cols % 4 == 0 and aligned else "stream_scalar"


def launch_counts() -> dict[str, int]:
    """Launches of the wrapper since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


_obs_counters.register_launches("lagrange_encode", launch_counts, reset_launch_counts)


_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built library with its C signature declared (first use builds)."""
    global _LIB
    if _LIB is None:
        lib = build.load("lagrange_encode")
        lib.lagrange_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
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
    route = encode_route(k, cols, aligned=x2d.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = _library().lagrange_encode(g.data_ptr(), x2d.data_ptr(), out.data_ptr(),
                                     nr, k, cols, ROUTES[route], stream)
    if err != 0:
        raise RuntimeError(f"lagrange_encode kernel launch failed: cudaError {err}")
    _LAUNCHES["encode_matrix_cuda"] += 1
    return out


__all__ = ["ROUTES", "STREAM_MAX_K", "encode_matrix_cuda", "encode_route", "launch_counts",
           "reset_launch_counts"]
