"""CUDA wrappers of the Poisson-binomial prefix-tail kernel (sm_90a).

Two entry points, as in the JAX package, over one CUDA source
(``kernels/csrc/poisson_binomial.cu``, which states the design and bound):

  * :func:`success_tails_cuda`   — one static threshold tuple shared by all
    rows (replaces ``success_tails_pallas``); the tuple is copied to the
    device and read with row stride 0;
  * :func:`success_tails_cuda_w` — per-row (B, n) int32 thresholds
    (replaces ``success_tails_pallas_w``); row stride n.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on the current stream, raises if the
launch reports an error, and adds one to its launch count.  It never falls
back to the plain version: a tensor off the GPU raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_LAUNCHES = {"success_tails_cuda": 0, "success_tails_cuda_w": 0}


def launch_counts() -> dict[str, int]:
    """Launches of each wrapper since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (first use builds)."""
    global _LIB
    if _LIB is None:
        lib = build.load("poisson_binomial")
        lib.pb_success_tails.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.pb_success_tails.restype = ctypes.c_int
        lib.pb_max_n.argtypes = []
        lib.pb_max_n.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_probs(probs: torch.Tensor) -> None:
    if probs.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {probs.device} tensor")
    if probs.dtype != torch.float32 or probs.dim() != 2:
        raise ValueError(
            f"probs must be a (B, n) float32 tensor, got {probs.dtype} "
            f"{tuple(probs.shape)}"
        )
    if not probs.is_contiguous():
        raise ValueError("probs must be contiguous")


def _launch(probs: torch.Tensor, w: torch.Tensor, w_stride: int) -> torch.Tensor:
    lib = _library()
    rows, n = probs.shape
    if n > lib.pb_max_n():
        raise ValueError(f"n={n} exceeds the kernel's limit of {lib.pb_max_n()}")
    out = torch.empty_like(probs)
    if rows == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(probs.device).cuda_stream
    err = lib.pb_success_tails(
        probs.data_ptr(), w.data_ptr(), out.data_ptr(), rows, n, w_stride, stream
    )
    if err != 0:
        raise RuntimeError(f"poisson_binomial kernel launch failed: cudaError {err}")
    return out


def success_tails_cuda(probs: torch.Tensor, w) -> torch.Tensor:
    """(B, n) float32 CUDA probabilities + static n-tuple thresholds -> tails."""
    _check_probs(probs)
    w_t = torch.as_tensor(tuple(int(v) for v in w), dtype=torch.int32,
                          device=probs.device)
    if w_t.shape != (probs.shape[1],):
        raise ValueError(f"w must hold n={probs.shape[1]} thresholds, got {len(w_t)}")
    out = _launch(probs, w_t, 0)
    _LAUNCHES["success_tails_cuda"] += 1
    return out


def success_tails_cuda_w(probs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, n) float32 CUDA probabilities + (B, n) int32 thresholds -> tails."""
    _check_probs(probs)
    if w.device != probs.device or w.dtype != torch.int32 or w.shape != probs.shape:
        raise ValueError(
            f"w must be an int32 tensor of shape {tuple(probs.shape)} on "
            f"{probs.device}, got {w.dtype} {tuple(w.shape)} on {w.device}"
        )
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    out = _launch(probs, w, probs.shape[1])
    _LAUNCHES["success_tails_cuda_w"] += 1
    return out


__all__ = ["launch_counts", "reset_launch_counts", "success_tails_cuda",
           "success_tails_cuda_w"]
