"""CUDA wrappers of the Poisson-binomial prefix-tail kernel (sm_90a).

Two entry points, as in the JAX package, over one CUDA source
(``kernels/csrc/poisson_binomial.cu``, which states the design and bound):

  * :func:`success_tails_cuda`   — one static threshold tuple shared by all
    rows (replaces ``success_tails_pallas``); the tuple is uploaded to the
    device once per (device, tuple) and read as an all-broadcast view;
  * :func:`success_tails_cuda_w` — int32 thresholds broadcastable to the
    probabilities, per row or shared along any axes (replaces
    ``success_tails_pallas_w``), read as they lie: stride 0 on broadcast
    axes, nothing materialised.

:func:`threshold_geometry` turns the two shapes and the thresholds' strides
into the kernel's view, and refuses what the kernel cannot take.  Each
wrapper checks device, dtype, shape and contiguity of the probabilities,
allocates its output with ``torch.empty``, launches on the current stream,
raises if the launch reports an error, and adds one to its launch count.  It
never falls back to the plain version: a tensor off the GPU raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.obs import counters as _obs_counters

_LAUNCHES = {"success_tails_cuda": 0, "success_tails_cuda_w": 0}
MAX_LEAD = 4            # leading axes of a threshold view with a stride (the kernel's kMaxLead)
_STATIC_CACHE = 64      # static tuples kept on the device


def launch_counts() -> dict[str, int]:
    """Launches of each wrapper since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


_obs_counters.register_launches("poisson_binomial", launch_counts, reset_launch_counts)


class ThresholdGeometry(NamedTuple):
    """Where row b of the (rows, n) probabilities finds its thresholds:
    element i at ``sum_d ((b // div) % size) * stride`` over ``axes``
    (outermost first, strided axes only) ``+ i * last_stride``; rows b and b'
    with ``b // rep == b' // rep`` share one threshold row."""
    rows: int
    n: int
    rep: int
    axes: tuple[tuple[int, int, int], ...]     # (div, size, stride) per axis
    last_stride: int

    def words(self) -> list[int]:
        """The int64 words ``pb_success_tails`` reads."""
        return [self.rep, len(self.axes), *(v for axis in self.axes for v in axis),
                self.last_stride]


@functools.lru_cache(maxsize=256)
def threshold_geometry(probs_shape: tuple[int, ...], w_shape: tuple[int, ...],
                       w_strides: tuple[int, ...]) -> ThresholdGeometry:
    """The kernel's view of thresholds of ``w_shape`` / ``w_strides``
    (elements) broadcast against probabilities of ``probs_shape``.

    Raises ``ValueError`` where the thresholds do not broadcast to the
    probabilities (the output keeps the probabilities' shape) or where more
    than :data:`MAX_LEAD` strided leading axes remain after merging.
    """
    if not probs_shape:
        raise ValueError("probs must have a last axis of n workers")
    if len(w_shape) > len(probs_shape) or len(w_strides) != len(w_shape):
        raise ValueError(f"thresholds of shape {w_shape} do not broadcast to the "
                         f"probabilities' {probs_shape}")
    pad = len(probs_shape) - len(w_shape)
    strides = []
    for size, w_size, w_stride in zip(probs_shape, (1,) * pad + w_shape,
                                      (0,) * pad + tuple(w_strides)):
        if w_size == size and size != 1:
            strides.append(int(w_stride))
        elif w_size == 1:
            strides.append(0)
        else:
            raise ValueError(f"thresholds of shape {w_shape} do not broadcast to the "
                             f"probabilities' {probs_shape}")
    n = probs_shape[-1]
    # leading axes innermost first, as (div, size, stride)
    inner, div = [], 1
    for size, stride in zip(reversed(probs_shape[:-1]), reversed(strides[:-1])):
        inner.append((div, size, stride))
        div *= size
    rows = div
    rep = 1
    for _, size, stride in inner:          # the innermost broadcast axes share a row
        if stride != 0:
            break
        rep *= size
    merged: list[tuple[int, int, int]] = []
    for d, size, stride in inner:
        if stride == 0 or size == 1:
            continue
        if merged:
            d0, s0, st0 = merged[-1]
            if d == d0 * s0 and stride == st0 * s0:
                merged[-1] = (d0, s0 * size, st0)
                continue
        merged.append((d, size, stride))
    if len(merged) > MAX_LEAD:
        raise ValueError(
            f"thresholds of shape {w_shape} and strides {tuple(w_strides)} over "
            f"{probs_shape} leave {len(merged)} strided leading axes; the kernel "
            f"takes at most {MAX_LEAD}: make them contiguous first")
    return ThresholdGeometry(rows, n, max(rep, 1), tuple(reversed(merged)), strides[-1])


_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (first use builds)."""
    global _LIB
    if _LIB is None:
        lib = build.load("poisson_binomial")
        lib.pb_success_tails.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
        ]
        lib.pb_success_tails.restype = ctypes.c_int
        lib.pb_max_n.argtypes = []
        lib.pb_max_n.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_probs(probs: torch.Tensor) -> None:
    if probs.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {probs.device} tensor")
    if probs.dtype != torch.float32 or probs.dim() < 1:
        raise ValueError(
            f"probs must be a (..., n) float32 tensor, got {probs.dtype} "
            f"{tuple(probs.shape)}"
        )
    if not probs.is_contiguous():
        raise ValueError("probs must be contiguous")


def _launch(probs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if w.device != probs.device or w.dtype != torch.int32:
        raise ValueError(f"w must be an int32 tensor on {probs.device}, got {w.dtype} "
                         f"on {w.device}")
    geometry = threshold_geometry(tuple(probs.shape), tuple(w.shape), tuple(w.stride()))
    lib = _library()
    n = geometry.n
    if n > lib.pb_max_n():
        raise ValueError(f"n={n} exceeds the kernel's limit of {lib.pb_max_n()}")
    out = torch.empty_like(probs)
    if geometry.rows == 0 or n == 0:
        return out
    words = geometry.words()
    view = (ctypes.c_int64 * len(words))(*words)
    stream = torch._C._cuda_getCurrentRawStream(probs.device.index)   # the current stream
    err = lib.pb_success_tails(probs.data_ptr(), w.data_ptr(), out.data_ptr(),
                               geometry.rows, n, view, stream)
    if err != 0:
        raise RuntimeError(f"poisson_binomial kernel launch failed: cudaError {err}")
    return out


_STATIC: dict[tuple[torch.device, tuple[int, ...]], torch.Tensor] = {}


def _static_thresholds(w, device: torch.device) -> torch.Tensor:
    """The (n,) int32 device copy of a static threshold tuple, uploaded on
    the first call for each (device, tuple) and kept."""
    key = (device, tuple(int(v) for v in w))
    t = _STATIC.get(key)
    if t is None:
        if len(_STATIC) >= _STATIC_CACHE:
            _STATIC.clear()
        t = _STATIC[key] = torch.tensor(key[1], dtype=torch.int32, device=device)
    return t


def success_tails_cuda(probs: torch.Tensor, w) -> torch.Tensor:
    """(..., n) float32 CUDA probabilities + static n-tuple thresholds -> tails."""
    _check_probs(probs)
    w_t = _static_thresholds(w, probs.device)
    if w_t.shape != (probs.shape[-1],):
        raise ValueError(f"w must hold n={probs.shape[-1]} thresholds, got {len(w_t)}")
    out = _launch(probs, w_t)
    _LAUNCHES["success_tails_cuda"] += 1
    return out


def success_tails_cuda_w(probs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., n) float32 CUDA probabilities + int32 thresholds broadcastable
    to them, in any strides -> tails."""
    _check_probs(probs)
    out = _launch(probs, w)
    _LAUNCHES["success_tails_cuda_w"] += 1
    return out


__all__ = ["MAX_LEAD", "ThresholdGeometry", "launch_counts", "reset_launch_counts",
           "success_tails_cuda", "success_tails_cuda_w",
           "threshold_geometry"]
