"""CUDA wrappers of the exact GF(p) matmul kernel (sm_90a), p = 2^31 - 1.

Two entry points over one CUDA source (``kernels/csrc/gf_matmul.cu``, which
states the design and bound); both replace ``matmul_gf_pallas``:

  * :func:`matmul_gf_cuda` — (m, c) @ (c, n), a batch of one;
  * :func:`bmm_gf_cuda`    — (B, m, c) @ (B, c, n), the batch a grid axis of
    ONE launch.

Inputs are int32 tensors of any values on one CUDA device: the kernel's
loaders reduce each value mod p as they read it (the formula of
:func:`~repro_torch.kernels.gf.ref.canonical_i32`), so already-canonical
data pays no pass.  An operand goes in as it lies, through its element
strides, when one of its two inner axes has unit stride (a row-major
matrix, or a transposed view such as x~^T); any other layout is copied
contiguous first (:func:`kernel_layout`).  Each wrapper checks the rest,
allocates its output with ``torch.empty``, launches on the current stream,
raises if the launch reports an error, and adds one to its launch count.
It never falls back to the plain version: a tensor off the GPU raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.obs import counters as _obs_counters

_LAUNCHES = {"matmul_gf_cuda": 0, "bmm_gf_cuda": 0}
_INT_MAX = 2**31 - 1


def launch_counts() -> dict[str, int]:
    """Launches of each wrapper since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


_obs_counters.register_launches("gf", launch_counts, reset_launch_counts)


_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built library with its C signature declared (first use builds)."""
    global _LIB
    if _LIB is None:
        lib = build.load("gf_matmul")
        lib.gf_matmul.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
            + [ctypes.c_void_p])
        lib.gf_matmul.restype = ctypes.c_int
        lib.gf_matmul_splits.argtypes = [ctypes.c_int] * 4
        lib.gf_matmul_splits.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def reads_as_it_lies(t: torch.Tensor) -> bool:
    """Does one of the two inner axes of ``t`` have unit stride, so that the
    kernel's loaders read it coalesced through its strides?"""
    return t.stride(-1) == 1 or t.stride(-2) == 1


def kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel reads it as it lies
    (:func:`reads_as_it_lies`), else a contiguous copy."""
    return t if reads_as_it_lies(t) else t.contiguous()


def _check(name: str, t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` in a layout the kernel reads, after the wrapper's checks."""
    if t.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {t.device} tensor ({name})")
    if t.dtype != torch.int32 or t.dim() != dim:
        raise ValueError(f"{name} must be a {dim}-D int32 tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    return kernel_layout(t)


def _launch(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, m, c) @ (B, c, n) -> (B, m, n), already checked; counts the
    launch under ``name``."""
    batch, m, c = a.shape
    n = b.shape[2]
    if b.shape[:2] != (batch, c) or a.device != b.device:
        raise ValueError(f"gf matmul: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} or devices {a.device}, {b.device}")
    if max(batch, m, c, n) > _INT_MAX:
        raise ValueError(f"gf matmul: dimensions {batch, m, c, n} exceed int32")
    out = torch.empty((batch, m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    lib = _library()
    # a split-K launch sums its K slices into a zeroed uint64 scratch
    scratch = None
    if lib.gf_matmul_splits(batch, m, c, n) > 1:
        scratch = torch.zeros(batch * m * n, dtype=torch.int64, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.gf_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                        None if scratch is None else scratch.data_ptr(),
                        batch, m, c, n, *a.stride(), *b.stride(), stream)
    if err != 0:
        raise RuntimeError(f"gf_matmul kernel launch failed: cudaError {err}")
    _LAUNCHES[name] += 1
    return out


def matmul_gf_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, c) @ (c, n) int32 CUDA tensors -> (m, n) residues mod p."""
    a = _check("a", a, 2)
    b = _check("b", b, 2)
    return _launch("matmul_gf_cuda", a[None], b[None])[0]


def bmm_gf_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, m, c) @ (B, c, n) int32 CUDA tensors -> (B, m, n) residues mod p,
    one launch."""
    a = _check("a", a, 3)
    b = _check("b", b, 3)
    return _launch("bmm_gf_cuda", a, b)


__all__ = ["bmm_gf_cuda", "kernel_layout", "launch_counts", "matmul_gf_cuda",
           "reads_as_it_lies", "reset_launch_counts"]
