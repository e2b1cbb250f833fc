"""CUDA wrapper of the flash-attention forward kernel (sm_90a).

:func:`flash_attention_cuda` replaces ``flash_attention_pallas``; the CUDA
source (``kernels/csrc/flash_attention.cu``) states the design and bound.

It takes q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D) of one float type
(bfloat16 and float16 on the tensor cores, float32 on FFMA) on one CUDA
device, with D in {16, 32, 64, 128} and Hq a multiple of Hkv.  The tensors
need not be contiguous: the kernel reads each through its batch, head and
sequence strides, so the (B, H, S, D) views that ``attention_train`` makes
with ``transpose(1, 2)`` go in without a copy; only the head dimension must
be contiguous and each row 16-byte aligned.  The output takes q's layout
(``torch.empty_like``), so the layer's transpose back is a view too.  The
wrapper checks all that, launches on the current stream, raises if the
launch reports an error, and adds one to its launch count.  It never falls
back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INT_MAX = 2**31 - 1
_GRID_MAX = 65535

_LAUNCHES = {"flash_attention_cuda": 0}


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
        lib = build.load("flash_attention")
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kernel_takes(t: torch.Tensor) -> bool:
    """Can the kernel read ``t`` through its strides as it is: the last axis
    contiguous and every row start 16-byte aligned?"""
    per_vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % per_vec == 0
                    for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """softmax(scale q k^T) v over the visible keys, (B, Hq, Sq, D) in q's
    dtype and layout; a row that sees no key is 0."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"CUDA kernel called on a {t.device} tensor ({name})")
        if t.dim() != 4 or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be a 4-D {q.dtype} tensor on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not kernel_takes(t):
            raise ValueError(f"{name}: the head dimension must be contiguous and "
                             f"rows 16-byte aligned, got strides {t.stride()}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention takes {list(_DTYPES)}, got {q.dtype}")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if (k.shape[0] != b or k.shape[3] != d or v.shape != k.shape
            or hkv == 0 or hq % hkv):
        raise ValueError(f"flash attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dimension {d} not in {HEAD_DIMS}")
    if max(sq, sk) > _INT_MAX or b > _GRID_MAX or hq > _GRID_MAX:
        raise ValueError(f"flash attention: shape {tuple(q.shape)} exceeds the grid")
    out = torch.empty_like(q)          # q's strides: q is dense or a dense view
    if out.numel() == 0:
        return out
    if scale is None:
        scale = float(d) ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        b, hq, hkv, sq, sk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(bool(causal)), -1 if window is None else int(window),
        float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    _LAUNCHES["flash_attention_cuda"] += 1
    return out


__all__ = ["HEAD_DIMS", "flash_attention_cuda", "kernel_takes", "launch_counts",
           "reset_launch_counts"]
