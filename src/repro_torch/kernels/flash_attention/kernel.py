"""CUDA wrapper of the flash-attention forward kernel (sm_90a).

:func:`flash_attention_cuda` replaces ``flash_attention_pallas``; the CUDA
source (``kernels/csrc/flash_attention.cu``) states the design and bound.

It takes q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D) of one float type on one
CUDA device, with 1 <= D <= 256 and Hq a multiple of Hkv.  The dtype and D
alone choose the kernel (:func:`flash_route`): bfloat16 and float16 at
D = 64 and 128 take the Hopper kernel (TMA ring, wgmma, warp specialised),
at any other D the mma.sync kernel; float32 takes the FFMA kernel.  The
mma.sync and FFMA kernels are instantiated at :data:`HEAD_DIMS`, and a D
between two of them runs the next one up (:func:`head_dim_instance`),
with the columns past D read as zeros and never stored.  The tensors need
not be contiguous: every route reads each tensor through its batch, head
and sequence strides (the wgmma route through a 4-D TMA tensor map built
from them, :func:`tma_geometry`), so the (B, H, S, D) views that
``attention_train`` makes with ``transpose(1, 2)`` go in without a copy;
only the head dimension must be contiguous, and, where D is a whole number
of 16-byte vectors, each row 16-byte aligned (other D are read element by
element).  The output takes q's layout (``torch.empty_like``), so
the layer's transpose back is a view too.  The wrapper checks all that,
launches on the current stream, raises if the launch or a tensor map is
refused, and adds one to its launch count.  With no keys (Sk = 0) it
launches nothing and returns zeros, what every route computes for a row that
sees no key (and TMA takes no empty extent).  It never falls back to the
plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.obs import counters as _obs_counters

# the head dimensions the mma.sync and FFMA kernels are instantiated at
HEAD_DIMS = (16, 32, 64, 96, 128, 160, 192, 256)
MAX_HEAD_DIM = HEAD_DIMS[-1]
WGMMA_HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTES = {"ffma": 0, "mma": 1, "wgmma": 2}
# One TMA box: 64 16-bit columns (the 128-byte swizzle's span) by 128 rows
# (the kernel's query and key tiles).
TMA_BOX = (64, 128)
_TMA_STRIDE_MAX = 2**40
_HOST_ERRORS = {-1: "the CUDA driver offers no cuTensorMapEncodeTiled",
                -2: "cuTensorMapEncodeTiled refused a tensor map"}
_INT_MAX = 2**31 - 1
_GRID_MAX = 65535

_LAUNCHES = {"flash_attention_cuda": 0}


def launch_counts() -> dict[str, int]:
    """Launches of the wrapper since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


_obs_counters.register_launches("flash_attention", launch_counts, reset_launch_counts)


def visible_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the masks leave visible: what B6's work depends
    on.  Query row i sits at key position i + sk - sq."""
    total = 0
    for i in range(sq):
        pos = i + sk - sq
        hi = min(sk - 1, pos) if causal else sk - 1
        lo = max(0, pos - window + 1) if window is not None else 0
        total += max(hi - lo + 1, 0)
    return total


def launch_work(q: torch.Tensor, k: torch.Tensor, causal: bool,
                window: int | None) -> tuple[int, int]:
    """(bytes, operations) of one launch: q, k, v read once and the output
    written once; 4 D operations per visible (query, key) pair and query
    head (the two products).  Shapes only: meta tensors do."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    moved = q.element_size() * (2 * b * hq * sq * d + 2 * b * hkv * sk * d)
    return moved, 4 * d * visible_pairs(sq, sk, causal, window) * b * hq


_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built library with its C signature declared (first use builds)."""
    global _LIB
    if _LIB is None:
        lib = build.load("flash_attention")
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 12
            + [ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int,
               ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_wgmma_smem_bytes.argtypes = [ctypes.c_int]
        lib.flash_attention_wgmma_smem_bytes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def head_dim_instance(d: int) -> int:
    """The head dimension of the mma.sync / FFMA instantiation that runs
    ``d``: the smallest of :data:`HEAD_DIMS` at or above it."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dimension {d} outside 1..{MAX_HEAD_DIM}")
    return next(D for D in HEAD_DIMS if d <= D)


def flash_route(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes ``dtype`` at head dimension ``d``: ``"wgmma"``
    for bfloat16 / float16 at D = 64 and 128, ``"mma"`` for them at any
    other D up to 256, ``"ffma"`` for float32."""
    head_dim_instance(d)                     # raises outside 1..256
    if dtype == torch.float32:
        return "ffma"
    if dtype in (torch.bfloat16, torch.float16):
        return "wgmma" if d in WGMMA_HEAD_DIMS else "mma"
    raise ValueError(f"flash attention takes {list(_DTYPES)}, got {dtype}")


def tma_geometry(t: torch.Tensor) -> tuple[int, ...]:
    """The 4-D TMA tensor map of a (B, H, S, D) 16-bit tensor, as the CUDA
    source reads it: the extents innermost first (D, S, H, B), the byte
    strides of S, H and B, and the box (columns, rows) of :data:`TMA_BOX`.

    Raises ``ValueError`` for a view TMA cannot take: a head dimension that
    is not contiguous or not a whole number of boxes, a base address that is
    not 16-byte aligned, a stride that is not a multiple of 16 bytes, an
    empty extent.  The stride of an axis of extent 1 is never followed, so
    it is given as the dense one.
    """
    if t.dim() != 4 or t.element_size() != 2:
        raise ValueError(f"TMA maps take 4-D 16-bit tensors, got {t.dtype} {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError("TMA: the base address must be 16-byte aligned")
    return _tma_layout(tuple(t.shape), t.stride())


@functools.lru_cache(maxsize=256)
def _tma_layout(shape: tuple[int, ...], stride: tuple[int, ...]) -> tuple[int, ...]:
    """:func:`tma_geometry` of a 16-bit layout (the part that does not
    depend on the address), computed once per layout."""
    b, h, s, d = shape
    if stride[3] != 1 or d % TMA_BOX[0]:
        raise ValueError(f"TMA: the head dimension must be contiguous and a multiple of "
                         f"{TMA_BOX[0]}, got D = {d}, strides {stride}")
    if min(shape) < 1:
        raise ValueError(f"TMA takes no empty extent, got {shape}")
    strides = []
    for extent, step, dense in ((s, stride[2], d), (h, stride[1], s * d),
                                (b, stride[0], h * s * d)):
        nbytes = (step if extent > 1 else dense) * 2
        if nbytes % 16 or not 0 < nbytes < _TMA_STRIDE_MAX:
            raise ValueError(f"TMA: byte strides must be multiples of 16 below 2^40, "
                             f"got strides {stride}")
        strides.append(nbytes)
    return (d, s, h, b, *strides, *TMA_BOX)


def wgmma_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block of the wgmma route at head
    dimension ``d``, as the built kernel requests it (builds on first use)."""
    return int(_library().flash_attention_wgmma_smem_bytes(int(d)))


def vector_rows(t: torch.Tensor) -> bool:
    """Is every row of ``t`` a whole number of 16-byte vectors starting on a
    16-byte boundary, so that the kernels move it as vectors?"""
    per_vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.shape[-1] % per_vec == 0 and t.data_ptr() % 16 == 0
            and all(s % per_vec == 0
                    for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1))


def kernel_takes(t: torch.Tensor) -> bool:
    """Can the kernel read ``t`` through its strides as it is: the last axis
    contiguous and, where a row is a whole number of 16-byte vectors, every
    row 16-byte aligned (other rows are read element by element)?"""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        return False
    return t.shape[-1] % (16 // t.element_size()) != 0 or vector_rows(t)


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
                             f"rows of whole 16-byte vectors 16-byte aligned, got "
                             f"strides {t.stride()}")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if (k.shape[0] != b or k.shape[3] != d or v.shape != k.shape
            or hkv == 0 or hq % hkv):
        raise ValueError(f"flash attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    route = flash_route(q.dtype, d)
    if max(sq, sk) > _INT_MAX or b > _GRID_MAX or hq > _GRID_MAX:
        raise ValueError(f"flash attention: shape {tuple(q.shape)} exceeds the grid")
    out = torch.empty_like(q)          # q's strides: q is dense or a dense view
    if out.numel() == 0:
        return out
    if sk == 0:                        # no row sees a key: every route's l == 0 guard gives 0
        return out.zero_()
    tma = None
    if route == "wgmma":
        geom = [n for t in (q, k, v) for n in tma_geometry(t)]
        tma = (ctypes.c_ulonglong * len(geom))(*geom)
    if scale is None:
        scale = float(d) ** -0.5
    vec = all(vector_rows(t) for t in (q, k, v, out))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        ROUTES[route], b, hq, hkv, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], int(vec), tma, int(bool(causal)),
        -1 if window is None else int(window), float(scale), stream)
    if err != 0:
        why = _HOST_ERRORS.get(err, f"cudaError {err}")
        raise RuntimeError(f"flash_attention {route} kernel launch failed: {why}")
    _LAUNCHES["flash_attention_cuda"] += 1
    return out


__all__ = ["HEAD_DIMS", "MAX_HEAD_DIM", "ROUTES", "TMA_BOX", "WGMMA_HEAD_DIMS",
           "flash_attention_cuda", "flash_route", "head_dim_instance", "kernel_takes",
           "launch_counts", "launch_work", "reset_launch_counts", "tma_geometry",
           "vector_rows", "visible_pairs", "wgmma_smem_bytes"]
