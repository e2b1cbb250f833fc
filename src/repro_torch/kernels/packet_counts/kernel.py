"""CUDA wrapper of the fault engine's packet counts (sm_90a).

:func:`packet_counts_cuda` launches ``kernels/csrc/packet_counts.cu``
(which states the design and bound) once and returns both decode modes'
per-packet counts, all-or-nothing and conserving, as (S, B, M, P) int32
tensors allocated with ``torch.empty`` (the kernel writes every element).
It takes:

  * ``states`` (B, M, n) int32 and ``loads`` (S, B, M, n) int32;
  * ``mu_g``, ``mu_b``, ``deadline`` (B,) float32, one value a row;
  * ``t_cut`` (B, M, n) float32 and ``keep`` (B, M, n, r, P) bool, both
    or neither (neither: the no-fault trace, cut at the deadline and every
    packet kept).

Every tensor must be contiguous.  The layout is checked first (shape, dtype,
contiguity) and the device after it, so a CPU caller sees the same refusals;
the wrapper raises on anything the kernel does not take and never falls back
to the plain version.  The keep load's width is the widest of 16, 8, 4, 2
and 1 bytes that divides keep's address and every warp's offset
(:func:`vector_width`).  Each launch raises if it reports an error and
counts one (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.obs import counters as _obs_counters

_LAUNCHES = {"packet_counts_cuda": 0}
MAX_RP = 4096           # r x packets: a warp's keep bits in shared memory (the kernel's kMaxRP)


def launch_counts() -> dict[str, int]:
    """Launches of the kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


_obs_counters.register_launches("packet_counts", launch_counts, reset_launch_counts)

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built library with its C signature declared (first use builds)."""
    global _LIB
    if _LIB is None:
        lib = build.load("packet_counts")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.packet_counts_launch.argtypes = [p] * 9 + [
            ctypes.c_int64, ctypes.c_int64, i, i, i, i, i, p]
        lib.packet_counts_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be a {shape} {dtype} tensor, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def vector_width(n: int, rp: int, address: int) -> int:
    """The keep load's width in bytes: the widest of 16, 8, 4, 2 and 1 that
    divides ``address`` and the byte offset of every warp's batch of
    workers.  A warp takes the 32 / w rounds of an item (w the power of two
    >= n, so ``(32 // w) * n * rp`` bytes an item) or, past 32 workers, 32
    workers of a round (offsets multiples of ``rp * gcd(n, 32)``); ``rp`` is
    a worker's r x P bytes."""
    tile = 1 << (min(n, 32) - 1).bit_length()
    unit = (32 // tile) * n * rp if n <= 32 else rp * math.gcd(n, 32)
    width = 16
    while width > 1 and (unit % width or address % width):
        width //= 2
    return width


def packet_counts_cuda(states: torch.Tensor, loads: torch.Tensor, mu_g: torch.Tensor,
                       mu_b: torch.Tensor, deadline: torch.Tensor, r: int, packets: int,
                       t_cut: torch.Tensor | None = None,
                       keep: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(aon, conserve)`` (S, B, M, P) int32 counts in one launch."""
    if states.dim() != 3 or loads.dim() != 4:
        raise ValueError(f"states must be (B, M, n) and loads (S, B, M, n), got "
                         f"{tuple(states.shape)} and {tuple(loads.shape)}")
    r, packets = int(r), int(packets)
    if r < 1 or packets < 1 or r * packets > MAX_RP:
        raise ValueError(f"r and packets must be >= 1 with r x packets <= {MAX_RP}, got "
                         f"{r} and {packets}")
    b, m, n = states.shape
    s = loads.shape[0]
    _check("states", states, torch.int32, (b, m, n))
    _check("loads", loads, torch.int32, (s, b, m, n))
    for name, v in (("mu_g", mu_g), ("mu_b", mu_b), ("deadline", deadline)):
        _check(name, v, torch.float32, (b,))
    if (t_cut is None) != (keep is None):
        raise ValueError("t_cut and keep come together (a trace) or not at all")
    if t_cut is not None:
        _check("t_cut", t_cut, torch.float32, (b, m, n))
        _check("keep", keep, torch.bool, (b, m, n, r, packets))
    inputs = [states, loads, mu_g, mu_b, deadline] + ([t_cut, keep] if keep is not None else [])
    dev = states.device
    if dev.type != "cuda" or any(t.device != dev for t in inputs):
        raise ValueError(f"CUDA kernel called on tensors on "
                         f"{sorted({str(t.device) for t in inputs})}")
    aon = torch.empty((s, b, m, packets), dtype=torch.int32, device=dev)
    con = torch.empty_like(aon)
    if aon.numel() == 0 or n == 0:
        return aon.zero_(), con.zero_()
    ptr = lambda t: None if t is None else t.data_ptr()
    vec = vector_width(n, r * packets, keep.data_ptr()) if keep is not None else 16
    err = _library().packet_counts_launch(
        states.data_ptr(), loads.data_ptr(), ptr(t_cut), ptr(keep), mu_g.data_ptr(),
        mu_b.data_ptr(), deadline.data_ptr(), aon.data_ptr(), con.data_ptr(), b * m, m, n,
        r, packets, s, vec, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"packet_counts kernel launch failed: cudaError {err}")
    _LAUNCHES["packet_counts_cuda"] += 1
    return aon, con


__all__ = ["MAX_RP", "launch_counts", "packet_counts_cuda", "reset_launch_counts",
           "vector_width"]
