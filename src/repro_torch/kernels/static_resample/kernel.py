"""CUDA wrapper of the static resampler's try (sm_90a).

:class:`StaticResampleCuda` holds one block's state on the card and
launches ``kernels/csrc/static_resample.cu`` (which states the design and
bound) once a try.  The state, allocated with ``torch.zeros``:

  * ``loads`` (S, B, m, n) int32, written in place, already masked;
  * ``done`` (S, B, m) bool, the ``feasible`` flags at the end;
  * ``counts`` (2,) int64, the unfinished pairs the host reads before try
    t in slot t % 2.  Before the first try slot 0 holds the pairs whose
    row has K* > 0, since a round of zero loads is short of any positive
    K*.

The constructor takes K*, ell_g and ell_b as the engine hands them over: a
Python int (a :class:`~repro_torch.core.lea.LoadParams` field, broadcast to
every row) or a tensor of B values in any broadcastable shape, and the mask
as (B, n) bool or ``None``.  It checks device, dtype, shape and contiguity
and raises on what the kernel does not take; each try checks the uniforms
the same way, launches on the current stream, raises if the launch reports
an error and counts one launch (:func:`launch_counts`).  It never falls
back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.obs import counters as _obs_counters

_LAUNCHES = {"static_resample_cuda": 0}


def launch_counts() -> dict[str, int]:
    """Launches of the kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


_obs_counters.register_launches("static_resample", launch_counts, reset_launch_counts)

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (first use builds)."""
    global _LIB
    if _LIB is None:
        lib = build.load("static_resample")
        p = ctypes.c_void_p
        lib.static_resample_try.argtypes = [p] * 9 + [
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, p]
        lib.static_resample_try.restype = ctypes.c_int
        lib.static_resample_max_s.argtypes = []
        lib.static_resample_max_s.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _per_row(v, b: int, dev: torch.device, name: str) -> torch.Tensor:
    """(B,) int32 on ``dev``: a Python int broadcast, or B values."""
    if not isinstance(v, torch.Tensor):
        return torch.full((b,), int(v), dtype=torch.int32, device=dev)
    if v.device != dev or v.dtype != torch.int32 or v.numel() != b:
        raise ValueError(f"{name} must hold B={b} int32 values on {dev}, got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")
    return v.reshape(b).contiguous()


class StaticResampleCuda:
    """One block of ``m`` rounds of the resampler on the card."""

    def __init__(self, pis, m: int, kstar, ell_g, ell_b, mask=None):
        dev = pis[0].device
        if dev.type != "cuda":
            raise ValueError(f"CUDA kernel called on a {dev} tensor")
        b, n = pis[0].shape
        max_s = _library().static_resample_max_s()
        if not 1 <= len(pis) <= max_s:
            raise ValueError(f"{len(pis)} strategies: the kernel takes 1 to {max_s}")
        for pi in pis:
            if pi.device != dev or pi.dtype != torch.float32 or pi.shape != (b, n):
                raise ValueError(f"pis must be ({b}, {n}) float32 tensors on {dev}, got "
                                 f"{pi.dtype} {tuple(pi.shape)} on {pi.device}")
        if mask is not None:
            if mask.device != dev or mask.dtype != torch.bool or mask.shape != (b, n):
                raise ValueError(f"mask must be a ({b}, {n}) bool tensor on {dev}, got "
                                 f"{mask.dtype} {tuple(mask.shape)} on {mask.device}")
            if not mask.is_contiguous():
                raise ValueError("mask must be contiguous")
        s = len(pis)
        self.shape = (b, m, n)
        self.pis = torch.stack(pis)
        self.kstar = _per_row(kstar, b, dev, "kstar")
        self.ell_g = _per_row(ell_g, b, dev, "ell_g")
        self.ell_b = _per_row(ell_b, b, dev, "ell_b")
        self.mask = mask                  # kept alive: the kernel reads it
        self.loads = torch.zeros((s, b, m, n), dtype=torch.int32, device=dev)
        self.done = (self.kstar <= 0)[None, :, None].expand(s, b, m).contiguous()
        self.counts = torch.zeros(2, dtype=torch.int64, device=dev)
        self.counts[0] = (self.kstar > 0).sum() * (s * m)
        self._slots = (self.counts[0], self.counts[1])
        self._tries = 0

    def unfinished(self) -> int:
        """The unfinished (strategy, round) pairs: the one host read a try."""
        return int(self._slots[self._tries % 2])

    def redraw(self, u: torch.Tensor) -> None:
        """One try: every unfinished pair redrawn from ``u`` (B, m, n).
        Call :meth:`unfinished` first: the launch clears the count it read."""
        if u.device != self.loads.device or u.dtype != torch.float32 \
                or tuple(u.shape) != self.shape:
            raise ValueError(f"u must be a {self.shape} float32 tensor on "
                             f"{self.loads.device}, got {u.dtype} {tuple(u.shape)} "
                             f"on {u.device}")
        if not u.is_contiguous():
            raise ValueError("u must be contiguous")
        b, m, n = self.shape
        mask = None if self.mask is None else self.mask.data_ptr()
        err = _library().static_resample_try(
            u.data_ptr(), self.pis.data_ptr(), self.kstar.data_ptr(),
            self.ell_g.data_ptr(), self.ell_b.data_ptr(), mask, self.loads.data_ptr(),
            self.done.data_ptr(), self.counts.data_ptr(), self._tries % 2, b, m, n,
            len(self.pis), torch.cuda.current_stream(u.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"static_resample kernel launch failed: cudaError {err}")
        _LAUNCHES["static_resample_cuda"] += 1
        self._tries += 1

    def result(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """``[(loads (B, m, n) int32, feasible (B, m) bool)]`` a strategy."""
        return [(self.loads[j], self.done[j]) for j in range(len(self.pis))]


__all__ = ["StaticResampleCuda", "launch_counts", "reset_launch_counts"]
