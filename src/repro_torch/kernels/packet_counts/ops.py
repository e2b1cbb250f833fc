"""The fault engine's packet counts, routed by the tensor
(:mod:`repro_torch.kernels.dispatch`): CUDA tensors go to the kernel
(:func:`packet_counts_cuda`, one launch), CPU tensors to the plain version
(:func:`packet_counts_ref`, the mask composition).  Both return the
all-or-nothing and the conserving counts, (S, B, M, P) int32, equal to the
bit where the composition divides as IEEE float32 does."""

from __future__ import annotations

from repro_torch.kernels.dispatch import PLAIN, route

from .kernel import packet_counts_cuda
from .ref import packet_counts_ref


def decode_counts(states, loads, mu_g, mu_b, deadline, r: int, packets: int, trace=None):
    """``(aon, conserve)`` counts of (B, M, n) ``states``, (S, B, M, n)
    ``loads``, (B,) ``mu_g`` / ``mu_b`` / ``deadline`` and a
    :class:`~repro_torch.faults.FaultTrace` (``None``: no faults)."""
    if route(states) == PLAIN:
        return packet_counts_ref(states, loads, mu_g, mu_b, deadline, r, packets, trace)
    t_cut, keep = (None, None) if trace is None else (trace.t_cut, trace.keep)
    return packet_counts_cuda(states, loads, mu_g, mu_b, deadline, r, packets, t_cut, keep)


__all__ = ["decode_counts"]
