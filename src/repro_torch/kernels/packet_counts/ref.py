"""Plain PyTorch version of the packet counts: the fault engine's composition.

The oracle of the CUDA kernel in ``kernel.py`` and the route every CPU
tensor takes: :func:`~repro_torch.faults.packets.packet_on_time` builds each
decode mode's (S, B, M, n x r, P) masks and
:func:`~repro_torch.faults.packets.packet_counts` sums them, exactly as
the engine called them, with the per-row speeds and deadline as (B, 1, 1)
columns.
"""

from __future__ import annotations

import torch


def packet_counts_ref(states: torch.Tensor, loads: torch.Tensor, mu_g: torch.Tensor,
                      mu_b: torch.Tensor, deadline: torch.Tensor, r: int, packets: int,
                      trace=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(aon, conserve)`` (S, B, M, P) int32 counts from (B, M, n) states,
    (S, B, M, n) loads, (B,) speeds and deadline and a
    :class:`~repro_torch.faults.FaultTrace` (or ``None``)."""
    from repro_torch.faults.packets import packet_counts, packet_on_time

    col = lambda x: x[:, None, None]           # (B,) against (B, M, n)
    mg, mb, dl = col(mu_g), col(mu_b), col(deadline)
    return tuple(packet_counts(packet_on_time(states, loads, mg, mb, dl, r, packets,
                                              trace=trace, conserve=conserve))
                 for conserve in (False, True))


__all__ = ["packet_counts_ref"]
