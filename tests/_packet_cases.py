"""Inputs of the fault engine's packet counts, shared by the CPU and the card
tests (no JAX here): four rows of ``rounds`` rounds in the shapes the engine
hands over, with the edges the counts must get right.

  * row 0 keeps every packet, row 1 none;
  * round 0 carries loads 0 and round 1 loads r, for every strategy;
  * the last row's last worker is masked out of the pool (loads 0);
  * about 30% of the cutoffs are preempted at a uniform fraction of the
    deadline and about 10% crashed (0);
  * the rows' speeds and deadlines differ, so a worker's conserving prefix
    stops anywhere in its r x P packets.
"""

from __future__ import annotations

import torch

from repro_torch.faults import FaultTrace

MU_G = (10.0, 4.0, 7.0, 10.0)
MU_B = (3.0, 1.5, 2.3, 3.0)
DEADLINE = (1.0, 0.8, 1.3, 1.0)


def count_inputs(device, s: int, n: int, r: int, packets: int, *, rounds: int = 37,
                 seed: int = 0, trace: bool = True):
    """``(states, loads, mu_g, mu_b, deadline, trace)`` on ``device``:
    (4, rounds, n) int32, (s, 4, rounds, n) int32, three (4,) float32 and a
    :class:`FaultTrace` (``None`` without ``trace``)."""
    gen = torch.Generator().manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=gen)
    rows = len(MU_G)
    states = (u(rows, rounds, n) < 0.6).to(torch.int32)
    loads = torch.randint(0, r + 1, (s, rows, rounds, n), generator=gen, dtype=torch.int32)
    loads[:, :, 0] = 0
    loads[:, :, 1] = r
    loads[:, -1, :, -1] = 0
    mu_g, mu_b, deadline = (torch.tensor(v, dtype=torch.float32) for v in (MU_G, MU_B, DEADLINE))
    t_cut = deadline[:, None, None].expand(rows, rounds, n).clone()
    hit = u(rows, rounds, n)
    t_cut = torch.where(hit < 0.3, t_cut * u(rows, rounds, n), t_cut)
    t_cut = torch.where(hit > 0.9, 0.0, t_cut)
    keep = u(rows, rounds, n, r, packets) >= 0.2
    keep[0] = True
    keep[1] = False
    to = lambda x: x.to(device)
    out = (to(states), to(loads), to(mu_g), to(mu_b), to(deadline))
    return out + ((FaultTrace(to(t_cut), to(keep)) if trace else None),)


def composition(states, loads, mu_g, mu_b, deadline, r: int, packets: int, trace):
    """Both modes' counts as the fault engine composed them before the
    kernel: ``packet_counts(packet_on_time(...))``, speeds and deadline as
    (B, 1, 1) columns."""
    from repro_torch import faults

    col = lambda x: x[:, None, None]
    return tuple(faults.packet_counts(faults.packet_on_time(
        states, loads, col(mu_g), col(mu_b), col(deadline), r, packets, trace=trace,
        conserve=conserve)) for conserve in (False, True))
