"""repro_torch.faults — packet-level fault injection + partial-work conservation.

The paper's two-state Markov model makes a slow worker's round all-or-
nothing; real cloud rounds fail at finer grain — packets drop, preempted
workers leave partial results, nodes crash mid-job.  This package layers
those failure modes on top of the batched engine:

  * :mod:`~repro_torch.faults.channels` — composable, registry-driven fault
    injectors (worker crash/restart, preemption ramps, correlated burst
    loss, per-packet Bernoulli / Gilbert-Elliott erasure) producing a
    :class:`FaultTrace` — (B, rounds, n) work-cutoff times plus
    (B, rounds, n, r, packets) delivery masks — from the fault uniforms of
    a :class:`~repro_torch.random.FaultDraws` (cf. *Coded Distributed
    Computing over Packet Erasure Channels*, arXiv 1901.03610);
  * :mod:`~repro_torch.faults.packets` — ``chunk_on_time`` generalised to
    packets-within-chunks with a partial-work-conserving prefix rule,
    per-packet float and exact GF(p) decodes (equal to the all-or-nothing
    path at packets=1 with no faults), and a hierarchical two-layer
    recovery option (cf. *Hierarchical Coded Elastic Computing*, arXiv
    2206.09399);
  * :mod:`~repro_torch.faults.engine` — the batched fault sweep: one pass
    scores all-or-nothing vs conserving vs hierarchical decode per round
    per strategy on SHARED trajectories and SHARED fault traces, every
    row of a parameter grid carrying its own channel parameters.
"""

from .channels import (FaultTrace, apply_channel, base_trace, injector_names,
                       make_channel, make_injector, register_injector)
from .engine import FaultOutcomes, simulate_faults, sweep_faults
from .packets import (coded_matmul_exact_packets, coded_matmul_packets,
                      layer1_recovery, packet_counts, packet_on_time)

__all__ = [
    "FaultOutcomes", "FaultTrace", "apply_channel", "base_trace",
    "coded_matmul_exact_packets", "coded_matmul_packets", "injector_names",
    "layer1_recovery", "make_channel", "make_injector", "packet_counts",
    "packet_on_time", "register_injector", "simulate_faults", "sweep_faults",
]
