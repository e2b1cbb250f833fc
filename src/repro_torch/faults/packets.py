"""Packets-within-chunks: the erasure model below chunk granularity.

``coded_ops.chunk_on_time`` is all-or-nothing per worker: a worker whose
whole load misses the deadline contributes nothing.  Here each chunk's
result rows are split into ``packets`` equal blocks streamed out as they
finish, giving two refinements.

Partial-work conservation (the ``conserve=True`` rule)
------------------------------------------------------
Worker i evaluates its assigned prefix of chunks in order, emitting packet
q of its j-th chunk at time ``(j + (q+1)/packets) / speed``.  A packet is
on time iff that instant is within the worker's cutoff ``t_cut`` (the
deadline, shortened by crash/preemption injectors) AND the network kept it
(``FaultTrace.keep``).  A preempted worker's finished packets therefore
still count (cf. *Hierarchical Coded Elastic Computing*, arXiv 2206.09399).

All-or-nothing reference (``conserve=False``)
---------------------------------------------
A worker's packets all arrive iff its WHOLE load meets ``t_cut``: the
expression ``loads.float() / speeds <= t_cut + 1e-9`` of
:func:`repro_torch.core.coded_ops.chunk_on_time`, kept literally.  Two
properties follow:

  * AON ⊆ conserve, bitwise: the conserving numerator of worker i's last
    assigned packet is ``(loads-1) + packets/packets = loads``, the SAME
    float32 value the AON rule divides, and earlier packets have strictly
    smaller numerators;
  * at ``packets=1`` on the no-fault trace the AON mask reshaped to chunks
    IS ``chunk_on_time`` bit for bit, and the per-packet decodes below call
    the same ``_decode_on_time`` / ``_decode_on_time_modp``, so the packet
    path degrades to the all-or-nothing path exactly.

Per-packet decode
-----------------
LCC decode is row-wise: decoded chunk rows are fixed linear (or GF(p))
combinations of the SAME rows of the received evaluations, so packet q of
every output chunk decodes from any K* chunk evaluations whose packet q
arrived.  :func:`coded_matmul_packets` (float) and
:func:`coded_matmul_exact_packets` (GF(p)) run the device decode once per
packet index on the row block ``results[:, q*rp:(q+1)*rp]`` (a strided
view: the decode's gather copies only the (K*, rp, d) rows it needs) and
concatenate the blocks.  On the card the exact path's worker product and
every decode are the GF(p) matmul kernel, which reads x~ as it lies.

Hierarchical two-layer option
-----------------------------
``layer1_recovery`` models a second, lower-rate code protecting the first
``p1`` packet indices of a smaller ``k1``-chunk summary (threshold
``K1 = (k1-1) deg_f + 1 < K*``): when the full decode is infeasible, the
round can still be served PARTIALLY from the layer-1 packets.
"""

from __future__ import annotations

import torch

from repro_torch.core.coded_ops import (CodedDataset, CodedDatasetModp,
                                        _decode_on_time, _decode_on_time_modp,
                                        _on_device, _worker_results)
from repro_torch.kernels import gf

from .channels import FaultTrace


def packet_on_time(
    states: torch.Tensor,
    loads: torch.Tensor,
    mu_g,
    mu_b,
    deadline,
    r: int,
    packets: int,
    trace: FaultTrace | None = None,
    conserve: bool = True,
) -> torch.Tensor:
    """Per-packet on-time masks: (..., n) states/loads -> (..., n*r, packets).

    The packet generalisation of :func:`repro_torch.core.coded_ops.chunk_on_time`
    (same speed model, same deadline tolerance; see the module docstring).
    ``trace`` supplies (..., n) cutoffs and (..., n, r, packets) delivery
    masks; ``None`` is the no-fault trace.  ``mu_g`` / ``mu_b`` /
    ``deadline`` are scalars or tensors broadcastable against ``states``.
    Leading axes broadcast: (B, M, n) states with (S, B, M, n) loads and a
    (B, M, n) trace score every strategy against the SAME faults.
    """
    speeds = torch.where(states == 1, mu_g, mu_b)                   # (..., n)
    if trace is not None:
        dl = torch.as_tensor(deadline, dtype=torch.float32, device=states.device)
        t_cut = torch.minimum(trace.t_cut, dl)
        tc = t_cut[..., None, None]                                 # (..., n, 1, 1)
    else:
        # the deadline kept as given, so the AON comparison below is the
        # expression chunk_on_time evaluates (bit-identity anchor)
        t_cut = deadline
        tc = deadline if not isinstance(deadline, torch.Tensor) else deadline[..., None, None]
    if conserve:
        # packet q of assigned chunk j completes at (j + (q+1)/P) / speed
        frac = (torch.arange(packets, dtype=torch.float32, device=states.device)
                + 1.0) / packets
        num = torch.arange(r, dtype=torch.float32, device=states.device)[:, None] + frac
        done = num / speeds[..., None, None] <= tc + 1e-9          # (..., n, r, P)
    else:
        whole = loads.float() / speeds <= t_cut + 1e-9
        done = whole[..., None, None]
    assigned = torch.arange(r, device=states.device) < loads[..., None]   # (..., n, r)
    ok = done & assigned[..., None]
    if trace is not None:
        ok = ok & trace.keep
    ok = torch.broadcast_to(ok, ok.shape[:-2] + (r, packets))
    return ok.reshape(ok.shape[:-3] + (ok.shape[-3] * r, packets))


def packet_counts(packet_masks: torch.Tensor) -> torch.Tensor:
    """(..., nr, packets) masks -> (..., packets) int32 received counts:
    the chunk evaluations whose packet q arrived, compared against K*."""
    return packet_masks.sum(dim=-2, dtype=torch.int32)


def layer1_recovery(counts: torch.Tensor, k1_threshold, p1: int) -> torch.Tensor:
    """(..., packets) counts -> (...,) layer-1 (partial) decodability: every
    one of the first ``p1`` packet indices reached ``K1`` (a scalar or a
    tensor broadcastable against ``counts[..., :p1]``)."""
    return torch.all(counts[..., :p1] >= k1_threshold, dim=-1)


def _split_rows(results: torch.Tensor, packets: int) -> int:
    rows = results.shape[1]
    if rows % packets != 0:
        raise ValueError(
            f"chunk rows ({rows}) must divide into packets ({packets})"
        )
    return rows // packets


def coded_matmul_packets(
    coded: CodedDataset, w: torch.Tensor, packet_masks: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-packet float decode of f(X_j) = X_j @ w.

    ``packet_masks`` is (nr, packets) from :func:`packet_on_time`.  Returns
    ``(decoded (k, rows[, d]), ok (packets,))``; packet q's rows are
    meaningful only where ``ok[q]``.  At ``packets=1`` this is
    :func:`~repro_torch.core.coded_ops.coded_matmul_device`'s computation.
    """
    packets = packet_masks.shape[-1]
    results = _worker_results(coded.x_tilde, w)                     # (nr, rows, ...)
    rp = _split_rows(results, packets)
    outs, oks = [], []
    for q in range(packets):
        out_q, ok_q = _decode_on_time(
            coded.spec, results[:, q * rp:(q + 1) * rp], packet_masks[:, q]
        )
        outs.append(out_q)
        oks.append(ok_q)
    return torch.cat(outs, dim=1), torch.stack(oks)


def coded_matmul_exact_packets(
    coded: CodedDatasetModp, w, packet_masks: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-packet EXACT GF(p) decode, the finite-field twin of
    :func:`coded_matmul_packets`.

    One exact worker product over every chunk (x~ read as it lies), then
    ``_decode_on_time_modp`` per packet block, so at ``packets=1`` the
    computation, and its bit-exactness against the numpy modp oracle, is
    :func:`~repro_torch.core.coded_ops.coded_matmul_exact`'s.
    """
    packets = packet_masks.shape[-1]
    w = _on_device(w, coded.x_tilde.device)
    squeeze = w.dim() == 1
    w2 = w[:, None] if squeeze else w
    nr, rows = coded.x_tilde.shape[0], coded.x_tilde.shape[1]
    flat = coded.x_tilde.reshape(nr * rows, -1)
    results = gf.from_gf(gf.matmul_gf(flat, w2)).reshape(nr, rows, w2.shape[1])
    rp = _split_rows(results, packets)
    outs, oks = [], []
    for q in range(packets):
        out_q, ok_q = _decode_on_time_modp(
            coded.spec, results[:, q * rp:(q + 1) * rp], packet_masks[:, q]
        )
        outs.append(out_q)
        oks.append(ok_q)
    out = torch.cat(outs, dim=1)
    return (out[..., 0] if squeeze else out), torch.stack(oks)


__all__ = ["coded_matmul_exact_packets", "coded_matmul_packets",
           "layer1_recovery", "packet_counts", "packet_on_time"]
