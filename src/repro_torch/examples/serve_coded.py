"""Online coded-computation service (the paper's EC2 workload, Sec. 6.2) —
the port of the JAX package's ``examples/serve_coded.py``: linear requests
f_m(X_j) = X_j^T b_m arrive with shift-exponential gaps and a hard
per-round deadline; the service uses LEA to allocate worker loads and
decodes each round from the K* fastest results.

    PYTHONPATH=src python -m repro_torch.examples.serve_coded          # the card
    PYTHONPATH=src python -m repro_torch.examples.serve_coded --cpu    # the CPU

Two stages, both on the batched engine:

  1. OFFLINE: one ``throughput.rollout`` samples the trajectory and every
     round's LEA loads, ``chunk_on_time`` derives every round's erasure
     pattern in one vectorised call, and a few served rounds are decoded
     EXACTLY over GF(2^31 - 1) with ``coded_matmul_exact`` (the GF(p)
     matmul kernel on the card) and checked against the numpy mod-p oracle
     bit for bit (k = 50 is far beyond float-decode conditioning — the
     paper's protocol is finite-field).
  2. STREAMING: ``repro_torch.serving.simulate_serving`` runs the same
     pool as an online service — shift-exponential arrivals feed a request
     queue on the device, EDF water-filling splits the workers across
     in-flight requests, and admission control sheds requests the pool
     would miss — with full per-request accounting.

Smoke knob: REPRO_EXAMPLE_ROUNDS overrides the round count.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from repro_torch import serving
from repro_torch.core import (FIELD_P, CodeSpec, LoadParams, chunk_on_time,
                              coded_matmul_exact, encode_dataset_modp, matmul_modp)
from repro_torch.core import throughput
from repro_torch.device import resolve_device

N, R, K = 15, 10, 50              # paper Sec. 6.2, scenario 5/6 scale (k=50)
MU_G, MU_B, D = 10.0, 1.0, 6.0    # 10x credit gap (Fig. 1), d=6s
P_GG, P_BB = 0.85, 0.6
T_C, MEAN = 0.2, 0.8              # shift-exp arrival gaps, in round units


def run(device=None, rounds: int | None = None, draws=None, echo=print) -> dict:
    """The example on ``device`` (``None`` means ``"cuda"``).

    ``rounds`` defaults to ``REPRO_EXAMPLE_ROUNDS`` (else 200).  Both
    stages run on seed 0 — the same trajectory, as the JAX example runs
    both on one key — unless ``draws`` gives the pair ``(offline,
    streaming)`` of draws sources (the streaming one also answers
    :class:`~repro_torch.random.ArrivalDraws`).  Returns the counts the
    example prints.
    """
    dev = resolve_device(device)
    if rounds is None:
        rounds = int(os.environ.get("REPRO_EXAMPLE_ROUNDS", "200"))
    offline_draws, stream_draws = (0, 0) if draws is None else draws

    spec = CodeSpec(N, R, K, deg_f=1)
    lp = LoadParams(n=N, kstar=spec.recovery_threshold,
                    ell_g=int(min(MU_G * D, R)), ell_b=int(MU_B * D))
    echo(f"service: n={N} workers, K*={lp.kstar}, loads ({lp.ell_g}/{lp.ell_b})")

    rng = np.random.default_rng(0)
    x_int = rng.integers(0, FIELD_P, size=(K, 6, 32), dtype=np.int64)
    coded = encode_dataset_modp(spec, x_int.astype(np.int32), device=dev)

    # -- 1. offline: one rollout, every round's loads + erasure patterns ------
    p_gg, p_bb = [P_GG] * N, [P_BB] * N
    states, loads, feasible = throughput.rollout(offline_draws, lp, p_gg, p_bb, rounds,
                                                 strategies=("lea",), device=dev)
    success = throughput.score_rollout(states, loads, feasible, lp, MU_G, MU_B, D)  # (M, 1)
    on_time = chunk_on_time(states, loads, MU_G, MU_B, D, R)
    served_rounds = success[:, 0].cpu().numpy()
    served = int(served_rounds.sum())

    # decode a few served rounds exactly and check the numpy mod-p oracle
    checked = 0
    for m in np.flatnonzero(served_rounds):
        b_int = rng.integers(0, FIELD_P, size=(32,), dtype=np.int64)
        out, ok = coded_matmul_exact(coded, torch.as_tensor(b_int.astype(np.int32), device=dev),
                                     on_time[0, m])
        want = np.stack([matmul_modp(x_int[j], b_int.reshape(-1, 1))[:, 0]
                         for j in range(K)])
        if not bool(ok) or not np.array_equal(out.cpu().numpy().astype(np.int64), want):
            raise AssertionError(f"round {m}: exact decode differs from the numpy oracle")
        checked += 1
        if checked >= 4:
            break
    echo(f"decode : {checked} served rounds decoded from K*={lp.kstar} "
         f"fastest results over GF(p), bit-exact vs the numpy oracle")
    echo(f"timely computation throughput: {served / rounds:.3f} "
         f"({served}/{rounds} rounds)")
    if not served / rounds > 0.5:
        raise AssertionError(f"timely throughput {served / rounds} <= 0.5")

    # -- 2. streaming: the same pool as an online service ---------------------
    process = serving.make_process("shift_exp", t_const=T_C, mean=MEAN)
    req = serving.RequestSpec(
        kstar=lp.kstar, ell_g=lp.ell_g, ell_b=lp.ell_b,
        deadline_rel=1,            # finish by the round after arrival
        admit_threshold=0.5, reserve_cap=1.0,
    )
    out = serving.simulate_serving(
        stream_draws, torch.ones(N, dtype=torch.bool), p_gg, p_bb,
        MU_G, MU_B, D, req, process,
        rounds=rounds, strategies=("lea",), capacity=4, device=dev,
    )
    arr, adm, on_t, late, rej, exp, fly = (
        int(getattr(out, f)[0]) for f in ("arrivals", "admitted", "served_on_time",
                                          "served_late", "rejected", "expired", "in_flight"))
    ev, sj = out.events[0].cpu().numpy(), out.sojourn[0].cpu().numpy()
    lat = sj[ev != 0]
    echo(f"stream : {arr} arrivals (shift-exp gaps {T_C}+Exp({MEAN}) rounds), "
         f"{adm} admitted, {on_t} served on time, {rej} shed by admission")
    echo(f"stream : service throughput {on_t / max(arr, 1):.3f}, "
         f"median sojourn {np.median(lat) if lat.size else 0:.0f} round(s)")
    # every request ends in exactly one disposition
    if arr != adm + rej or adm != on_t + late + exp + fly:
        raise AssertionError(f"accounting identities fail: {arr} arrivals, {adm} admitted, "
                             f"{rej} shed, {on_t}/{late}/{exp}/{fly}")
    if not on_t > 0:
        raise AssertionError("no request served on time")
    echo("OK")
    return {"served": served, "rounds": rounds, "checked": checked, "arrivals": arr,
            "admitted": adm, "served_on_time": on_t, "served_late": late,
            "rejected": rej, "expired": exp, "in_flight": fly}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run("cpu" if "--cpu" in argv else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
