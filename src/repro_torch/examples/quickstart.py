"""Quickstart: one round of Lagrange-coded computation with LEA allocation,
then a whole paper-scale scenario grid in one line — the port of the JAX
package's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart          # the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --cpu    # the CPU

Encodes a dataset across 5 simulated workers, lets LEA pick the per-worker
loads from its state estimates — the estimator's predictions after round 1
AND after round 2 are stacked on a leading axis and solved by ONE allocator
DP — drops the stragglers, and decodes the matmul from the K* fastest
results, in float32 and exactly over GF(2^31 - 1).  Finishes with the
``repro_torch.sweeps`` one-liner that replays a slice of the paper's Fig. 3
Monte-Carlo grid, then a ``repro_torch.policies`` comparison on a drifting
(non-stationary) chain where windowed LEA beats vanilla LEA.

Smoke knob: REPRO_QUICKSTART_ROUNDS overrides the sweep length.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from repro_torch import sweeps
from repro_torch.core import (FIELD_P, CodeSpec, LoadParams, allocate,
                              coded_matmul, coded_matmul_exact, encode_dataset,
                              encode_dataset_modp, init_estimator, matmul_modp,
                              predicted_good_prob, update_estimator)
from repro_torch.device import resolve_device


def sweep_lines(fig3, drifting) -> list[str]:
    """The example's printed sweep rows for the two sweeps' results."""
    lines = [f"{r.name}: " + " ".join(f"R_{s}={v:.3f}" for s, v in r.throughput.items())
             + f"  lea/static={r.ratio['lea']:.2f}x" for r in fig3]
    lines += [f"{r.name}: R_lea={r.throughput['lea']:.3f} "
              f"R_lea_window64={r.throughput['lea_window64']:.3f} "
              f"regret: lea={r.regret['lea']:.0f} lea_window64={r.regret['lea_window64']:.0f}"
              for r in drifting]
    return lines


def run(device=None, rounds: int | None = None, draws=None, echo=print) -> dict:
    """The quickstart on ``device`` (``None`` means ``"cuda"``).

    ``rounds`` defaults to ``REPRO_QUICKSTART_ROUNDS`` (else 500); ``draws``
    maps each sweep group to its draws source (default: the group's own
    generator).  Returns the sweeps' results and the printed sweep rows.
    """
    dev = resolve_device(device)
    if rounds is None:
        rounds = int(os.environ.get("REPRO_QUICKSTART_ROUNDS", "500"))

    # -- a 5-worker cluster storing r=2 coded chunks each, k=6 data chunks ---
    spec = CodeSpec(n=5, r=2, k=6, deg_f=1)
    echo(f"code: mode={spec.mode}, recovery threshold K*={spec.recovery_threshold}")
    rng = np.random.default_rng(0)
    x_chunks = torch.as_tensor(rng.normal(size=(spec.k, 16, 8)), dtype=torch.float32,
                               device=dev)
    w = torch.as_tensor(rng.normal(size=(8,)), dtype=torch.float32, device=dev)
    coded = encode_dataset(spec, x_chunks)       # "stored at the workers"

    # -- LEA: estimate worker states, allocate two-level loads ---------------
    # the predictions after round 1 and after round 2 go through ONE (2, n)
    # allocator DP, as the engine allocates every round of a sweep at once
    lp = LoadParams(n=spec.n, kstar=spec.recovery_threshold, ell_g=2, ell_b=1)
    est = init_estimator(spec.n, device=dev)
    obs = lambda s: torch.tensor(s, dtype=torch.int32, device=dev)
    est = update_estimator(est, obs([1, 1, 0, 1, 0]))          # observed round 1
    p_good_r1 = predicted_good_prob(est)
    est = update_estimator(est, obs([1, 0, 0, 1, 1]))          # observed round 2
    p_good = predicted_good_prob(est)
    loads_b, i_star_b = allocate(torch.stack([p_good_r1, p_good]), lp)   # one DP
    for rnd, (p, ld, i) in enumerate(zip((p_good_r1, p_good), loads_b, i_star_b), 1):
        echo(f"after round {rnd}: P[good]~{np.round(p.cpu().numpy(), 3)}"
             f" -> loads {ld.cpu().numpy()} (i*={int(i)})")
    loads = loads_b[-1].cpu().numpy()            # act on the freshest estimate

    # -- the network decides who is on time; master decodes from any K* ------
    true_states = np.array([1, 0, 0, 1, 1])      # worker 1,2 slow this round
    on_time = np.zeros(spec.nr, bool)
    for i in range(spec.n):
        done = int(loads[i]) if (true_states[i] or loads[i] <= lp.ell_b) else 0
        on_time[i * spec.r: i * spec.r + done] = True
    echo(f"on-time encoded chunks: {int(on_time.sum())}/{spec.nr}")

    result = coded_matmul(coded, w, on_time)
    expected = torch.einsum("krc,c->kr", x_chunks, w)
    err = float((result - expected).abs().max())
    echo(f"decoded f(X_j) = X_j @ w for all {spec.k} chunks, max err {err:.2e}")
    if not err < 1e-3:
        raise AssertionError(f"float decode error {err} >= 1e-3")

    # -- the same round, EXACT over the paper's finite field GF(2^31 - 1) ----
    rng_x = np.random.default_rng(1)
    x_int = rng_x.integers(0, FIELD_P, size=(spec.k, 16, 8), dtype=np.int64)
    w_int = rng_x.integers(0, FIELD_P, size=(8,), dtype=np.int64)
    coded_x = encode_dataset_modp(spec, x_int.astype(np.int32), device=dev)
    out, ok = coded_matmul_exact(coded_x, torch.as_tensor(w_int.astype(np.int32), device=dev),
                                 torch.as_tensor(on_time, device=dev))
    exact_want = matmul_modp(x_int.reshape(-1, 8), w_int.reshape(-1, 1)).reshape(spec.k, 16)
    if not bool(ok) or not np.array_equal(out.cpu().numpy().astype(np.int64), exact_want):
        raise AssertionError("exact decode differs from the numpy modp oracle")
    echo(f"exact GF(p) decode: bit-identical to the numpy oracle (p = {FIELD_P})")

    # -- the paper's Fig. 3 grid, through the sweep subsystem, in one line ---
    fig3 = sweeps.run("fig3", rounds=rounds, draws=draws, device=dev)
    for r in fig3:
        if not r.throughput["lea"] >= r.throughput["static"]:
            raise AssertionError(f"{r.name}: LEA below static")
    # -- pluggable policies: on a drifting chain, windowed LEA tracks the
    # regime while vanilla LEA's all-history counts lag
    drifting = sweeps.run("drifting_chains", periods=(150,), rounds=max(rounds, 300),
                          step=25, draws=draws, device=dev)
    lines = sweep_lines(fig3, drifting)
    for line in lines:
        echo(line)
    echo("OK")
    return {"fig3": fig3, "drifting": drifting, "lines": lines,
            "kstar": spec.recovery_threshold}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run("cpu" if "--cpu" in argv else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
