"""Deadline-constrained coded linear regression, LEA vs static — the port of
the JAX package's ``examples/coded_regression.py`` (the paper's Sec. 2.1
example, deg f = 2, over a simulated credit-based cluster).

    PYTHONPATH=src python -m repro_torch.examples.coded_regression          # the card
    PYTHONPATH=src python -m repro_torch.examples.coded_regression --cpu    # the CPU

Each round evaluates the gradient f(X_j, y_j) = X_j^T (X_j w - y_j) on
Lagrange-encoded data; rounds that miss the deadline are lost (no update).
LEA learns the workers' Markov dynamics and sustains a higher timely
throughput, so it converges while the static allocation starves.

One engine rollout samples the trajectory and allocates every round for
both strategies; the per-chunk on-time masks come from one ``chunk_on_time``
call.  Only the gradient-descent recursion runs round by round, decoding
through a memoised ``DecodeCache``.  The data are encoded with the routed
Lagrange-encode op and each round's worker gradients come from the routed
fused-gradient op: on the card, the hand-written kernels.

Exact-path variant: the float descent is the ML adaptation (decode
conditioning caps k); the paper's protocol is exact over a finite field.
The last section replays the same LEA straggler patterns through the exact
degree-2 gradient ``coded_linear_gradient_modp`` over GF(2^31 - 1) and
checks every decoded gradient against the numpy ``matmul_modp`` /
``decode_matrix_modp`` oracle to the last bit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.core import (FIELD_P, CodeSpec, DecodeCache, chunk_on_time,
                              coded_linear_gradient, coded_linear_gradient_modp,
                              decode_matrix_modp, encode_dataset,
                              encode_dataset_modp, matmul_modp, throughput)
from repro_torch.core.lea import LoadParams
from repro_torch.device import resolve_device

# k: the decode interpolates a degree-(k-1)*2 polynomial; over the reals in
# float32 that is well-conditioned up to k ~ 10 (the exact GF(p) path covers
# large k exactly).
N, R, K = 10, 6, 8
MU_G, MU_B, D = 6.0, 1.0, 1.0
P_GG, P_BB = 0.85, 0.7
ROUNDS = 120
ROWS, COLS = 20, 12
STRATEGIES = ("lea", "static_equal")   # paper's iid prob-1/2 static benchmark
EXACT_CHECKS = 6


def _descend(coded, x, y, success, on_time, j: int, rounds: int):
    """Gradient descent over the successful rounds of strategy ``j``."""
    cache = DecodeCache(coded.spec)
    w = torch.zeros((COLS,), dtype=torch.float32, device=x.device)
    lr = 2e-2 / (K * ROWS)
    hits, losses = 0, []
    for m in range(rounds):
        if success[m, j]:
            hits += 1
            grad = coded_linear_gradient(coded, w, on_time[j, m], cache=cache)
            # float-decode sanity guard: an ill-conditioned received set (rare
            # under the strided alphas, possible under static's all-or-nothing
            # patterns) is treated as a failed round, like a checksum miss.
            gnorm = float(torch.linalg.norm(grad))
            if not np.isfinite(gnorm) or gnorm > 1e4 * K * ROWS:
                hits -= 1
            else:
                w = w - lr * grad
        losses.append(float(torch.mean((x @ w - y) ** 2)))
    return hits / rounds, w, losses


def _exact_rounds(spec, on_time, dev) -> int:
    """The exact degree-2 gradient on the first LEA rounds with >= K*
    results, each checked against the numpy oracle; returns the count."""
    rng_x = np.random.default_rng(1)
    x_int = rng_x.integers(0, FIELD_P, size=(K, ROWS, COLS), dtype=np.int64)
    y_int = rng_x.integers(0, FIELD_P, size=(K, ROWS), dtype=np.int64)
    w_int = rng_x.integers(0, FIELD_P, size=(COLS,), dtype=np.int64)
    coded_x = encode_dataset_modp(spec, x_int, y_int, device=dev)
    xt_np = coded_x.x_tilde.cpu().numpy().astype(np.int64)
    yt_np = coded_x.y_tilde.cpu().numpy().astype(np.int64)
    w_dev = torch.as_tensor(w_int.astype(np.int32), device=dev)
    # round-invariant worker-side chunk gradients, by the numpy oracle
    grads_np = np.stack([
        matmul_modp(
            xt_np[v].T,
            ((matmul_modp(xt_np[v], w_int.reshape(-1, 1))[:, 0] - yt_np[v])
             % FIELD_P).reshape(-1, 1),
        )[:, 0]
        for v in range(spec.nr)
    ])                                           # (nr, cols)
    checked = 0
    for on in on_time:
        if on.sum() < spec.recovery_threshold:
            continue
        out, ok = coded_linear_gradient_modp(coded_x, w_dev, on)
        rec = np.nonzero(on)[0][: spec.recovery_threshold]
        per_chunk = matmul_modp(decode_matrix_modp(spec, rec), grads_np[rec])
        want = per_chunk.sum(axis=0) % FIELD_P
        if not bool(ok) or not np.array_equal(out.cpu().numpy().astype(np.int64), want):
            raise AssertionError("exact deg-2 gradient differs from the numpy oracle")
        checked += 1
        if checked >= EXACT_CHECKS:
            break
    return checked


def run(device=None, rounds: int = ROUNDS, draws=None) -> dict:
    """The example's whole flow on ``device`` (``None`` means ``"cuda"``).

    ``draws`` is the rollout's random source (a ``Draws`` or an int seed;
    ``None`` means seed 0).  Returns the throughputs, final losses, weight
    errors and the number of exact rounds checked; raises ``AssertionError``
    where the JAX example asserts.
    """
    dev = resolve_device(device)
    spec = CodeSpec(N, R, K, deg_f=2)
    lp = LoadParams(n=N, kstar=spec.recovery_threshold,
                    ell_g=int(min(MU_G * D, R)), ell_b=int(MU_B * D))

    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(COLS,))
    x_chunks = rng.normal(size=(K, ROWS, COLS))
    y_chunks = x_chunks @ w_true + 0.01 * rng.normal(size=(K, ROWS))
    x = torch.as_tensor(x_chunks, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y_chunks, dtype=torch.float32, device=dev)
    coded = encode_dataset(spec, x, y)

    # one engine rollout: trajectory + every round's loads for BOTH strategies
    states, loads, feasible = throughput.rollout(
        0 if draws is None else draws, lp, [P_GG] * N, [P_BB] * N, rounds,
        strategies=STRATEGIES, device=dev)
    success = throughput.score_rollout(states, loads, feasible, lp,
                                       MU_G, MU_B, D).cpu().numpy()   # (M, S)
    # every round's erasure pattern: the first loads[i] chunks of each
    # on-time worker arrived
    on_time = chunk_on_time(states, loads, MU_G, MU_B, D, R).cpu().numpy()

    result = {"kstar": spec.recovery_threshold, "throughput": {}, "loss": {},
              "err": {}}
    for j, s in enumerate(STRATEGIES):
        tput, w, losses = _descend(coded, x, y, success, on_time, j, rounds)
        err = float(np.linalg.norm(w.cpu().numpy() - w_true) / np.linalg.norm(w_true))
        result["throughput"][s] = tput
        result["loss"][s] = losses[-1]
        result["err"][s] = err
    tput, err = result["throughput"], result["err"]
    if not tput["lea"] > tput["static_equal"]:
        raise AssertionError("LEA should beat the static allocation")
    if not err["lea"] < err["static_equal"]:
        raise AssertionError("more on-time rounds => closer to w*")
    result["exact_checked"] = _exact_rounds(
        spec, on_time[STRATEGIES.index("lea")], dev)
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    res = run(device)
    print(f"K* = {res['kstar']}, device {resolve_device(device)}")
    for s, label in (("lea", "LEA   "), ("static_equal", "static")):
        print(f"{label} : timely throughput {res['throughput'][s]:.3f}, final loss "
              f"{res['loss'][s]:.4f}, |w-w*|/|w*| = {res['err'][s]:.3f}")
    print(f"exact  : GF(p) deg-2 gradient round == numpy modp oracle on "
          f"{res['exact_checked']} LEA straggler patterns (bit-exact)")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
