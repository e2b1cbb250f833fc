"""Inputs of the static resampler's tests, shared by the CPU and the card
tests (no JAX here): one block of rounds of a few rows, in the shapes the
engine hands over (``LoadParams`` ints, or a ``PoolLoad``'s (B, 1) and
(B, 1, 1) tensors), and the engine's host loop around one resampler."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.throughput import STATIC_MAX_TRIES

CASES = ("pool_mask_s2", "pool_s1", "scalars_s1", "scalars_s2", "pi_zero",
         "kstar_nonpositive", "all_masked_row", "one_row_short", "wide_s2_mask",
         "wide_s2_ragged")


def resample_case(name: str, device) -> dict:
    """``dict(rounds, start, stop, pis, kstar, ell_g, ell_b, mask)`` of a case:

    * ``pool_mask_s2``: per-row K* and loads, masked pools, ``static`` and
      ``static_equal``;
    * ``pool_s1`` / ``scalars_s1`` / ``scalars_s2``: per-row or
      ``LoadParams`` scalars, no mask, one or two strategies;
    * ``pi_zero``: p_good 0, so no round reaches K* and every round runs
      to the 128-try cap with ``feasible`` False and loads all ell_b;
    * ``kstar_nonpositive``: K* <= 0 on every row, so no try draws;
    * ``all_masked_row``: a row with no real worker and K* > 0 runs to the
      cap while the other rows finish;
    * ``one_row_short``: one row, a 3-round block at the end of its rounds;
    * ``wide_s2_mask`` / ``wide_s2_ragged``: thousands of rounds of a few
      rows, two strategies, masked pools and a row with K* = 0 (``ragged``:
      odd shapes, 7 rows x 301 rounds x 13 workers).
    """
    rng = np.random.default_rng(CASES.index(name) + 5)
    dev = torch.device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=dev)
    pool = lambda k, g, b: (i32(k)[:, None], i32(g)[:, None, None], i32(b)[:, None, None])

    def masks(b, n, real):
        return torch.as_tensor(np.arange(n) < np.asarray(real)[:, None], device=dev)

    if name in ("pool_mask_s2", "pool_s1"):
        b, n = 3, 12
        pis = [f32(rng.uniform(0.3, 0.9, (b, n)))]
        if name == "pool_mask_s2":
            pis.append(torch.full((b, n), 0.5, device=dev))
            kstar, ell_g, ell_b = pool([70, 50, 75], [8, 7, 9], [3, 2, 4])
            mask = masks(b, n, [12, 9, 10])
        else:
            kstar, ell_g, ell_b = pool([70, 60, 80], [8, 7, 9], [3, 2, 4])
            mask = None
        return dict(rounds=40, start=8, stop=24, pis=pis, kstar=kstar, ell_g=ell_g,
                    ell_b=ell_b, mask=mask)
    if name in ("scalars_s1", "scalars_s2"):
        b, n = 4, 15
        pis = [f32(rng.uniform(0.4, 0.8, (b, n)))]
        if name == "scalars_s2":
            pis.append(torch.full((b, n), 0.5, device=dev))
        return dict(rounds=50, start=0, stop=50, pis=pis, kstar=99, ell_g=10, ell_b=3,
                    mask=None)
    if name == "pi_zero":
        return dict(rounds=5, start=0, stop=5, pis=[torch.zeros((2, 15), device=dev)],
                    kstar=99, ell_g=10, ell_b=3, mask=None)
    if name == "kstar_nonpositive":
        b, n = 2, 15
        kstar, ell_g, ell_b = pool([0, -3], [10, 10], [3, 3])
        return dict(rounds=20, start=4, stop=12, pis=[f32(rng.uniform(0.4, 0.8, (b, n)))],
                    kstar=kstar, ell_g=ell_g, ell_b=ell_b, mask=masks(b, n, [15, 11]))
    if name == "all_masked_row":
        b, n = 3, 15
        kstar, ell_g, ell_b = pool([60, 40, 60], [10, 10, 10], [3, 3, 3])
        return dict(rounds=6, start=0, stop=6, pis=[f32(rng.uniform(0.4, 0.8, (b, n)))],
                    kstar=kstar, ell_g=ell_g, ell_b=ell_b, mask=masks(b, n, [15, 0, 13]))
    if name == "one_row_short":
        b, n = 1, 15
        kstar, ell_g, ell_b = pool([80], [10], [3])
        return dict(rounds=1000, start=997, stop=1000,
                    pis=[f32(rng.uniform(0.4, 0.8, (b, n)))], kstar=kstar, ell_g=ell_g,
                    ell_b=ell_b, mask=masks(b, n, [13]))
    if name in ("wide_s2_mask", "wide_s2_ragged"):
        b, m, n = (8, 300, 15) if name == "wide_s2_mask" else (7, 301, 13)
        pis = [f32(rng.uniform(0.3, 0.9, (b, n))), torch.full((b, n), 0.5, device=dev)]
        real = rng.integers(n - 4, n + 1, b)
        kstar, ell_g, ell_b = pool(np.where(np.arange(b) == 2, 0, 7 * real),
                                   rng.integers(9, 12, b), rng.integers(2, 4, b))
        return dict(rounds=3 * m, start=m, stop=2 * m, pis=pis, kstar=kstar, ell_g=ell_g,
                    ell_b=ell_b, mask=masks(b, n, real))
    raise KeyError(name)


def drive(resampler, draws, case: dict):
    """The engine's host loop around one resampler: its result and the
    count it read before each try (the last read, if no round is left, ends
    the loop)."""
    b, n = case["pis"][0].shape
    dev = case["pis"][0].device
    reads = []
    for t in range(STATIC_MAX_TRIES):
        reads.append(resampler.unfinished())
        if not reads[-1]:
            break
        resampler.redraw(draws.static(b, case["rounds"], case["start"], case["stop"], n,
                                      t).to(dev))
    return resampler.result(), reads


def resampler_args(case: dict) -> tuple:
    """A resampler's arguments for the case's block."""
    return (case["pis"], case["stop"] - case["start"], case["kstar"], case["ell_g"],
            case["ell_b"], case["mask"])


def batch_args(case: dict) -> tuple:
    """``_static_loads_batch``'s arguments after ``draws``."""
    return (case["rounds"], case["start"], case["stop"], case["pis"], case["kstar"],
            case["ell_g"], case["ell_b"], case["mask"])


def check_edges(name: str, case: dict, out, tries: int) -> None:
    """What the edge cases must show whatever the route."""
    if name == "pi_zero":
        assert tries == STATIC_MAX_TRIES
        for loads, feasible in out:
            assert not feasible.any() and bool((loads == case["ell_b"]).all())
    elif name == "kstar_nonpositive":
        assert tries == 0
        for loads, feasible in out:
            assert feasible.all() and not loads.any()
    elif name == "all_masked_row":
        assert tries == STATIC_MAX_TRIES
        for loads, feasible in out:
            assert not feasible[1].any() and not loads[1].any()
            assert feasible[0].all() and feasible[2].all()
