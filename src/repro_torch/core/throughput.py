"""Timely-computation-throughput simulator (Defn. 2.1, Sec. 6.1) — batched engine.

Simulates M rounds of deadline-constrained coded computation over n two-state
Markov workers and measures R(d, eta) = (1/M) * sum_m N_m(d) per strategy:

  * ``lea``           — the paper's LEA (estimator + optimal allocator)
  * ``static``        — iid allocation from the true stationary
                        distribution, resampled until the total load >= K*
  * ``static_equal``  — like ``static`` with prob 1/2 each (resampled)
  * ``static_single`` — ONE ell_g/ell_b draw with prob 1/2 each, no
                        resampling (the paper's EC2 benchmark)
  * ``oracle``        — genie-aided optimum of Thm. 4.6 (upper bound R*(d))
  * any other registered policy (:mod:`repro_torch.policies`).

Design (as in the JAX package).  Nothing in a round's allocation depends on
the previous round's allocation, only on the worker trajectory, so the
engine vectorises over rounds AND over B independent rows (the JAX package's
``vmap`` written out as a leading batch axis):

  * the trajectory is a log-depth doubling scan over composed transition
    maps (:func:`repro_torch.core.markov.sample_trajectory`);
  * every policy's predicted p_good for every round comes from its
    closed-form replay (:mod:`repro_torch.policies`);
  * ALL rounds x rows x policies go through ONE batched allocator call — a
    single Poisson-binomial DP (the CUDA kernel on a GPU);
  * the static strategies resample every round in one loop over tries on
    the host, stopping when no round is unfinished or after 128 tries;
    rounds that finished ignore later draws, so each round sees exactly its
    own draw chain.  ``static`` and ``static_equal`` consume the same draws,
    as in the JAX package; rows still short of K* after the cap carry an
    explicit False ``feasible`` flag;
  * round scoring is one vectorised float32 comparison
    ``loads / speed <= deadline + 1e-9`` (the ``1e-9`` rounds away against
    a float32 deadline, exactly as in the JAX package).

Load parameters come either as a static :class:`~repro_torch.core.lea.LoadParams`
(the static-threshold kernel entry) or as per-row
:class:`~repro_torch.core.lea.PoolLoad` tensors over a mask-padded pool
(the per-row-threshold entry): masked workers are frozen good, demoted
below every real worker, given load 0 and never count toward K*.
A full-width pool gives the same results as the static ``LoadParams`` path.

Randomness comes from a :class:`repro_torch.random.Draws` (an int seeds a
:class:`~repro_torch.random.TorchDraws`).  ``round_chunk`` bounds peak memory
by running the per-round work in blocks of rounds; with a position-keyed
draw source the result is identical to the unchunked run.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.random import as_draws

from . import lea as lea_mod
from . import markov
from .lea import LoadParams, PoolLoad

STATIC_STRATEGIES = ("static", "static_equal", "static_single")
STATIC_MAX_TRIES = 128


def _policy_registry():
    # local import: repro_torch.policies imports repro_torch.core.lea
    from repro_torch.policies import registry as policy_registry

    return policy_registry


def strategy_known(name: str) -> bool:
    """Is ``name`` a legal strategy: a static draw or a registered policy?"""
    return name in STATIC_STRATEGIES or _policy_registry().is_registered(name)


def allocator_strategies(strategies: tuple[str, ...]) -> tuple[str, ...]:
    """The policy (allocator-driven) strategies, deduped, in appearance order."""
    seen: list[str] = []
    for s in strategies:
        if s not in STATIC_STRATEGIES and s not in seen:
            seen.append(s)
    return tuple(seen)


def _check_strategies(strategies: tuple[str, ...]) -> None:
    if not strategies:
        raise ValueError("strategies must be non-empty")
    for s in strategies:
        if not strategy_known(s):
            raise ValueError(
                f"unknown strategy {s!r}: not a static draw "
                f"{STATIC_STRATEGIES} and not a registered policy "
                f"({', '.join(_policy_registry().names())})"
            )


def _load_fields(load):
    """(kstar, ell_g, ell_b, mask-or-None) broadcastable over (B, m[, n])."""
    if isinstance(load, PoolLoad):
        return (load.kstar[:, None], load.ell_g[:, None, None],
                load.ell_b[:, None, None], load.mask)
    return load.kstar, load.ell_g, load.ell_b, None


def _p_good_rows(states, p_gg, p_bb, pi_g, alloc_names, draws=None) -> torch.Tensor:
    """(A, B, M, n) predicted p_good per policy strategy; randomised
    policies take their draws from ``draws``."""
    from repro_torch.policies.api import PolicyContext

    registry = _policy_registry()
    ctx = PolicyContext(states=states, p_gg=p_gg, p_bb=p_bb, pi_g=pi_g,
                        draws=draws)
    return torch.stack([registry.resolve(s).p_good_trajectory(ctx)
                        for s in alloc_names])


def engine_preamble(draws, load, p_gg, p_bb, rounds: int, strategies):
    """The per-run preamble: ``(states (B, M, n), p_alloc (A, B, M, n),
    pi_g (B, n))``.  ``p_alloc`` has a zero-size leading axis when no
    allocator strategy is requested."""
    mask = load.mask if isinstance(load, PoolLoad) else None
    states = markov.sample_trajectory(draws, p_gg, p_bb, rounds, worker_mask=mask)
    pi_g = markov.stationary_good_prob(markov.chain_row0(p_gg),
                                       markov.chain_row0(p_bb))
    alloc_names = allocator_strategies(strategies)
    if alloc_names:
        p_alloc = _p_good_rows(states, p_gg, p_bb, pi_g, alloc_names, draws)
    else:
        p_alloc = torch.zeros((0,) + tuple(states.shape), dtype=torch.float32,
                              device=states.device)
    return states, p_alloc, pi_g


def _static_loads_batch(draws, rounds, start, stop, pis, kstar, ell_g, ell_b,
                        mask=None):
    """Rejection resampling for rounds ``start:stop`` of every row.

    ``pis`` is a list of (B, n) good-probabilities (``static``: the
    stationary distribution; ``static_equal``: 1/2), one per strategy; all
    of them consume the same uniforms of try t.  A round redraws until its
    total load reaches K* or the 128-try cap; finished rounds ignore later
    draws.  Returns ``[(loads (B, m, n) int32, feasible (B, m) bool)]``.
    """
    b, n = pis[0].shape
    m = stop - start
    dev = pis[0].device

    def masked(loads):
        return loads if mask is None else torch.where(mask[:, None, :], loads, 0)

    def unfinished(loads):
        return masked(loads).sum(dim=-1) < kstar

    loads = [torch.zeros((b, m, n), dtype=torch.int32, device=dev) for _ in pis]
    for t in range(STATIC_MAX_TRIES):
        redo = [unfinished(x) for x in loads]
        if not any(bool(r.any()) for r in redo):
            break
        u = draws.static(b, rounds, start, stop, n, t).to(dev)
        for j, pi in enumerate(pis):
            new = torch.where(u < pi[:, None, :], ell_g, ell_b).to(torch.int32)
            loads[j] = torch.where(redo[j][..., None], new, loads[j])
    out = []
    for x in loads:
        x = masked(x)
        out.append((x, x.sum(dim=-1) >= kstar))
    return out


def _rollout_block(states_b, draws, rounds, start, p_alloc_b, pi_g, load,
                   strategies):
    """Loads + feasibility for rounds ``start:start+m``: (S, B, m, n),
    (S, B, m)."""
    b, m, n = states_b.shape
    stop = start + m
    kstar, ell_g, ell_b, mask = _load_fields(load)
    alloc_names = allocator_strategies(strategies)
    dev = states_b.device
    always = torch.ones((b, m), dtype=torch.bool, device=dev)
    loads_by = {}
    if alloc_names:
        if isinstance(load, PoolLoad):
            pool = PoolLoad(kstar=load.kstar[None, :, None],
                            ell_g=load.ell_g[None, :, None],
                            ell_b=load.ell_b[None, :, None],
                            mask=load.mask[None, :, None, :])
            loads_all, _i_star, feas = lea_mod.allocate_masked(p_alloc_b, pool)
            for j, s in enumerate(alloc_names):
                loads_by[s] = (loads_all[j], feas[j])
        else:
            loads_all, _i_star = lea_mod.allocate(p_alloc_b, load)
            for j, s in enumerate(alloc_names):
                loads_by[s] = (loads_all[j], always)

    resampled = [s for s in ("static", "static_equal") if s in strategies]
    if resampled:
        pis = [pi_g if s == "static" else torch.full_like(pi_g, 0.5)
               for s in resampled]
        outs = _static_loads_batch(draws, rounds, start, stop, pis, kstar,
                                   ell_g, ell_b, mask)
        loads_by.update(zip(resampled, outs))
    if "static_single" in strategies:
        u = draws.single(b, rounds, start, stop, n).to(dev)
        single = torch.where(u < 0.5, ell_g, ell_b).to(torch.int32)
        if mask is not None:
            single = torch.where(mask[:, None, :], single, 0)
        loads_by["static_single"] = (single, always)

    loads_mat = torch.stack([loads_by[s][0] for s in strategies])
    feasible = torch.stack([loads_by[s][1] for s in strategies])
    return loads_mat, feasible


def _score_block(loads_mat, feasible, states_b, mu_g, mu_b, deadline, kstar):
    """(B, m, S) success indicators for one block (float32 comparisons)."""
    speeds = torch.where(states_b == 1, mu_g[:, None, None], mu_b[:, None, None])
    on_time = loads_mat.to(torch.float32) / speeds <= deadline[:, None, None] + 1e-9
    received = torch.where(on_time, loads_mat, 0).sum(dim=-1)       # (S, B, m)
    if isinstance(kstar, torch.Tensor):
        kstar = kstar[:, None]
    succ = (received >= kstar) & feasible
    return succ.permute(1, 2, 0)


def engine_block(states_b, draws, rounds, start, p_alloc_b, pi_g, load,
                 strategies, mu_g, mu_b, deadline):
    """One block of rounds ``start:start+m`` scored: (B, m, S) successes."""
    loads_mat, feasible = _rollout_block(
        states_b, draws, rounds, start, p_alloc_b, pi_g, load, strategies
    )
    return _score_block(loads_mat, feasible, states_b, mu_g, mu_b, deadline,
                        load.kstar)


def _check_chain_shapes(p_gg, p_bb, rounds: int) -> None:
    if p_gg.shape != p_bb.shape:
        raise ValueError(f"p_gg/p_bb shapes differ: {tuple(p_gg.shape)} vs "
                         f"{tuple(p_bb.shape)}")
    if p_gg.dim() == 3 and p_gg.shape[1] != rounds:
        raise ValueError(
            f"time-varying chain must have one row per round: got "
            f"{p_gg.shape[1]} rows for rounds={rounds}"
        )


def _simulate_batched(draws, load, p_gg, p_bb, mu_g, mu_b, deadline, rounds,
                      strategies, round_chunk):
    """The engine on batched tensors: (B, M, S) bool successes."""
    strategies = tuple(strategies)
    _check_strategies(strategies)
    _check_chain_shapes(p_gg, p_bb, rounds)
    states, p_alloc, pi_g = engine_preamble(draws, load, p_gg, p_bb, rounds,
                                            strategies)
    if round_chunk is None or round_chunk >= rounds:
        return engine_block(states, draws, rounds, 0, p_alloc, pi_g, load,
                            strategies, mu_g, mu_b, deadline)
    if round_chunk <= 0:
        raise ValueError("round_chunk must be positive")
    blocks = []
    for start in range(0, rounds, round_chunk):
        stop = min(start + round_chunk, rounds)
        blocks.append(engine_block(
            states[:, start:stop], draws, rounds, start,
            p_alloc[:, :, start:stop], pi_g, load, strategies,
            mu_g, mu_b, deadline,
        ))
    return torch.cat(blocks, dim=1)


# ---------------------------------------------------------------------------
# input lifting: user-facing shapes -> the batched engine's tensors
# ---------------------------------------------------------------------------

def _f32(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _rows(x, b, dtype, dev):
    return torch.broadcast_to(torch.as_tensor(x, dtype=dtype, device=dev), (b,)).contiguous()


def _batch_inputs(p_gg, p_bb, mu_g, mu_b, deadline, dev):
    p_gg, p_bb = _f32(p_gg, dev), _f32(p_bb, dev)
    b = p_gg.shape[0]
    return (p_gg, p_bb, _rows(mu_g, b, torch.float32, dev),
            _rows(mu_b, b, torch.float32, dev),
            _rows(deadline, b, torch.float32, dev))


def _batch_pool(pool: PoolLoad, b: int, dev) -> PoolLoad:
    mask = torch.as_tensor(pool.mask, dtype=torch.bool, device=dev)
    return PoolLoad(
        kstar=_rows(pool.kstar, b, torch.int32, dev),
        ell_g=_rows(pool.ell_g, b, torch.int32, dev),
        ell_b=_rows(pool.ell_b, b, torch.int32, dev),
        mask=torch.broadcast_to(mask, (b, mask.shape[-1])).contiguous(),
    )


def sweep(draws, lp: LoadParams, p_gg, p_bb, mu_g, mu_b, deadline, rounds: int,
          strategies=("lea", "static", "oracle"), round_chunk: int | None = None,
          *, device=None) -> torch.Tensor:
    """Batched Monte-Carlo sweep: B rows on one static ``LoadParams``.

    ``p_gg``/``p_bb`` are (B, n) or (B, rounds, n); ``mu_g``/``mu_b``/
    ``deadline`` scalars or (B,).  Returns (B, rounds, S) bool successes.
    """
    dev = resolve_device(device)
    p_gg, p_bb, mu_g, mu_b, deadline = _batch_inputs(p_gg, p_bb, mu_g, mu_b,
                                                     deadline, dev)
    return _simulate_batched(as_draws(draws, dev), lp, p_gg, p_bb, mu_g, mu_b,
                             deadline, rounds, strategies, round_chunk)


def sweep_pool(draws, pool: PoolLoad, p_gg, p_bb, mu_g, mu_b, deadline,
               rounds: int, strategies=("lea", "static", "oracle"),
               round_chunk: int | None = None, *, device=None) -> torch.Tensor:
    """:func:`sweep` with per-row load parameters: ``pool`` leaves are (B,)
    (or scalars) and ``pool.mask`` is (B, n) (or (n,))."""
    dev = resolve_device(device)
    p_gg, p_bb, mu_g, mu_b, deadline = _batch_inputs(p_gg, p_bb, mu_g, mu_b,
                                                     deadline, dev)
    pool = _batch_pool(pool, p_gg.shape[0], dev)
    return _simulate_batched(as_draws(draws, dev), pool, p_gg, p_bb, mu_g,
                             mu_b, deadline, rounds, strategies, round_chunk)


def simulate_strategies(draws, lp: LoadParams, p_gg, p_bb, mu_g, mu_b, deadline,
                        rounds: int, strategies=("lea", "static", "oracle"),
                        round_chunk: int | None = None, *,
                        device=None) -> torch.Tensor:
    """Run M rounds of ALL ``strategies`` over one shared worker trajectory.

    ``p_gg``/``p_bb`` are (n,) or, time-varying, (rounds, n).  Returns
    (rounds, len(strategies)) bool success indicators.
    """
    dev = resolve_device(device)
    return sweep(draws, lp, _f32(p_gg, dev)[None], _f32(p_bb, dev)[None],
                 mu_g, mu_b, deadline, rounds, strategies, round_chunk,
                 device=dev)[0]


def simulate_strategies_pool(draws, pool: PoolLoad, p_gg, p_bb, mu_g, mu_b,
                             deadline, rounds: int,
                             strategies=("lea", "static", "oracle"),
                             round_chunk: int | None = None, *,
                             device=None) -> torch.Tensor:
    """:func:`simulate_strategies` with per-row (here: one row's) load
    parameters as a :class:`PoolLoad` of scalars and an (n,) mask."""
    dev = resolve_device(device)
    return sweep_pool(draws, pool, _f32(p_gg, dev)[None], _f32(p_bb, dev)[None],
                      mu_g, mu_b, deadline, rounds, strategies, round_chunk,
                      device=dev)[0]


def _rollout(draws, load, p_gg, p_bb, rounds, strategies, dev):
    strategies = tuple(strategies)
    _check_strategies(strategies)
    p_gg, p_bb = _f32(p_gg, dev)[None], _f32(p_bb, dev)[None]
    _check_chain_shapes(p_gg, p_bb, rounds)
    if isinstance(load, PoolLoad):
        load = _batch_pool(load, 1, dev)
    draws = as_draws(draws, dev)
    states, p_alloc, pi_g = engine_preamble(draws, load, p_gg, p_bb, rounds,
                                            strategies)
    loads_mat, feasible = _rollout_block(
        states, draws, rounds, 0, p_alloc, pi_g, load, strategies
    )
    return states[0], loads_mat[:, 0], feasible[:, 0]


def rollout(draws, lp: LoadParams, p_gg, p_bb, rounds: int,
            strategies=("lea", "static"), *, device=None):
    """Trajectory + per-round loads without scoring: ``(states (M, n),
    loads (S, M, n), feasible (S, M))`` on the code path
    :func:`simulate_strategies` scores."""
    return _rollout(draws, lp, p_gg, p_bb, rounds, strategies,
                    resolve_device(device))


def rollout_pool(draws, pool: PoolLoad, p_gg, p_bb, rounds: int,
                 strategies=("lea", "static"), *, device=None):
    """:func:`rollout` with a :class:`PoolLoad` (scalars + (n,) mask)."""
    return _rollout(draws, pool, p_gg, p_bb, rounds, strategies,
                    resolve_device(device))


def score_rollout(states, loads, feasible, lp: LoadParams, mu_g, mu_b,
                  deadline) -> torch.Tensor:
    """Score a :func:`rollout`: (M, S) success indicators."""
    dev = states.device
    return _score_block(loads[:, None], feasible[:, None], states[None],
                        _rows(mu_g, 1, torch.float32, dev),
                        _rows(mu_b, 1, torch.float32, dev),
                        _rows(deadline, 1, torch.float32, dev), lp.kstar)[0]


def simulate(draws, strategy: str, lp: LoadParams, p_gg, p_bb, mu_g, mu_b,
             deadline, rounds: int, *, device=None) -> torch.Tensor:
    """Run M rounds of one strategy; (rounds,) bool indicators N_m(d)."""
    if not strategy_known(strategy):
        raise ValueError(f"unknown strategy {strategy!r}")
    return simulate_strategies(draws, lp, p_gg, p_bb, mu_g, mu_b, deadline,
                               rounds, (strategy,), device=device)[:, 0]


def float32_mean(counts, total: int):
    """The float32 mean of 0/1 indicators from their exact counts, as XLA
    forms it: the count times the float32 reciprocal of ``total``."""
    return np.float32(counts) * (np.float32(1.0) / np.float32(total))


def timely_throughput(successes) -> float:
    """R(d, eta) — eq. (2): the float32 mean of the success indicators."""
    succ = torch.as_tensor(successes)
    return float(float32_mean(succ.sum().item(), succ.numel()))


def compare(draws, lp: LoadParams, p_gg, p_bb, mu_g, mu_b, deadline, rounds: int,
            strategies=("lea", "static", "oracle"), *, device=None) -> dict[str, float]:
    """Throughput of several strategies on a shared worker trajectory."""
    strategies = tuple(strategies)
    succ = simulate_strategies(draws, lp, p_gg, p_bb, mu_g, mu_b, deadline,
                               rounds, strategies, device=device)
    return {s: timely_throughput(succ[:, j]) for j, s in enumerate(strategies)}
