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
    the host, stopping when no round is unfinished or after 128 tries (one
    host read a try, whatever the number of strategies; on the card a try
    is one kernel launch that touches only the unfinished rounds);
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
from repro_torch.kernels.static_resample import count_try, static_resampler
from repro_torch.obs import taps as _taps
from repro_torch.obs.profiling import phase as _phase
from repro_torch.obs.telemetry import TelemetryFrame
from repro_torch.random import as_draws

from . import lea as lea_mod
from . import markov
from .lea import LoadParams, PoolLoad

# the classic closed strategy tuple of the JAX package; the engine accepts
# any registered policy name too (strategy_known)
STRATEGIES = ("lea", "static", "static_equal", "static_single", "oracle")
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


def engine_preamble(draws, mask, p_gg, p_bb, rounds: int, strategies):
    """The per-run preamble: ``(states (B, M, n), p_alloc (A, B, M, n),
    pi_g (B, n))`` for a (B, n) worker ``mask`` (``None``: every worker
    real).  ``p_alloc`` has a zero-size leading axis when no allocator
    strategy is requested."""
    with _phase("trajectory", p_gg.device):
        states = markov.sample_trajectory(draws, p_gg, p_bb, rounds, worker_mask=mask)
    pi_g = markov.stationary_good_prob(markov.chain_row0(p_gg),
                                       markov.chain_row0(p_bb))
    alloc_names = allocator_strategies(strategies)
    if alloc_names:
        with _phase("policy_replay", p_gg.device):
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
    draws.  A try is one launch of the resampler's kernel on the card
    (:mod:`repro_torch.kernels.static_resample`), which touches only the
    unfinished rounds.  Returns ``[(loads (B, m, n) int32, feasible (B, m)
    bool)]``.
    """
    b, n = pis[0].shape
    m = stop - start
    dev = pis[0].device
    resampler = static_resampler(pis, m, kstar, ell_g, ell_b, mask)
    for t in range(STATIC_MAX_TRIES):
        # one host read a try: the unfinished (strategy, round) pairs
        with _phase("static_wait", dev):
            left = resampler.unfinished()
        if not left:
            break
        count_try(left, len(pis) * b * m)
        resampler.redraw(draws.static(b, rounds, start, stop, n, t).to(dev))
    return resampler.result()


def _rollout_block_stats(states_b, draws, rounds, start, p_alloc_b, pi_g, load,
                         strategies):
    """Loads + feasibility + allocator prefixes for rounds
    ``start:start+m``: (S, B, m, n), (S, B, m), (A, B, m) i*."""
    b, m, n = states_b.shape
    stop = start + m
    kstar, ell_g, ell_b, mask = _load_fields(load)
    alloc_names = allocator_strategies(strategies)
    dev = states_b.device
    always = torch.ones((b, m), dtype=torch.bool, device=dev)
    loads_by = {}
    prefix = torch.zeros((0, b, m), dtype=torch.int32, device=dev)
    if alloc_names:
        with _phase("allocate", dev):
            if isinstance(load, PoolLoad):
                pool = PoolLoad(kstar=load.kstar[None, :, None],
                                ell_g=load.ell_g[None, :, None],
                                ell_b=load.ell_b[None, :, None],
                                mask=load.mask[None, :, None, :])
                loads_all, i_star, feas = lea_mod.allocate_masked(p_alloc_b, pool)
                for j, s in enumerate(alloc_names):
                    loads_by[s] = (loads_all[j], feas[j])
            else:
                loads_all, i_star = lea_mod.allocate(p_alloc_b, load)
                for j, s in enumerate(alloc_names):
                    loads_by[s] = (loads_all[j], always)
            prefix = i_star

    with _phase("static_loads", dev):
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
    return loads_mat, feasible, prefix


def _rollout_block(states_b, draws, rounds, start, p_alloc_b, pi_g, load,
                   strategies):
    """Loads + feasibility for rounds ``start:start+m``: (S, B, m, n),
    (S, B, m)."""
    return _rollout_block_stats(states_b, draws, rounds, start, p_alloc_b, pi_g,
                                load, strategies)[:2]


def _score_block_stats(loads_mat, feasible, states_b, mu_g, mu_b, deadline, kstar):
    """(B, m, S) success indicators for one block (float32 comparisons) and
    the (S, B, m) on-time evaluations received."""
    with _phase("score", states_b.device):
        speeds = torch.where(states_b == 1, mu_g[:, None, None], mu_b[:, None, None])
        on_time = loads_mat.to(torch.float32) / speeds <= deadline[:, None, None] + 1e-9
        received = torch.where(on_time, loads_mat, 0).sum(dim=-1)   # (S, B, m)
        if isinstance(kstar, torch.Tensor):
            kstar = kstar[:, None]
        succ = (received >= kstar) & feasible
    return succ.permute(1, 2, 0), received


def _score_block(loads_mat, feasible, states_b, mu_g, mu_b, deadline, kstar):
    """(B, m, S) success indicators for one block (float32 comparisons)."""
    return _score_block_stats(loads_mat, feasible, states_b, mu_g, mu_b, deadline,
                              kstar)[0]


def engine_block(states_b, draws, rounds: int, start: int, p_alloc_b, pi_g, load,
                 strategies, mu_g, mu_b, deadline) -> torch.Tensor:
    """Rounds ``start:start+m`` of every row scored: (B, m, S) success
    indicators.

    ``states_b`` (B, m, n) and ``p_alloc_b`` (A, B, m, n) are the block's
    slices of :func:`engine_preamble`'s outputs; ``mu_g`` / ``mu_b`` /
    ``deadline`` are (B,).  The block's static draws come from ``draws``
    at this call.  The chunked path runs every block through this one
    function, the counterpart of the JAX package's ``engine_block``, so the
    same draws give the same bits as the JAX package's blocks.
    """
    loads_mat, feasible, _prefix = _rollout_block_stats(
        states_b, draws, rounds, start, p_alloc_b, pi_g, load, strategies)
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


def estimator_error_rounds(states, p_alloc, p_gg, p_bb, pi_g, mask) -> torch.Tensor:
    """(B, M, A) mean |p_alloc - genie p_good| per round, masked workers
    excluded (``mask`` (B, n), or None for a full pool).

    The estimator-error stream shared by the telemetry frame and the tap
    aggregates — one definition so every consumer folds the same floats.
    The sum over workers runs in PyTorch's order, not XLA's, so it equals
    the JAX package's to float32 rounding (exactly 0 for ``oracle``).
    """
    from repro_torch.policies.estimators import oracle_p_good

    p_true = oracle_p_good(states, p_gg, p_bb, pi_g)             # (B, M, n)
    err = (p_alloc - p_true[None]).abs()                          # (A, B, M, n)
    if mask is not None:
        w = mask.to(torch.float32)[None, :, None, :]
        est = (err * w).sum(dim=-1) / w.sum(dim=-1).clamp(min=1.0)
    else:
        est = err.mean(dim=-1)                                    # (A, B, M)
    return est.permute(1, 2, 0)


def _emit_pool(rows, block, rounds_done, succ_h, err_h, fixed_bound):
    """Deliver one ``engine.pool`` event a row from one boundary's host
    (B, S) success and (B, A) estimator-error sums, divided by the rounds
    done as the JAX package divides them: XLA turns a division by a
    constant (the unchunked path's ``fixed_bound``) into a product with
    its float32 reciprocal, and divides by a traced count (a block's)."""
    done = np.float32(max(rounds_done, 1))
    per = (lambda x: x * (np.float32(1.0) / done)) if fixed_bound else (lambda x: x / done)
    b = succ_h.shape[0]
    _taps.emit_rows(
        "engine.pool",
        block=np.full(b, block, np.int32), row=rows,
        rounds_done=np.full(b, rounds_done, np.int32),
        succ_so_far=succ_h, throughput_so_far=per(succ_h.astype(np.float32)),
        est_err_so_far=per(err_h),
    )


def _simulate_batched(draws, load, p_gg, p_bb, mu_g, mu_b, deadline, rounds,
                      strategies, round_chunk, telemetry=False, tap=False,
                      tap_stride=None, tap_rows=None):
    """The engine on batched tensors: (B, M, S) bool successes, and with
    ``telemetry`` a :class:`TelemetryFrame` of (B, M, ...) leaves.

    ``tap``: deliver block aggregates (``engine.pool`` events, one a row)
    at every ``round_chunk`` block boundary, or at ``tap_stride``
    boundaries of an unchunked run; ``tap_rows`` labels the rows (default
    0..B-1).  Neither flag changes the successes.
    """
    strategies = tuple(strategies)
    _check_strategies(strategies)
    _check_chain_shapes(p_gg, p_bb, rounds)
    mask = _load_fields(load)[3]
    states, p_alloc, pi_g = engine_preamble(draws, mask, p_gg, p_bb, rounds, strategies)
    b, dev = states.shape[0], states.device
    rows = np.arange(b, dtype=np.int32) if tap_rows is None else np.asarray(tap_rows, np.int32)
    est_err = (estimator_error_rounds(states, p_alloc, p_gg, p_bb, pi_g, mask)
               if telemetry or tap else None)

    def block(start, stop):
        if not telemetry:
            return engine_block(states[:, start:stop], draws, rounds, start,
                                p_alloc[:, :, start:stop], pi_g, load, strategies,
                                mu_g, mu_b, deadline), None
        loads_mat, feasible, prefix = _rollout_block_stats(
            states[:, start:stop], draws, rounds, start, p_alloc[:, :, start:stop],
            pi_g, load, strategies)
        succ, received = _score_block_stats(loads_mat, feasible, states[:, start:stop],
                                            mu_g, mu_b, deadline, load.kstar)
        i32 = torch.int32
        return succ, (prefix.to(i32).permute(1, 2, 0),
                      loads_mat.sum(dim=-1, dtype=i32).permute(1, 2, 0),
                      received.to(i32).permute(1, 2, 0),
                      feasible.permute(1, 2, 0))

    if round_chunk is not None and round_chunk <= 0:
        raise ValueError("round_chunk must be positive")
    chunk = rounds if round_chunk is None or round_chunk >= rounds else round_chunk
    outs = []
    if tap and chunk < rounds:
        succ_cum = torch.zeros((b, len(strategies)), dtype=torch.int32, device=dev)
        err_cum = torch.zeros(est_err.shape[::2], dtype=torch.float32, device=dev)
    for bi, start in enumerate(range(0, rounds, chunk)):
        stop = min(start + chunk, rounds)
        outs.append(block(start, stop))
        if tap and chunk < rounds:
            # the short last block counts only its real rounds
            succ_cum = succ_cum + outs[-1][0].sum(dim=1, dtype=torch.int32)
            err_cum = err_cum + est_err[:, start:stop].sum(dim=1)
            _emit_pool(rows, bi, stop, *_taps.to_host(succ_cum, err_cum), fixed_bound=False)
    with _phase("fetch", dev):
        if len(outs) == 1:
            succ, tel = outs[0]
        else:
            succ = torch.cat([o[0] for o in outs], dim=1)
            tel = None if not telemetry else tuple(
                torch.cat([o[1][i] for o in outs], dim=1) for i in range(4))
    if tap and chunk == rounds:
        # one pass: the stride aggregates are prefix sums of the streams
        bounds, (succ_h, err_h) = _taps.prefix_sums_at(tap_stride, succ, est_err)
        for bi, bound in enumerate(bounds):
            _emit_pool(rows, bi, bound, succ_h[:, bi], err_h[:, bi], fixed_bound=True)
    if not telemetry:
        return succ
    prefix_t, load_total_t, received_t, feasible_t = tel
    return succ, TelemetryFrame(est_err=est_err, prefix_size=prefix_t,
                                load_total=load_total_t, received=received_t,
                                feasible=feasible_t)


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
    with _phase("lift", dev):
        p_gg, p_bb, mu_g, mu_b, deadline = _batch_inputs(p_gg, p_bb, mu_g, mu_b,
                                                         deadline, dev)
    return _simulate_batched(as_draws(draws, dev), lp, p_gg, p_bb, mu_g, mu_b,
                             deadline, rounds, strategies, round_chunk)


def sweep_pool(draws, pool: PoolLoad, p_gg, p_bb, mu_g, mu_b, deadline,
               rounds: int, strategies=("lea", "static", "oracle"),
               round_chunk: int | None = None, telemetry: bool = False,
               tap: bool = False, tap_stride: int | None = None, *, device=None):
    """:func:`sweep` with per-row load parameters: ``pool`` leaves are (B,)
    (or scalars) and ``pool.mask`` is (B, n) (or (n,)).

    ``telemetry=True`` returns ``(succ, TelemetryFrame)`` with a leading
    (B,) axis on every frame leaf.  ``tap=True`` delivers per-row block
    aggregates (``engine.pool`` events labelled with the batch ``row``) to
    the registered tap handlers during the run: at every ``round_chunk``
    block boundary, or every ``tap_stride`` rounds (default: once, at the
    end) of an unchunked run.  The successes are the same either way.
    """
    dev = resolve_device(device)
    with _phase("lift", dev):
        p_gg, p_bb, mu_g, mu_b, deadline = _batch_inputs(p_gg, p_bb, mu_g, mu_b,
                                                         deadline, dev)
        pool = _batch_pool(pool, p_gg.shape[0], dev)
    return _simulate_batched(as_draws(draws, dev), pool, p_gg, p_bb, mu_g,
                             mu_b, deadline, rounds, strategies, round_chunk,
                             telemetry, tap, tap_stride)


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
                             round_chunk: int | None = None,
                             telemetry: bool = False, tap: bool = False,
                             tap_stride: int | None = None, tap_row: int | None = None,
                             *, device=None):
    """:func:`simulate_strategies` with per-row (here: one row's) load
    parameters as a :class:`PoolLoad` of scalars and an (n,) mask.

    ``telemetry`` / ``tap`` / ``tap_stride`` as in :func:`sweep_pool`; the
    frame has no batch axis.  Tap events carry ``row = tap_row`` (default
    -1), as in the JAX package.
    """
    dev = resolve_device(device)
    with _phase("lift", dev):
        p_gg, p_bb, mu_g, mu_b, deadline = _batch_inputs(
            _f32(p_gg, dev)[None], _f32(p_bb, dev)[None], mu_g, mu_b, deadline, dev)
        pool = _batch_pool(pool, 1, dev)
    out = _simulate_batched(as_draws(draws, dev), pool, p_gg, p_bb,
                            mu_g, mu_b, deadline, rounds, strategies, round_chunk,
                            telemetry, tap, tap_stride,
                            tap_rows=[-1 if tap_row is None else tap_row])
    if not telemetry:
        return out[0]
    succ, frame = out
    return succ[0], TelemetryFrame(*(x[0] for x in frame))


def _rollout(draws, load, p_gg, p_bb, rounds, strategies, dev):
    strategies = tuple(strategies)
    _check_strategies(strategies)
    p_gg, p_bb = _f32(p_gg, dev)[None], _f32(p_bb, dev)[None]
    _check_chain_shapes(p_gg, p_bb, rounds)
    if isinstance(load, PoolLoad):
        load = _batch_pool(load, 1, dev)
    draws = as_draws(draws, dev)
    states, p_alloc, pi_g = engine_preamble(draws, _load_fields(load)[3], p_gg, p_bb,
                                            rounds, strategies)
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


def serve_rollout(draws, mask, p_gg, p_bb, rounds: int, strategies=("lea",), *,
                  device=None):
    """Trajectory + per-policy predicted p_good rows for the serving layer.

    The serving layer allocates per QUEUE SLOT (its own K*/ell per
    request), so unlike :func:`rollout_pool` there is no single pool-wide
    load allocation to return — just the engine preamble: ``(states (B, M,
    n), p_alloc (S, B, M, n))`` for ``mask``, ``p_gg``, ``p_bb`` of (B, n),
    drawn exactly as :func:`simulate_strategies_pool` draws them (same
    masked trajectory, same policy replays), so a degenerate
    one-job-per-round serving run replays the offline engine bit for bit.

    ``strategies`` must be registered POLICY names, unique: the serving
    loop allocates from predictions every round, so the static draw
    strategies (which never produce a p_good trajectory) are rejected
    explicitly rather than silently served a default.
    """
    strategies = tuple(strategies)
    _check_strategies(strategies)
    if strategies != allocator_strategies(strategies):
        raise ValueError(
            f"serve_rollout strategies must be unique policy names (no "
            f"static draws {STATIC_STRATEGIES}): got {strategies!r}"
        )
    dev = resolve_device(device)
    p_gg, p_bb = _f32(p_gg, dev), _f32(p_bb, dev)
    _check_chain_shapes(p_gg, p_bb, rounds)
    mask = torch.broadcast_to(torch.as_tensor(mask, dtype=torch.bool, device=dev),
                              (p_gg.shape[0], p_gg.shape[-1]))
    states, p_alloc, _ = engine_preamble(as_draws(draws, dev), mask, p_gg, p_bb, rounds,
                                         strategies)
    return states, p_alloc


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
