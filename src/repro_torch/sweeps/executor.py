"""Grouped, chunked execution of scenario batches: the sync path, the
pipelined path and row shards over processes.

One :class:`~repro_torch.sweeps.registry.SweepGroup` = one batched engine
call: :func:`run_group` moves the group's batch to the device and runs
:func:`repro_torch.core.throughput.sweep_pool` on all its rows at once
(per-row K*, loads and pool masks), drawing from the group's own
``torch.Generator`` unless the caller hands in another
:class:`~repro_torch.random.Draws`.  ``round_chunk`` runs the per-round work
in blocks of rounds to bound peak memory.

``pipeline=True`` runs the same blocks from a host loop that overlaps each
block's copy to the host with the next block's work (see the pipelined
section below); :func:`run_multihost` splits every group's rows over the
processes of a ``torch.distributed`` group (:mod:`repro_torch.launch.mesh`),
one device each.

``telemetry=`` returns the group's :class:`~repro_torch.obs.TelemetryFrame`
beside its successes, ``tap=`` delivers per-row block aggregates to the
registered tap handlers during the run (:mod:`repro_torch.obs.taps`), and
every call records its wall-clock (``phase.sweeps_run_group.seconds``) and
any kernel builds it triggered (``compile.sweeps_run_group.*``) in the
default metrics registry (:mod:`repro_torch.obs.metrics`).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import throughput
from repro_torch.device import resolve_device
from repro_torch.obs import counters as _obs_counters
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import taps as _taps
from repro_torch.obs.profiling import phase as _phase
from repro_torch.random import Draws, as_draws, torch_draws

from .registry import ScenarioBatch, SweepGroup


def compile_cache_size() -> int:
    """Kernel builds the sweep path needed in this process.

    The JAX package counts one compiled computation per group signature;
    the port compiles nothing per signature, so this alias over the
    unified counter (``obs.compile_events("build.poisson_binomial")``)
    counts the ``nvcc`` runs of the Poisson-binomial source the sweep
    engine launches: 0 or 1, whatever the number of groups.
    """
    return _obs_counters.compile_events("build.poisson_binomial")


# ---------------------------------------------------------------------------
# pipelined execution path
# ---------------------------------------------------------------------------
#
# The sync path runs the preamble and the round blocks inside one engine
# call, moves the batch to the device on every call and copies the whole
# (B, M, S) result at the end.  The pipelined path runs the same work from
# a host loop:
#
#   * the device copy of the group's batch is CACHED per (group identity,
#     device): move once, dispatch many;
#   * ``_prepare_group`` runs :func:`~repro_torch.core.throughput.engine_preamble`
#     once (and, with ``tap``, the estimator-error stream) and allocates the
#     carries: the (B, S) int32 success counts and the (B, A) float32
#     estimator-error sums;
#   * ``_block_step`` runs one block through
#     :func:`~repro_torch.core.throughput.engine_block` -- the function the
#     sync chunked path runs a block with -- and adds into the carries in
#     place.  A block is a plain slice of rounds; the last one is short;
#   * the host loop dispatches block b+1 while block b's (B, m, S) result
#     copies to a pinned host buffer on a side CUDA stream, fenced by an
#     event; at most ``PIPELINE_DEPTH`` blocks are in flight, the oldest is
#     folded by waiting on its event alone, and one drain ends the loop.
#     On the CPU the same loop copies synchronously.
#
# Blocks take their draws in block order on both paths, so at the same
# ``round_chunk`` and with the same draws the pipelined successes equal the
# sync path's bit for bit.  Two limits of the port: the static resampler
# reads one flag a try back to the host (``throughput._static_loads_batch``),
# which waits for the device, so a block's dispatch runs ahead of the card
# only until its first try.  On an H100 the pipelined path is therefore no
# faster than the sync chunked path today -- on fig3 (256 rows x 20 000
# rounds, ``round_chunk=2500``) it took a little longer (PERF.md, phase 14a):
# it exists for the JAX package's API (``pipeline=``, its stats, the
# double-buffered copy) and earns its overlap only once the per-try read is
# gone.  And the JAX package's ``pipeline_block_hlo``
# (the compiled HLO's ``input_output_alias``, its proof that XLA donated
# the carries) has no counterpart: here ``donated`` checks that each carry
# is the same storage (``data_ptr()``) before the first block and after
# the last.

PIPELINE_DEPTH = 2          # max blocks in flight (double-buffered)

_SHARD_CACHE_MAX = 4
_shard_cache: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()

_PIPELINE_STATS: dict = {}


def last_pipeline_stats() -> dict:
    """Host-loop accounting of the most recent pipelined run_group call.

    Keys: ``blocks``, ``round_chunk``, ``donated`` (each carry was the same
    storage before the first block and after the last: updated in place),
    ``fold_s`` (host time folding block results: waiting on each block's
    copy, emitting its tap events), ``dispatch_s`` (time spent enqueueing
    block steps), ``drain_s`` (the final synchronize), ``shard_cached`` (the
    device batch came from the cache).
    """
    return dict(_PIPELINE_STATS)


def _cached_shard(group: SweepGroup, dev: torch.device) -> tuple[ScenarioBatch, bool]:
    """``(batch on dev, cached)`` for ``group``, cached by identity.

    The key holds a strong reference to the group and is checked with
    ``is``, so id() reuse after garbage collection never aliases two
    groups.  A bounded FIFO: a caller keeps a handful of live groups.
    """
    key = (id(group), str(dev))
    hit = _shard_cache.get(key)
    if hit is not None and hit[0] is group:
        _shard_cache.move_to_end(key)
        return hit[1], True
    with _phase("lift", dev):
        batch = group.batch.to(dev)
    _shard_cache[key] = (group, batch)
    while len(_shard_cache) > _SHARD_CACHE_MAX:
        _shard_cache.popitem(last=False)
    return batch, False


class _Prepared(NamedTuple):
    states: torch.Tensor       # (B, M, n)
    p_alloc: torch.Tensor      # (A, B, M, n)
    pi_g: torch.Tensor         # (B, n)
    est: torch.Tensor | None   # (B, M, A) with tap, else None
    succ_cum: torch.Tensor     # (B, S) int32 carry
    err_cum: torch.Tensor      # (B, A) float32 carry


def _prepare_group(group: SweepGroup, batch: ScenarioBatch, draws, tap: bool) -> _Prepared:
    """The engine preamble for every row, once, and zero carries."""
    mask = batch.worker_mask
    states, p_alloc, pi_g = throughput.engine_preamble(
        draws, mask, batch.p_gg, batch.p_bb, group.rounds, group.strategies)
    est = (throughput.estimator_error_rounds(states, p_alloc, batch.p_gg, batch.p_bb,
                                             pi_g, mask) if tap else None)
    b, dev = states.shape[0], states.device
    return _Prepared(
        states, p_alloc, pi_g, est,
        torch.zeros((b, len(group.strategies)), dtype=torch.int32, device=dev),
        torch.zeros((b, p_alloc.shape[0]), dtype=torch.float32, device=dev))


def _block_step(group: SweepGroup, batch: ScenarioBatch, draws, prep: _Prepared,
                start: int, stop: int) -> torch.Tensor:
    """Rounds ``start:stop`` of every row: adds into the carries in place
    and returns the block's (B, m, S) successes."""
    succ_b = throughput.engine_block(
        prep.states[:, start:stop], draws, group.rounds, start,
        prep.p_alloc[:, :, start:stop], prep.pi_g, batch.pool, group.strategies,
        batch.mu_g, batch.mu_b, batch.deadline)
    prep.succ_cum.add_(succ_b.sum(dim=1, dtype=torch.int32))
    if prep.est is not None:
        prep.err_cum.add_(prep.est[:, start:stop].sum(dim=1))
    return succ_b


def _pipeline_geometry(rounds: int, round_chunk: int | None) -> tuple[int, int]:
    """(chunk, n_blocks) for the pipelined loop -- whole run = one block."""
    if round_chunk is not None and round_chunk <= 0:
        raise ValueError("round_chunk must be positive")
    chunk = rounds if round_chunk is None or round_chunk >= rounds else round_chunk
    return chunk, -(-rounds // chunk)


class _HostCopy:
    """Copies of device tensors to the host, off the compute stream.

    On the card each copy goes to a pinned buffer on a side stream that
    first waits for the work queued so far on the compute stream, and an
    event fences it; on the CPU the tensors are their own host copies.
    """

    def __init__(self, dev: torch.device):
        self.compute = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        self.side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None

    def start(self, *tensors: torch.Tensor):
        """``(host tensors, fence event or None)``."""
        if self.side is None:
            return tensors, None
        ready = torch.cuda.Event()
        ready.record(self.compute)
        hosts = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors)
        with torch.cuda.stream(self.side):
            self.side.wait_event(ready)
            for host, t in zip(hosts, tensors):
                host.copy_(t, non_blocking=True)
                t.record_stream(self.side)
            done = torch.cuda.Event()
            done.record(self.side)
        return hosts, done


def _run_group_pipelined(group: SweepGroup, batch: ScenarioBatch, draws,
                         dev: torch.device, round_chunk: int | None,
                         tap: bool) -> np.ndarray:
    rounds = group.rounds
    chunk, n_blocks = _pipeline_geometry(rounds, round_chunk)
    prep = _prepare_group(group, batch, draws, tap)
    storage = (prep.succ_cum.data_ptr(), prep.err_cum.data_ptr())
    rows = np.arange(prep.states.shape[0], dtype=np.int32)
    copier = _HostCopy(dev)
    host_blocks: list[np.ndarray | None] = [None] * n_blocks
    inflight: collections.deque = collections.deque()
    layout = None
    fold_s = dispatch_s = 0.0

    def fold_oldest():
        nonlocal fold_s
        j, hosts, done = inflight.popleft()
        t0 = time.perf_counter()
        with _phase("fetch", dev):
            if done is not None:
                done.synchronize()              # waits for block j's copy only
            host_blocks[j] = hosts[0].numpy()
        if tap:
            succ_h, err_h = _taps.unpack_words(hosts[1].numpy(), layout)
            throughput._emit_pool(rows, j, min((j + 1) * chunk, rounds), succ_h, err_h,
                                  fixed_bound=False)
        fold_s += time.perf_counter() - t0

    for bi in range(n_blocks):
        t0 = time.perf_counter()
        start = bi * chunk
        succ_b = _block_step(group, batch, draws, prep, start, min(start + chunk, rounds))
        snapshot = ()
        if tap:     # the carries after this block, before the next adds to them
            words, layout = _taps.pack_words(prep.succ_cum, prep.err_cum)
            snapshot = (words,)
        inflight.append((bi, *copier.start(succ_b, *snapshot)))
        dispatch_s += time.perf_counter() - t0
        if len(inflight) >= PIPELINE_DEPTH:
            fold_oldest()
    while inflight:
        fold_oldest()
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    drain_s = time.perf_counter() - t0

    _PIPELINE_STATS.update(
        blocks=n_blocks, round_chunk=chunk,
        donated=(prep.succ_cum.data_ptr(), prep.err_cum.data_ptr()) == storage,
        fold_s=fold_s, dispatch_s=dispatch_s, drain_s=drain_s,
    )
    return host_blocks[0] if n_blocks == 1 else np.concatenate(host_blocks, axis=1)


def run_group(
    group: SweepGroup,
    *,
    round_chunk: int | None = None,
    draws: Draws | None = None,
    device=None,
    telemetry: bool = False,
    tap: bool = False,
    tap_stride: int | None = None,
    pipeline: bool = False,
):
    """Execute one group; returns the host (B, rounds, S) bool success array.

    With ``telemetry=True`` returns ``(succ, TelemetryFrame)``, the frame's
    leaves host arrays with the same leading (B,) rows as ``succ``.  With
    ``tap=True`` the engine delivers per-row block aggregates to the
    registered tap handlers during the run (``row`` = the batch index); the
    successes are the same either way.

    ``pipeline=True`` selects the pipelined path (the section above): the
    same successes as the sync path at the same ``round_chunk`` and draws,
    :func:`last_pipeline_stats` for the loop's accounting, and the call's
    wall-clock in ``phase.sweeps_pipeline.seconds``.  Telemetry frames are
    whole-run artifacts, so ``telemetry=True`` raises; tap events stream one
    a row a block, and ``tap_stride`` (the sync path's knob) is ignored.
    While the static resampler reads a flag back every try, the pipelined
    path is not faster than the sync one on the card (the section above).
    """
    if group.rounds < 1:
        names = ", ".join(sc.name for sc in group.scenarios[:3])
        raise ValueError(
            f"group [{names}, ...] has rounds={group.rounds}; catalogue-only "
            "scenario families (e.g. kstar_table) cannot be simulated"
        )
    dev = resolve_device(device)
    if draws is None:
        draws = torch_draws(group.generator_seed, dev)
    if pipeline:
        if telemetry:
            raise ValueError(
                "pipeline=True is incompatible with telemetry=True: telemetry "
                "frames are whole-run artifacts (use tap= for live streams)"
            )
        batch, cached = _cached_shard(group, dev)
        c0 = _obs_counters.backend_compile_events()
        t0 = time.perf_counter()
        with _metrics.timed("phase.sweeps_pipeline"):
            succ = _run_group_pipelined(group, batch, as_draws(draws, dev), dev,
                                        round_chunk, tap)
        _PIPELINE_STATS["shard_cached"] = cached
        _metrics.record_compile("sweeps.pipeline",
                                _obs_counters.backend_compile_events() - c0,
                                time.perf_counter() - t0)
        return succ
    c0 = _obs_counters.compile_events()
    t0 = time.perf_counter()
    with _metrics.timed("phase.sweeps_run_group"):
        with _phase("lift", dev):
            batch = group.batch.to(dev)
        out = throughput.sweep_pool(
            draws, batch.pool, batch.p_gg, batch.p_bb, batch.mu_g, batch.mu_b,
            batch.deadline, group.rounds, group.strategies, round_chunk,
            telemetry, tap, tap_stride, device=dev,
        )
        with _phase("fetch", dev):
            succ = (out[0] if telemetry else out).cpu().numpy()
    _metrics.record_compile("sweeps.run_group", _obs_counters.compile_events() - c0,
                            time.perf_counter() - t0)
    if not telemetry:
        return succ
    b = group.batch.rows
    with _phase("fetch", dev):
        return succ[:b], type(out[1])(*(x[:b].cpu().numpy() for x in out[1]))


def run_groups(
    groups: Sequence[SweepGroup],
    *,
    round_chunk: int | None = None,
    draws: Callable[[SweepGroup], Draws] | None = None,
    device=None,
    tap: bool = False,
    tap_stride: int | None = None,
    pipeline: bool = False,
) -> list[np.ndarray]:
    """Execute every group; list aligned with ``groups``.  ``draws`` maps a
    group to its :class:`Draws` (default: the group's own generator)."""
    return [run_group(g, round_chunk=round_chunk,
                      draws=None if draws is None else draws(g), device=device,
                      tap=tap, tap_stride=tap_stride, pipeline=pipeline)
            for g in groups]


def suggest_round_chunk(group: SweepGroup, *, budget_bytes: int = 8 << 30,
                        pipeline: bool = False) -> int | None:
    """A round_chunk that keeps one block's per-round tensors under budget.

    Per (row, round) a block holds the (S + 2) (n,)-wide score and draw
    tensors with temporaries (~8 floats each) and, per allocator strategy,
    the DP's inputs, output and sort indices (~10 words of n).  The
    trajectory and policy replay span all rounds whatever the chunk.
    Returns None when the whole run fits.

    ``pipeline=True`` halves the budget: the pipelined path keeps up to
    ``PIPELINE_DEPTH`` (= 2) blocks live at once.
    """
    if pipeline:
        budget_bytes //= PIPELINE_DEPTH
    b = group.batch.rows
    n = group.n_max
    s = len(group.strategies)
    a = len(throughput.allocator_strategies(group.strategies))
    per_round = 4 * b * n * (8 * (s + 2) + 10 * a)
    chunk = max(1, budget_bytes // max(per_round, 1))
    return None if chunk >= group.rounds else int(chunk)


def run(
    family_or_scenarios,
    *,
    seeds: int = 1,
    round_chunk: int | None = None,
    draws: Callable[[SweepGroup], Draws] | None = None,
    device=None,
    tap: bool = False,
    tap_stride: int | None = None,
    pipeline: bool = False,
    **params,
):
    """The one-liner: expand -> group -> execute -> summarize.

    ``family_or_scenarios`` is a registered family name (``**params`` go to
    its expansion) or an iterable of
    :class:`~repro_torch.sweeps.registry.Scenario`.  ``tap`` /
    ``tap_stride`` / ``pipeline`` pass through to :func:`run_group`.
    Returns a list of :class:`~repro_torch.sweeps.results.ScenarioResult`
    in scenario order.
    """
    from . import results as results_mod
    from .registry import build_groups

    scenarios = _scenarios(family_or_scenarios, params)
    groups = build_groups(scenarios, seeds=seeds)
    succs = run_groups(groups, round_chunk=round_chunk, draws=draws,
                       device=device, tap=tap, tap_stride=tap_stride,
                       pipeline=pipeline)
    return results_mod.summarize(groups, succs, scenario_order=scenarios)


def _scenarios(family_or_scenarios, params) -> tuple:
    from .registry import expand

    if isinstance(family_or_scenarios, str):
        return expand(family_or_scenarios, **params)
    if params:
        raise TypeError("family params only apply to a named family")
    return tuple(family_or_scenarios)


def _slice_group_rows(group: SweepGroup, process_id: int,
                      num_processes: int) -> SweepGroup:
    """The sub-group of rows ``r`` with ``r % num_processes == process_id``.

    Interleaving (not a contiguous split) balances scenarios and seeds
    across processes.  The sub-group keeps the group's scenarios, so its
    ``rows`` (:class:`~repro_torch.sweeps.registry.RowMeta`) name each row
    exactly; its generator seed is a hash of its own rows' seed pairs.
    """
    batch = ScenarioBatch(*(t[process_id::num_processes].contiguous() for t in group.batch))
    return dataclasses.replace(group, batch=batch,
                               rows=tuple(group.rows[process_id::num_processes]))


def run_multihost(
    family_or_scenarios,
    *,
    spool_dir,
    seeds: int = 1,
    round_chunk: int | None = None,
    draws: Callable[[SweepGroup], Draws] | None = None,
    device=None,
    pipeline: bool = False,
    timeout_s: float = 600.0,
    **params,
):
    """:func:`run` over a ``torch.distributed`` group: row shards per
    process, merged by process 0.

    Every process expands the same scenario list and groups, runs the
    interleaved rows ``rows[pid::P]`` of every group through
    :func:`run_group` on its own device (``pipeline=`` and ``draws=`` pass
    through; ``draws`` receives the sub-group), and publishes its shard to
    ``spool_dir`` by atomic rename
    (:func:`repro_torch.sweeps.results.write_row_shard`).  Process 0 merges
    the shards back into row order and summarizes; every other process
    returns ``None``.  The world comes from
    :func:`repro_torch.launch.mesh.world`; at world 1 this IS :func:`run`.

    Draws.  Under a position-keyed source (the JAX package's keys replayed
    for each sub-group's rows) the merged successes equal one process's
    bit for bit.  Under the default generator each shard draws from its own
    sub-group's hashed seed (:attr:`SweepGroup.generator_seed`), so the
    merge is a valid stream of the same distribution but not one process's
    numbers.
    """
    from repro_torch.launch import mesh as mesh_mod

    from . import results as results_mod
    from .registry import build_groups

    pid, nprocs = mesh_mod.world()
    if nprocs == 1:
        return run(family_or_scenarios, seeds=seeds, round_chunk=round_chunk,
                   draws=draws, device=device, pipeline=pipeline, **params)
    scenarios = _scenarios(family_or_scenarios, params)
    groups = build_groups(scenarios, seeds=seeds)
    for gi, group in enumerate(groups):
        sub = _slice_group_rows(group, pid, nprocs)
        if sub.batch.rows == 0:      # more processes than rows: empty shard
            succ = np.zeros((0, group.rounds, len(group.strategies)), bool)
        else:
            succ = run_group(sub, round_chunk=round_chunk,
                             draws=None if draws is None else draws(sub),
                             device=device, pipeline=pipeline)
        results_mod.write_row_shard(spool_dir, gi, pid, nprocs, succ)
    if pid != 0:
        return None
    succs = [results_mod.merge_row_shards(spool_dir, gi, nprocs, timeout_s=timeout_s)
             for gi in range(len(groups))]
    return results_mod.summarize(groups, succs, scenario_order=scenarios)


__all__ = ["PIPELINE_DEPTH", "compile_cache_size", "last_pipeline_stats", "run",
           "run_group", "run_groups", "run_multihost", "suggest_round_chunk"]
