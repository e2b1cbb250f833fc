"""The port's speed layer against the JAX package's, on the CPU.

``repro_torch.sweeps``' chunked ``run_group``, ``run_multihost`` with its
row shards, ``repro_torch.launch`` (``mesh``, ``cache``, ``hlo_cost``) and
the cache counters, beside ``repro.sweeps`` / ``repro.launch`` /
``repro.obs``.  With the JAX package's uniforms replayed (``JaxDraws``) the
port's ``run_group`` equals the JAX package's pipelined path to the bit at
the same ``round_chunk``, chunked and unchunked, successes and tap events
alike.  Also here: the two faults of the port found against the
reference (``tap_row`` of ``simulate_strategies_pool``, ``STRATEGIES``) and
the static resampler's one host read a try.

Run as a script with ``--worker`` this file is one process of the
two-process ``run_multihost`` test.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.obs as jobs
from repro import sweeps as jsweeps
from repro.core import lea as jlea
from repro.core import throughput as jtp
from repro.launch import hlo_cost as jhlo_cost
from repro.sweeps import executor as jexecutor
from repro_torch import core, obs, sweeps
from repro_torch.core import throughput
from repro_torch.core.lea import LoadParams, pool_load
from repro_torch.kernels import build, static_resample
from repro_torch.kernels.static_resample import StaticResampleRef
from repro_torch.launch import cache, hlo_cost, mesh
from repro_torch.obs import counters
from repro_torch.random import RecordedDraws, ReplayedDraws, torch_draws
from repro_torch.sweeps import executor
from repro_torch.sweeps import results as results_mod
import _resample_cases as resample_cases
from test_torch_engine import JaxDraws

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
EST_RTOL = 1e-6
LP = LoadParams(15, 99, 10, 3)
FAMILIES = {
    "hetero_kstar": dict(ks=(50, 99), lams=(0.2,)),
    "arrival_grid": dict(rates=(0.6, 2.4), deadline_rels=(1,)),
}
MULTI_KW = dict(ks=(50, 99), lams=(0.2, 0.7), rounds=96)
# the JAX package's run_group options for its pipelined path (the port has none)
JAX_PIPELINED = {"pipeline": True}
MULTI_SEEDS = 2


def _groups(family, rounds, seeds=2, **kw):
    params = dict(FAMILIES.get(family, {}), rounds=rounds, **kw)
    jgroup, = jsweeps.build_groups(jsweeps.expand(family, **params), seeds=seeds)
    group, = sweeps.build_groups(sweeps.expand(family, **params), seeds=seeds)
    return jgroup, group


def _row_draws(family, seeds, **params):
    """A ``draws=`` factory handing any (sub-)group the JAX package's keys of
    its own rows, picked by scenario names and ``RowMeta``."""
    keys = {}
    for g in jsweeps.build_groups(jsweeps.expand(family, **params), seeds=seeds):
        names = tuple(sc.name for sc in g.scenarios)
        for row, key in zip(g.rows, np.array(g.batch.keys)):
            keys[names, tuple(row)] = key

    def factory(group):
        names = tuple(sc.name for sc in group.scenarios)
        return JaxDraws(np.stack([keys[names, tuple(row)] for row in group.rows]))
    return factory


def _by_row_block(events):
    return {(int(e["row"]), int(e["block"])): e for e in events}


def _assert_same_events(got, want):
    g, w = _by_row_block(got), _by_row_block(want)
    assert len(g) == len(got) and sorted(g) == sorted(w)
    for key, we in w.items():
        ge = g[key]
        assert set(ge) == set(we)
        for k in we:
            if k == "host_time":
                continue
            if k == "engine":
                assert ge[k] == we[k]
                continue
            a, b = np.asarray(ge[k]), np.asarray(we[k])
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
            if k == "est_err_so_far":
                np.testing.assert_allclose(a, b, rtol=EST_RTOL, atol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)


# ---------------------------------------------------------------------------
# the two faults found against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("round_chunk,tap_stride", [(None, 50), (128, None)])
def test_simulate_strategies_pool_labels_tap_events_with_tap_row(round_chunk, tap_stride):
    rounds, key = 300, jax.random.PRNGKey(4)
    chain = ([0.8] * 15, [0.7] * 15)
    with jobs.capture_taps() as want:
        jtp.simulate_strategies_pool(
            key, jlea.pool_load(LP), *(np.float32(chain[0]), np.float32(chain[1])),
            10.0, 3.0, 1.0, rounds=rounds, round_chunk=round_chunk, tap=True,
            tap_stride=tap_stride, tap_row=3)
    with obs.capture_taps() as got:
        throughput.simulate_strategies_pool(
            JaxDraws(np.array(key)[None]), pool_load(LP, device=CPU), *chain, 10.0, 3.0,
            1.0, rounds, round_chunk=round_chunk, tap=True, tap_stride=tap_stride,
            tap_row=3, device=CPU)
    assert len(got) == len(want) > 1
    assert {int(e["row"]) for e in got} == {3}
    _assert_same_events(got, want)


def test_strategies_tuple_is_the_jax_packages():
    assert core.STRATEGIES == throughput.STRATEGIES == jcore.STRATEGIES
    assert all(throughput.strategy_known(s) for s in core.STRATEGIES)


# ---------------------------------------------------------------------------
# the static resampler: one host read a try
# ---------------------------------------------------------------------------

def _static_loads_one_read_a_strategy(draws, rounds, start, stop, pis, kstar, ell_g,
                                      ell_b, mask=None, redrawn=None):
    """The resampler as it read its flags before: one host read a strategy.
    ``redrawn`` collects the unfinished (strategy, round) pairs of each try."""
    b, n = pis[0].shape
    m = stop - start

    def masked(loads):
        return loads if mask is None else torch.where(mask[:, None, :], loads, 0)

    loads = [torch.zeros((b, m, n), dtype=torch.int32) for _ in pis]
    for t in range(throughput.STATIC_MAX_TRIES):
        redo = [masked(x).sum(dim=-1) < kstar for x in loads]
        if not any(bool(r.any()) for r in redo):
            break
        if redrawn is not None:
            redrawn.append(sum(int(r.sum()) for r in redo))
        u = draws.static(b, rounds, start, stop, n, t)
        for j, pi in enumerate(pis):
            new = torch.where(u < pi[:, None, :], ell_g, ell_b).to(torch.int32)
            loads[j] = torch.where(redo[j][..., None], new, loads[j])
    return [(masked(x), masked(x).sum(dim=-1) >= kstar) for x in loads]


@pytest.mark.parametrize("source", ["torch", "jax"])
def test_static_resampler_makes_the_same_tries_with_one_read_a_try(source):
    rng = np.random.default_rng(5)
    b, rounds, n = 3, 40, 12
    pis = [torch.from_numpy(rng.uniform(0.3, 0.9, (b, n)).astype(np.float32)),
           torch.full((b, n), 0.5)]
    mask = torch.from_numpy(np.arange(n) < np.array([[12], [9], [10]]))
    kstar = torch.tensor([70, 50, 75], dtype=torch.int32)[:, None]
    ell_g = torch.tensor([8, 7, 9], dtype=torch.int32)[:, None, None]
    ell_b = torch.tensor([3, 2, 4], dtype=torch.int32)[:, None, None]

    def source_draws():
        if source == "torch":
            return RecordedDraws(torch_draws(11, CPU))
        return RecordedDraws(JaxDraws(np.stack([jax.random.PRNGKey(i) for i in range(b)])))

    new_draws, old_draws = source_draws(), source_draws()
    for start, stop in [(0, 40), (8, 24)]:
        got = throughput._static_loads_batch(new_draws, rounds, start, stop, pis, kstar,
                                             ell_g, ell_b, mask)
        want = _static_loads_one_read_a_strategy(old_draws, rounds, start, stop, pis,
                                                 kstar, ell_g, ell_b, mask)
        for (gl, gf), (wl, wf) in zip(got, want):
            assert torch.equal(gl, wl) and torch.equal(gf, wf)
    assert len(new_draws.calls) == len(old_draws.calls) > 2
    for a, b_ in zip(new_draws.calls, old_draws.calls):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("name", resample_cases.CASES)
def test_static_resample_counter_counts_the_plain_routes_tries(name, monkeypatch):
    """``tries`` equals the draws (one a ``repro.static_wait`` read but the
    last, unless the cap ends the loop), ``redraws`` the unfinished pairs of
    every try as the old one-read-a-strategy loop finds them, ``slots``
    S x B x m a try."""
    case = resample_cases.resample_case(name, CPU)
    waits = []

    @contextlib.contextmanager
    def phase(label, device=None):
        waits.append(label)
        yield

    monkeypatch.setattr(throughput, "_phase", phase)
    draws = RecordedDraws(torch_draws(13, CPU))
    static_resample.reset_engagement()
    got = throughput._static_loads_batch(draws, *resample_cases.batch_args(case))
    counts = static_resample.engagement()
    redrawn = []
    want = _static_loads_one_read_a_strategy(ReplayedDraws(draws.calls),
                                             *resample_cases.batch_args(case),
                                             redrawn=redrawn)
    for (gl, gf), (wl, wf) in zip(got, want):
        assert torch.equal(gl, wl) and torch.equal(gf, wf)
    tries = len(draws.calls)
    capped = tries == throughput.STATIC_MAX_TRIES
    assert waits == ["static_wait"] * (tries + (not capped))
    b, m = case["pis"][0].shape[0], case["stop"] - case["start"]
    assert counts == {"tries": tries, "redraws": sum(redrawn),
                      "slots": tries * len(case["pis"]) * b * m}
    assert len(redrawn) == tries
    resample_cases.check_edges(name, case, got, tries)


@pytest.mark.parametrize("name", resample_cases.CASES)
def test_static_resample_ref_is_the_one_read_a_strategy_loop(name):
    case = resample_cases.resample_case(name, CPU)
    draws = RecordedDraws(torch_draws(17, CPU))
    got, reads = resample_cases.drive(StaticResampleRef(*resample_cases.resampler_args(case)),
                                      draws, case)
    old_draws = RecordedDraws(torch_draws(17, CPU))
    redrawn = []
    want = _static_loads_one_read_a_strategy(old_draws, *resample_cases.batch_args(case),
                                             redrawn=redrawn)
    for (gl, gf), (wl, wf) in zip(got, want):
        assert torch.equal(gl, wl) and torch.equal(gf, wf)
    assert [r for r in reads if r] == redrawn
    assert len(draws.calls) == len(old_draws.calls) == len(redrawn)
    for a, b_ in zip(draws.calls, old_draws.calls):
        assert torch.equal(a, b_)


# ---------------------------------------------------------------------------
# engine_block and run_group against the JAX package's pipelined path
# ---------------------------------------------------------------------------

def test_engine_block_matches_jax_on_replayed_draws():
    rounds, start, stop = 64, 16, 48
    strategies = ("lea", "static", "static_equal", "static_single", "oracle")
    key = jax.random.PRNGKey(9)
    rng = np.random.default_rng(9)
    p_gg = rng.uniform(0.55, 0.95, 15).astype(np.float32)
    p_bb = rng.uniform(0.4, 0.9, 15).astype(np.float32)
    pool = jlea.pool_load(LP)
    states, round_keys, p_alloc, pi_g = jtp.engine_preamble(key, pool, p_gg, p_bb, rounds,
                                                             strategies)
    want = jtp.engine_block(states[start:stop], round_keys[start:stop],
                            p_alloc[:, start:stop], pi_g, pool, strategies, 10.0, 3.0, 1.0)

    draws = JaxDraws(np.array(key)[None])
    tpool = throughput._batch_pool(pool_load(LP, device=CPU), 1, CPU)
    t_states, t_alloc, t_pi = throughput.engine_preamble(
        draws, tpool.mask, torch.from_numpy(p_gg)[None], torch.from_numpy(p_bb)[None],
        rounds, strategies)
    one = lambda v: torch.tensor([v], dtype=torch.float32)
    got = throughput.engine_block(t_states[:, start:stop], draws, rounds, start,
                                  t_alloc[:, :, start:stop], t_pi, tpool, strategies,
                                  one(10.0), one(3.0), one(1.0))
    assert got.shape == (1, stop - start, len(strategies)) and got.dtype == torch.bool
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("family,rounds,round_chunk", [
    ("hetero_kstar", 64, None), ("hetero_kstar", 64, 16), ("hetero_kstar", 96, 24),
    ("arrival_grid", 64, None), ("arrival_grid", 64, 16), ("arrival_grid", 96, 24),
    ("fig3", 256, 100), ("fig3", 256, None), ("hetero_kstar", 256, 48),
])
def test_run_group_matches_the_jax_pipelined_path_bit_for_bit(family, rounds, round_chunk):
    jgroup, group = _groups(family, rounds)
    want = jexecutor.run_group(jgroup, round_chunk=round_chunk, **JAX_PIPELINED)
    got = executor.run_group(group, round_chunk=round_chunk, device=CPU,
                             draws=JaxDraws(np.array(jgroup.batch.keys)))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_run_group_records_one_phase_metric_a_call():
    name = "phase.sweeps_run_group.seconds"
    before = obs.default_metrics.get(name)["count"]
    groups = sweeps.build_groups(sweeps.expand("hetero_kstar", rounds=32,
                                               **FAMILIES["hetero_kstar"]))
    sweeps.run("hetero_kstar", rounds=32, device=CPU, **FAMILIES["hetero_kstar"])
    assert obs.default_metrics.get(name)["count"] == before + len(groups)


@pytest.mark.parametrize("round_chunk", [16, 24])
def test_run_group_tap_events_equal_the_jax_pipelined_events(round_chunk):
    jgroup, group = _groups("hetero_kstar", 64)
    with jobs.capture_taps() as want:
        jexecutor.run_group(jgroup, round_chunk=round_chunk, tap=True, **JAX_PIPELINED)
    with obs.capture_taps() as got:
        succ = executor.run_group(group, round_chunk=round_chunk, tap=True, device=CPU,
                                  draws=JaxDraws(np.array(jgroup.batch.keys)))
    blocks = -(-64 // round_chunk)
    assert len(got) == group.batch.rows * blocks
    for e in got:
        obs.validate_event(e)
    _assert_same_events(got, want)
    last = {int(e["row"]): e for e in got}
    for r, e in last.items():
        assert int(e["rounds_done"]) == 64
        np.testing.assert_array_equal(e["succ_so_far"], succ[r].sum(axis=0))


# ---------------------------------------------------------------------------
# processes: mesh, run_multihost, row shards
# ---------------------------------------------------------------------------

def _manifest_doc(results):
    doc = results_mod.manifest(results, bench="multihost_test", timestamp=0.0)
    doc.pop("provenance", None)
    return json.dumps(doc, sort_keys=True)


def _multi_kwargs(spool):
    return dict(seeds=MULTI_SEEDS, spool_dir=spool, round_chunk=24,
                draws=_row_draws("hetero_kstar", MULTI_SEEDS, **MULTI_KW), device=CPU,
                **MULTI_KW)


def _worker(pid: int, coord: str, spool: str, out_path: str) -> None:
    assert mesh.init_distributed(coordinator=coord, num_processes=2,
                                 process_id=pid) == (pid, 2)
    results = sweeps.run_multihost("hetero_kstar", **_multi_kwargs(spool))
    if pid == 0:
        Path(out_path).write_text(_manifest_doc(results))
    else:
        assert results is None
    torch.distributed.destroy_process_group()


def test_init_distributed_without_a_group_touches_nothing(monkeypatch):
    for var in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.init_distributed() == (0, 1) == mesh.world()
    assert mesh.init_distributed(coordinator="localhost:1", num_processes=1) == (0, 1)
    assert not torch.distributed.is_initialized()


def test_two_processes_merge_to_the_single_process_run(tmp_path, monkeypatch):
    for var in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    kwargs = _multi_kwargs(tmp_path / "unused")
    ref = sweeps.run("hetero_kstar", **{k: v for k, v in kwargs.items() if k != "spool_dir"})
    # world 1: run_multihost is run, and writes no spool
    assert _manifest_doc(sweeps.run_multihost("hetero_kstar", **kwargs)) == _manifest_doc(ref)
    assert not (tmp_path / "unused").exists()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        coord = f"localhost:{s.getsockname()[1]}"
    spool, out = tmp_path / "spool", tmp_path / "multi.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(pid), coord,
                               str(spool), str(out)], env=env, cwd=str(ROOT),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    assert out.read_text() == _manifest_doc(ref)
    assert sorted(os.listdir(spool)) == ["group0_shard0of2.npy", "group0_shard1of2.npy"]


def test_row_shards_round_trip_and_a_missing_shard_is_named(tmp_path):
    rng = np.random.default_rng(0)
    full = rng.random((7, 5, 3)) < 0.5
    for pid in range(3):
        path = results_mod.write_row_shard(tmp_path, 4, pid, 3, full[pid::3])
        assert Path(path).name == f"group4_shard{pid}of3.npy"
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
    np.testing.assert_array_equal(results_mod.merge_row_shards(tmp_path, 4, 3), full)
    results_mod.write_row_shard(tmp_path, 5, 1, 2, full[1::2])
    with pytest.raises(TimeoutError, match="group5_shard0of2.npy"):
        results_mod.merge_row_shards(tmp_path, 5, 2, timeout_s=0.1, poll_s=0.01)


# ---------------------------------------------------------------------------
# the compile cache and its counters
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_cache(monkeypatch):
    """The cache switch and the noted hits as a fresh process has them;
    restored after the test."""
    monkeypatch.setitem(cache._STATE, "enabled_dir", None)
    monkeypatch.setattr(build, "_CACHE_DIR", None)
    monkeypatch.setattr(build, "_BUILDS", {})
    monkeypatch.setattr(counters, "_NOTED_HITS", 0)
    monkeypatch.delenv(cache.CACHE_ENV, raising=False)


def test_enable_compile_cache_moves_the_library_directory(fresh_cache, tmp_path, monkeypatch):
    assert cache.enable_compile_cache() is None and cache.cache_dir() is None
    assert build.build_dir() == build.BUILD_DIR
    monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path / "libs"))
    target = cache.enable_compile_cache()
    assert target == str(tmp_path / "libs") == cache.cache_dir()
    assert (tmp_path / "libs").is_dir()
    assert cache.enable_compile_cache(str(tmp_path / "libs")) == target
    with pytest.raises(RuntimeError, match="already enabled"):
        cache.enable_compile_cache(str(tmp_path / "other"))
    assert build.build_dir() == tmp_path / "libs"
    assert build.library_path("poisson_binomial").parent == tmp_path / "libs"
    # a build into the cache is a miss, a library found there a hit
    build._BUILDS["poisson_binomial"] = build.BuildResult(
        "poisson_binomial", build.library_path("poisson_binomial"), 2.5, "")
    build._BUILDS["gf_matmul"] = build.BuildResult(
        "gf_matmul", build.library_path("gf_matmul"), 0.0, "")
    assert cache.persistent_cache_misses() == 1
    assert counters.persistent_cache_hits() == 1


def test_cache_hit_counters(fresh_cache):
    assert counters.persistent_cache_hits() == 0
    counters.note_persistent_cache_hits(2)
    counters.note_persistent_cache_hits()
    assert counters.persistent_cache_hits() == 3
    with pytest.raises(ValueError, match=">= 0"):
        counters.note_persistent_cache_hits(-1)
    assert cache.persistent_cache_misses() == 0
    build._BUILDS["poisson_binomial"] = build.BuildResult("poisson_binomial", Path("x"), 3.0, "")
    build._BUILDS["gf_matmul"] = build.BuildResult("gf_matmul", Path("y"), 0.0, "")
    # a port compile event is an nvcc run: no hit is subtracted from it
    assert counters.backend_compile_events() == counters.compile_events() == 1
    assert counters.backend_compile_events("build.gf_matmul") == 0
    assert counters.persistent_cache_hits() == 4


# ---------------------------------------------------------------------------
# the cost rows
# ---------------------------------------------------------------------------

def test_hlo_cost_cli_lists_and_rejects(capsys):
    hlo_cost.main(["--list"])
    listed = capsys.readouterr().out.split()
    assert listed == list(hlo_cost.entry_point_names()) == list(jhlo_cost.entry_point_names())
    with pytest.raises(SystemExit, match="(?s)unknown entry point.*nope.*available: "
                                         "simulate_strategies_pool, sweep_faults, sweep_serving"):
        hlo_cost.main(["nope"])
    with pytest.raises(KeyError, match="unknown entry point"):
        hlo_cost.estimate_entry("nope")


def test_estimate_entry_rows_have_the_jax_keys():
    want = jhlo_cost.estimate_entry("simulate_strategies_pool")
    rows = [hlo_cost.estimate_entry(name, device=CPU) for name in hlo_cost.entry_point_names()]
    for row in rows:
        assert set(row) == set(want)
        assert row["flops"] > 0 and row["hbm_bytes"] > 0
        assert row["collective_bytes"] == 0 and row["per_collective"] == {}
        assert row["rounds"] == want["rounds"] and row["n"] == want["n"]
        assert row["flops"] == row["matmul_flops"] + row["other_flops"]
    # a matmul counts 2 M N K, a reduction its input, a view nothing
    costs = hlo_cost.count(lambda: (torch.ones(4, 3) @ torch.ones(3, 5)).sum().view(1))
    assert costs.matmul_flops == 2 * 4 * 5 * 3 and costs.other_flops == 4 * 3 + 3 * 5 + 20
    # an allocation writes nothing and counts nothing
    assert hlo_cost.count(lambda: torch.empty(64)).hbm_bytes == 0


@pytest.mark.parametrize("expand", [False, True], ids=["as-held", "stride-0"])
def test_op_counter_adds_each_b1_launch_by_its_own_work(expand):
    """A B1 launch (a ctypes call no dispatch mode sees) reaches the counter
    through the wrapper's launch observer: its inputs read and output written
    once, the DP's operations on this data, and nothing for counting them."""
    from repro_torch.kernels.poisson_binomial import kernel as pb

    rng = np.random.default_rng(3)
    n, lead = 4, (2, 3, 5)
    probs = torch.from_numpy(rng.uniform(0, 1, lead + (n,)).astype(np.float32))
    w_np = rng.integers(-2, n + 2, (1, 3, 1, n)).astype(np.int32)
    w = torch.from_numpy(w_np)
    if expand:
        w = w.expand(lead + (n,))
    with hlo_cost.OpCounter() as counter:
        assert counter.kernel_launch in pb._OBSERVERS
        counter.kernel_launch(probs, w)
    assert counter.kernel_launch not in pb._OBSERVERS
    rows = 2 * 3 * 5
    tails = sum(i + 2 - max(int(t), 0) for t_row in w_np.reshape(3, n)
                for i, t in enumerate(t_row) if t <= i + 1) * (rows // 3)
    want_ops = rows * (n * (n + 1) + 2 * n) + tails
    want_bytes = 2 * probs.numel() * 4 + 3 * n * 4
    c = counter.costs
    assert pb.launch_work(probs, w) == (want_bytes, want_ops)
    assert (c.kernel_launches, c.kernel_flops, c.kernel_bytes) == (1, want_ops, want_bytes)
    assert (c.other_flops, c.hbm_bytes, c.matmul_flops) == (want_ops, want_bytes, 0)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
