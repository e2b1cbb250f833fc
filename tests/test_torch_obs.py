"""The port's observability slice (``repro_torch.obs`` and the ``telemetry=`` /
``tap=`` flags of its engines) against the JAX package's ``repro.obs``, on the
CPU.

The same inputs, from a seed, go through both packages; the port's draws
replay ``jax.random``'s (``JaxDraws`` and its fault and serving extensions),
so every telemetry field and tap event equals ``repro``'s: integer fields
exactly, the estimator-error stream to float32 rounding (rtol 1e-6: the
worker sum runs in PyTorch's order, not XLA's), the ``oracle`` column
exactly 0.  Tap events are compared per (row, strategy, block), the order
in which each package delivers them (``host_time`` aside).
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro import faults as jfaults
from repro import serving as jserving
from repro import sweeps as jsweeps
from repro.obs import history as jhistory
from repro.obs import metrics as jmetrics
from repro_torch import faults, obs, serving, sweeps
from repro_torch.core import coded_ops, lagrange, throughput
from repro_torch.core.lea import LoadParams, pool_load
from repro_torch.launch import serve
from repro_torch.obs import counters, history, metrics, taps
from repro_torch.obs.profiling import ENGINE_PHASES
from repro_torch.obs.provenance import has_required_fields
from repro_torch.random import as_draws
from test_torch_engine import JaxDraws
from test_torch_faults import JaxFaultDraws, _grid
from test_torch_serving import JaxServingDraws, _keys

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
EST_RTOL = 1e-6


def _by_key(events):
    """Events grouped per (row, strategy), each group in delivery order."""
    out = {}
    for e in events:
        out.setdefault((int(e["row"]), int(e.get("strategy", -1))), []).append(e)
    return out


def _assert_same_events(got, want, float_keys=()):
    """Event for event per (row, strategy); ``float_keys`` at rtol 1e-6, the
    rest exact with the JAX package's dtypes."""
    g, w = _by_key(got), _by_key(want)
    assert sorted(g) == sorted(w)
    for key in w:
        # the port delivers each (row, strategy)'s events in block order
        assert [int(e["block"]) for e in g[key]] == list(range(len(g[key])))
        w_sorted = sorted(w[key], key=lambda e: int(e["block"]))
        assert len(g[key]) == len(w_sorted), key
        for ge, we in zip(g[key], w_sorted):
            assert set(ge) == set(we)
            for k in we:
                if k == "host_time":
                    continue
                if k == "engine":
                    assert ge[k] == we[k]
                    continue
                a, b = np.asarray(ge[k]), np.asarray(we[k])
                assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
                if k in float_keys:
                    np.testing.assert_allclose(a, b, rtol=EST_RTOL, atol=0, err_msg=k)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=k)


# ---------------------------------------------------------------------------
# the engine: TelemetryFrame and engine.pool taps
# ---------------------------------------------------------------------------

def _fig3_group(rounds=256, seeds=2):
    jgroup, = jsweeps.build_groups(jsweeps.expand("fig3", rounds=rounds), seeds=seeds)
    group, = sweeps.build_groups(sweeps.expand("fig3", rounds=rounds), seeds=seeds)
    return jgroup, group, (lambda: JaxDraws(np.array(jgroup.batch.keys)))


@pytest.mark.parametrize("round_chunk", [None, 64])
def test_engine_frame_matches_jax(round_chunk):
    jgroup, group, draws = _fig3_group()
    want_succ, want = jsweeps.run_group(jgroup, round_chunk=round_chunk, telemetry=True)
    got_succ, got = sweeps.run_group(group, round_chunk=round_chunk, telemetry=True,
                                     draws=draws(), device=CPU)
    assert isinstance(got, obs.TelemetryFrame)
    np.testing.assert_array_equal(got_succ, np.asarray(want_succ))
    for field in ("prefix_size", "load_total", "received", "feasible"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.est_err.dtype == np.float32 and got.est_err.shape == (8, 256, 2)
    np.testing.assert_allclose(got.est_err, np.asarray(want.est_err), rtol=EST_RTOL, atol=0)
    oracle = throughput.allocator_strategies(group.strategies).index("oracle")
    assert not got.est_err[..., oracle].any()
    assert not np.asarray(want.est_err)[..., oracle].any()
    assert (got.est_err[..., 0] > 0).any()


@pytest.mark.parametrize("round_chunk,tap_stride", [(None, 64), (None, None), (64, None),
                                                    (100, None)])
def test_engine_tap_events_match_jax(round_chunk, tap_stride):
    """Unchunked: prefix sums at the stride boundaries; chunked: one event a
    block, the short last block (256 = 2 x 100 + 56) counting only its real
    rounds, as JAX's masked edge-padded block does."""
    jgroup, group, draws = _fig3_group()
    with jobs.capture_taps() as want:
        jsweeps.run_group(jgroup, round_chunk=round_chunk, tap=True, tap_stride=tap_stride)
    with obs.capture_taps() as got:
        sweeps.run_group(group, round_chunk=round_chunk, tap=True, tap_stride=tap_stride,
                         draws=draws(), device=CPU)
    assert len(got) == len(want) > 0
    for e in got:
        obs.validate_event(e)
    _assert_same_events(got, want, float_keys=("est_err_so_far",))
    last = {int(e["row"]): e for e in got}
    assert all(int(e["rounds_done"]) == 256 for e in last.values())


def test_engine_flags_leave_the_successes_alone():
    lp = LoadParams(15, 99, 10, 3)
    args = (pool_load(lp, device=CPU), [0.8] * 15, [0.7] * 15, 10.0, 3.0, 1.0, 300)
    for chunk in (None, 128):
        off = throughput.simulate_strategies_pool(JaxDraws(np.array(jax.random.PRNGKey(4))[None]),
                                                  *args, round_chunk=chunk, device=CPU)
        with obs.capture_taps() as events:
            on, frame = throughput.simulate_strategies_pool(
                JaxDraws(np.array(jax.random.PRNGKey(4))[None]), *args, round_chunk=chunk,
                telemetry=True, tap=True, tap_stride=50, device=CPU)
        assert torch.equal(off, on)
        assert frame.est_err.shape == (300, 2) and frame.received.dtype == torch.int32
        assert [int(e["row"]) for e in events] == [-1] * len(events)
        np.testing.assert_array_equal(events[-1]["succ_so_far"], off.sum(0).numpy())
        expect = [50, 100, 150, 200, 250, 300] if chunk is None else [128, 256, 300]
        assert [int(e["rounds_done"]) for e in events] == expect


def test_estimator_error_rounds_matches_jax_on_a_masked_pool():
    from repro.core import throughput as jtp

    rng = np.random.default_rng(3)
    b, m, n = 3, 40, 9
    states = rng.integers(0, 2, (b, m, n)).astype(np.int32)
    p_alloc = rng.uniform(0, 1, (2, b, m, n)).astype(np.float32)
    p_gg = rng.uniform(0.5, 0.95, (b, n)).astype(np.float32)
    p_bb = rng.uniform(0.4, 0.9, (b, n)).astype(np.float32)
    pi_g = rng.uniform(0.3, 0.7, (b, n)).astype(np.float32)
    mask = rng.random((b, n)) < 0.7
    got = throughput.estimator_error_rounds(
        torch.from_numpy(states), torch.from_numpy(p_alloc), torch.from_numpy(p_gg),
        torch.from_numpy(p_bb), torch.from_numpy(pi_g), torch.from_numpy(mask))
    for i in range(b):
        want = jtp.estimator_error_rounds(
            jnp.asarray(states[i]), jnp.asarray(p_alloc[:, i]), jnp.asarray(p_gg[i]),
            jnp.asarray(p_bb[i]), jnp.asarray(pi_g[i]), jnp.asarray(mask[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=EST_RTOL, atol=0)


# ---------------------------------------------------------------------------
# the fault sweep: FaultTelemetry and faults.sweep taps
# ---------------------------------------------------------------------------

def test_fault_telemetry_matches_jax():
    keys, channel, jargs, args, geometry = _grid(256)
    want_out, want = jfaults.sweep_faults(*jargs, **geometry, telemetry=True)
    got_out, got = faults.sweep_faults(JaxFaultDraws(keys, channel), *args, **geometry,
                                       telemetry=True, device=CPU)
    assert isinstance(got, faults.FaultTelemetry)
    for g, w in zip(got_out, want_out):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for field, g, w in zip(faults.FaultTelemetry._fields, got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == np.asarray(w).shape, field
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)
    assert (got.received_conserve >= got.received_aon).all()
    assert got.preempted.sum() > 0 and got.packets_lost.sum() > 0


def test_fault_tap_events_match_jax_and_flags_leave_outcomes_alone():
    keys, channel, jargs, args, geometry = _grid(256)
    with jobs.capture_taps() as want:
        jfaults.sweep_faults(*jargs, **geometry, tap=True, tap_stride=64)
    off = faults.sweep_faults(JaxFaultDraws(keys, channel), *args, **geometry, device=CPU)
    with obs.capture_taps() as got:
        on, tel = faults.sweep_faults(JaxFaultDraws(keys, channel), *args, **geometry,
                                      telemetry=True, tap=True, tap_stride=64, device=CPU)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert len(got) == len(want) == 4 * keys.shape[0]
    _assert_same_events(got, want)
    # the last event of each row is the run's totals
    for e in got[-keys.shape[0]:]:
        r = int(e["row"])
        assert int(e["preempted_so_far"]) == int(tel.preempted[r].sum())
        assert int(e["packets_lost_so_far"]) == int(tel.packets_lost[r].sum())
        np.testing.assert_array_equal(e["recovered_conserve_so_far"],
                                      on.full_conserve[r].sum(0).numpy())


def test_simulate_faults_telemetry_is_one_row_of_the_sweep():
    keys, channel, _, args, geometry = _grid(64)
    sweep_out, sweep_tel = faults.sweep_faults(JaxFaultDraws(keys, channel), *args, **geometry,
                                               telemetry=True, device=CPU)
    one_channel = faults.make_channel([
        ("preempt", {"p_preempt": float(args[6][0].p_preempt[0])}),
        ("packet_bernoulli", {"p_drop": float(args[6][1].p_drop[0])})])
    with obs.capture_taps() as events:
        out, tel = faults.simulate_faults(
            JaxFaultDraws(keys[:1], one_channel), args[0], args[1][0], args[2][0], *args[3:6],
            one_channel, args[7], **geometry, telemetry=True, tap=True, device=CPU)
    for field, g, w in zip(faults.FaultTelemetry._fields, tel, sweep_tel):
        assert torch.equal(g, w[0]), field
    assert torch.equal(out.full_aon, sweep_out.full_aon[0])
    assert [int(e["row"]) for e in events] == [-1]


# ---------------------------------------------------------------------------
# the serving loop: ServingTelemetry and serving taps
# ---------------------------------------------------------------------------

def _arrival_grid(rounds, controlled):
    """The arrival_grid as both packages' sweep_serving arguments."""
    scen = sweeps.expand("arrival_grid", rounds=rounds)
    b, lp, meta = len(scen), scen[0].lp, [dict(s.meta) for s in scen]
    keys = _keys(b, 3000)
    col = lambda k, dt: np.asarray([m[k] for m in meta], dt)
    rates, dl = col("rate", np.float32), col("deadline_rel", np.int32)
    if controlled:
        thr, cap = col("admit_threshold", np.float32), col("reserve_cap", np.float32)
    else:
        thr, cap = np.zeros(b, np.float32), np.full(b, jserving.ADMIT_ALL_CAP, np.float32)
    p_gg = np.asarray([s.p_gg for s in scen], np.float32)
    p_bb = np.asarray([s.p_bb for s in scen], np.float32)
    kw = dict(rounds=rounds, strategies=("lea", "oracle"), capacity=meta[0]["capacity"],
              grace=meta[0]["grace"])
    jargs = (jnp.asarray(keys), jnp.ones((b, lp.n), bool), jnp.asarray(p_gg),
             jnp.asarray(p_bb), scen[0].mu_g, scen[0].mu_b, scen[0].deadline,
             jserving.RequestSpec(kstar=jnp.full((b,), lp.kstar, jnp.int32),
                                  ell_g=jnp.full((b,), lp.ell_g, jnp.int32),
                                  ell_b=jnp.full((b,), lp.ell_b, jnp.int32),
                                  deadline_rel=jnp.asarray(dl), admit_threshold=jnp.asarray(thr),
                                  reserve_cap=jnp.asarray(cap)),
             jserving.make_process("poisson", rate=jnp.asarray(rates)))
    args = (torch.ones((b, lp.n), dtype=torch.bool), p_gg, p_bb, scen[0].mu_g, scen[0].mu_b,
            scen[0].deadline,
            serving.RequestSpec(kstar=lp.kstar, ell_g=lp.ell_g, ell_b=lp.ell_b,
                                deadline_rel=torch.from_numpy(dl),
                                admit_threshold=torch.from_numpy(thr),
                                reserve_cap=torch.from_numpy(cap)),
            serving.make_process("poisson", rate=torch.from_numpy(rates)))
    return keys, jargs, args, kw


@pytest.mark.parametrize("controlled", [False, True])
def test_serving_telemetry_matches_jax(controlled):
    keys, jargs, args, kw = _arrival_grid(64, controlled)
    want_out, want = jserving.sweep_serving(*jargs, **kw, telemetry=True)
    got_out, got = serving.sweep_serving(JaxServingDraws(keys, "poisson"), *args, **kw,
                                         telemetry=True, device=CPU)
    assert isinstance(got, serving.ServingTelemetry)
    for field, g, w in zip(serving.ServingOutcomes._fields, got_out, want_out):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)
    for field, g, w in zip(serving.ServingTelemetry._fields, got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == np.asarray(w).shape, field
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)
    assert torch.equal(got.admitted_t + got.rejected_t,
                       got.arrivals_t[:, None, :].expand_as(got.admitted_t))
    assert int(got.occupancy.max()) <= kw["capacity"]
    assert torch.equal(got.occupancy[..., -1], got_out.in_flight)


def test_serving_tap_events_match_jax_and_flags_leave_outcomes_alone():
    keys, jargs, args, kw = _arrival_grid(64, True)
    with jobs.capture_taps() as want:
        jserving.sweep_serving(*jargs, **kw, tap=True, tap_stride=16)
    off = serving.sweep_serving(JaxServingDraws(keys, "poisson"), *args, **kw, device=CPU)
    with obs.capture_taps() as got:
        on, _ = serving.sweep_serving(JaxServingDraws(keys, "poisson"), *args, **kw,
                                      telemetry=True, tap=True, tap_stride=16, device=CPU)
    for field, a, b in zip(serving.ServingOutcomes._fields, off, on):
        assert torch.equal(a, b), field
    rows, strategies = keys.shape[0], 2
    assert len(got) == len(want) == 4 * rows * strategies
    _assert_same_events(got, want)
    for e in got[-rows * strategies:]:
        r, s = int(e["row"]), int(e["strategy"])
        assert int(e["admitted_so_far"]) == int(on.admitted[r, s])
        assert int(e["expired_so_far"]) == int(on.expired[r, s])
        assert int(e["occupancy"]) == int(on.in_flight[r, s])


def test_serving_taps_are_delivered_between_loop_segments(monkeypatch):
    """Each boundary's events reach the handlers after its segment of the
    round loop and before the next segment starts (the port's form of the
    JAX package's ``test_serving_tap_streams_during_scan``)."""
    from repro_torch.serving import engine

    log = []
    loop = engine._round_loop

    def logged(tab, mask, n_valid, grace, q, t0, t1):
        log.append(("loop", t0, t1))
        return loop(tab, mask, n_valid, grace, q, t0, t1)

    monkeypatch.setattr(engine, "_round_loop", logged)
    keys, _, args, kw = _arrival_grid(40, True)
    obs.add_tap("test.order", lambda e: log.append(("event", int(e["block"]))))
    try:
        serving.sweep_serving(JaxServingDraws(keys, "poisson"), *args[:1], *args[1:],
                              **{**kw, "rounds": 40}, tap=True, tap_stride=10, device=CPU)
    finally:
        obs.remove_tap("test.order")
    per_block = keys.shape[0] * 2
    expect = []
    for bi, t0 in enumerate(range(0, 40, 10)):
        expect += [("loop", t0, t0 + 10)] + [("event", bi)] * per_block
    assert log == expect


def test_simulate_serving_flags_and_row_labels():
    n = 15
    args = (torch.ones(n, dtype=torch.bool), [0.8] * n, [0.7] * n, 10.0, 3.0, 1.0,
            serving.RequestSpec(kstar=50, ell_g=10, ell_b=3, deadline_rel=1,
                                admit_threshold=0.5, reserve_cap=1.0),
            serving.make_process("poisson", rate=1.2))
    off = serving.simulate_serving(5, *args, rounds=30, strategies=("lea", "oracle"), device=CPU)
    with obs.capture_taps() as events:
        on, tel = serving.simulate_serving(5, *args, rounds=30, strategies=("lea", "oracle"),
                                           telemetry=True, tap=True, tap_stride=7, device=CPU)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert tel.arrivals_t.shape == (30,) and tel.occupancy.shape == (2, 30)
    assert {int(e["row"]) for e in events} == {-1}
    assert [int(e["rounds_done"]) for e in events][::2] == [7, 14, 21, 28, 30]


# ---------------------------------------------------------------------------
# exporters on equal frames
# ---------------------------------------------------------------------------

def _frames():
    rng = np.random.default_rng(0)
    m = 12
    tel = (rng.uniform(0, 1, (m, 2)).astype(np.float32), rng.integers(1, 9, (m, 2), np.int32),
           rng.integers(0, 99, (m, 3), np.int32), rng.integers(0, 99, (m, 3), np.int32),
           rng.random((m, 3)) < 0.8)
    fault = (rng.integers(0, 4, m, np.int32), rng.integers(0, 30, m, np.int32),
             rng.integers(0, 99, (m, 2), np.int32), rng.integers(0, 99, (m, 2), np.int32))
    srv = (rng.integers(0, 3, m, np.int32), rng.integers(0, 4, (2, m), np.int32),
           rng.integers(0, 3, (2, m), np.int32), rng.integers(0, 2, (2, m), np.int32))
    return [("TelemetryFrame", tel, dict(strategies=("lea", "static", "oracle"),
                                         alloc_strategies=("lea", "oracle"))),
            ("FaultTelemetry", fault, dict(strategies=("lea", "static"))),
            ("ServingTelemetry", srv, dict(strategies=("lea", "oracle")))]


@pytest.mark.parametrize("kind", ["TelemetryFrame", "FaultTelemetry", "ServingTelemetry"])
def test_metric_streams_and_table_match_jax(kind):
    name, leaves, names = next(f for f in _frames() if f[0] == kind)
    got_frame = getattr(obs, name)(*(torch.from_numpy(x) for x in leaves))
    want_frame = getattr(jobs, name)(*(jnp.asarray(x) for x in leaves))
    got = obs.metric_streams(got_frame, **names)
    want = jobs.metric_streams(want_frame, **names)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert obs.metric_table(got_frame, **names) == jobs.metric_table(want_frame, **names)


def test_serving_trace_matches_jax(tmp_path):
    keys, jargs, args, kw = _arrival_grid(32, True)
    want_out, want_tel = jserving.sweep_serving(*jargs, **kw, telemetry=True)
    got_out, got_tel = serving.sweep_serving(JaxServingDraws(keys, "poisson"), *args, **kw,
                                             telemetry=True, device=CPU)
    row = 3
    got = obs.serving_trace(got_out.events[row], got_out.sojourn[row],
                            strategies=("lea", "oracle"),
                            telemetry=obs.ServingTelemetry(*(x[row] for x in got_tel)))
    want = jobs.serving_trace(np.asarray(want_out.events)[row],
                              np.asarray(want_out.sojourn)[row], strategies=("lea", "oracle"),
                              telemetry=jobs.ServingTelemetry(
                                  *(np.asarray(x)[row] for x in want_tel)))
    assert got == want
    counts = obs.validate_trace(got)
    assert counts["dispositions"].get("on_time", 0) == int(got_out.served_on_time[row].sum())
    obs.write_trace(tmp_path / "t.json", got)
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(json.dumps(want))


def test_exporters_reject_batched_frames_and_event_names_mirror_the_engine():
    frame = obs.TelemetryFrame(*(torch.zeros((2, 4, 2)) for _ in range(5)))
    with pytest.raises(ValueError, match="select a batch row"):
        obs.metric_streams(frame)
    from repro_torch.obs.telemetry import _EVENT_NAMES
    assert _EVENT_NAMES == {serving.EVENT_ON_TIME: "on_time", serving.EVENT_LATE: "late",
                            serving.EVENT_EXPIRED: "expired"}


# ---------------------------------------------------------------------------
# taps: the host side
# ---------------------------------------------------------------------------

def test_tap_catalogue_and_stride_helpers_are_the_jax_packages():
    assert obs.EVENT_STREAMS == jobs.EVENT_STREAMS
    assert obs.TAP_ENGINES == jobs.TAP_ENGINES
    for rounds, stride in [(48, None), (48, 16), (8, 100), (48, 20), (256, 64)]:
        assert taps.resolve_stride(rounds, stride) == jobs.taps.resolve_stride(rounds, stride)
        s = taps.resolve_stride(rounds, stride)
        assert taps.stride_boundaries(rounds, s) == jobs.taps.stride_boundaries(rounds, s)
    with pytest.raises(ValueError):
        taps.resolve_stride(48, 0)


def test_a_raising_handler_is_dropped_from_the_event_not_the_run():
    def broken(event):
        raise RuntimeError("sink down")

    obs.add_tap("test.broken", broken)
    try:
        with obs.capture_taps() as events:
            taps.emit_rows("engine.pool", block=np.zeros(2, np.int32),
                           row=np.arange(2, dtype=np.int32),
                           rounds_done=np.full(2, 4, np.int32),
                           succ_so_far=np.ones((2, 3), np.int32),
                           throughput_so_far=np.full((2, 3), 0.25, np.float32),
                           est_err_so_far=np.zeros((2, 2), np.float32))
    finally:
        obs.remove_tap("test.broken")
    assert [int(e["row"]) for e in events] == [0, 1]
    for e in events:
        obs.validate_event(e)
        assert e["succ_so_far"].shape == (3,) and e["rounds_done"].dtype == np.int32
    assert "test.broken" not in obs.tap_names()
    with pytest.raises(TypeError):
        obs.add_tap("test.bad", object())
    with pytest.raises(ValueError, match="streams mismatch"):
        obs.validate_event({"engine": "serving", "block": 0, "row": 0, "host_time": 0.0})


def test_to_host_round_trips_int_float_and_bool_in_one_copy():
    a = torch.arange(6, dtype=torch.int32).reshape(2, 3) - 3
    b = torch.tensor([[0.5, -1e-30], [3.25, float("inf")]], dtype=torch.float32)
    c = torch.tensor([True, False, True])
    ga, gb, gc = taps.to_host(a, b, c)
    np.testing.assert_array_equal(ga, a.numpy())
    assert gb.dtype == np.float32 and np.array_equal(gb.view(np.int32), b.numpy().view(np.int32))
    assert gc.dtype == bool and gc.tolist() == [True, False, True]
    with pytest.raises(TypeError):
        taps.to_host(torch.zeros(2, dtype=torch.int64))


# ---------------------------------------------------------------------------
# metrics and history: the copies behave as the JAX package's modules
# ---------------------------------------------------------------------------

PACKAGES = {"repro": (jmetrics, jhistory), "repro_torch": (metrics, history)}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_metrics_naming_and_update_semantics(pkg):
    m = PACKAGES[pkg][0]
    assert m.valid_name("tap.engine_pool.events")
    assert not m.valid_name("noseparator") and not m.valid_name("Upper.case")
    reg = m.MetricsRegistry()
    assert reg.counter("a.count") == 1.0 and reg.counter("a.count", 2.5) == 3.5
    with pytest.raises(ValueError):
        reg.counter("a.count", -1.0)
    reg.gauge("a.level", 7.0)
    assert reg.gauge("a.level", 3.0) == 3.0
    for v in (1.0, 5.0, 3.0):
        reg.histogram("a.lat", v)
    assert reg.get("a.lat") == {"kind": "histogram", "count": 3, "sum": 9.0, "min": 1.0,
                                "max": 5.0}
    with pytest.raises(ValueError):
        reg.gauge("a.count", 1.0)
    with pytest.raises(ValueError):
        reg.counter("bad name")
    text = reg.exposition()
    assert "# TYPE a_count counter" in text and "a_lat_count 3" in text
    assert text.endswith("\n")


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_metrics_sinks_and_attribution(pkg, tmp_path):
    m = PACKAGES[pkg][0]
    sink = m.JsonlSink(str(tmp_path / "e.jsonl"))
    sink({"engine": "serving", "rounds_done": np.int32(8), "vec": np.arange(2)})
    sink({"bad": float("nan")})
    assert (sink.written, sink.errors) == (1, 1)
    assert json.loads((tmp_path / "e.jsonl").read_text()) == {
        "engine": "serving", "rounds_done": 8, "vec": [0, 1]}
    buf = io.StringIO()
    line = m.ProgressLine(total=100, stream=buf, min_interval=0.0, label="t")
    for r in range(2):
        for blk in range(4):
            line({"row": r, "block": blk, "rounds_done": (blk + 1) * 25})
    line.close()
    assert line.rounds_done == 100 and "100/100" in buf.getvalue()
    reg = m.MetricsRegistry()
    handler = m.tap_to_registry(reg)
    handler({"engine": "engine.pool", "block": 0, "row": 0, "rounds_done": 16,
             "host_time": 1.0})
    handler({"engine": "engine.pool", "block": 1, "row": 0, "rounds_done": 32,
             "host_time": 1.5})
    assert reg.get("tap.engine_pool.rounds_done")["value"] == 32.0
    assert reg.get("tap.engine_pool.block_seconds")["count"] == 1
    with m.timed("phase.demo", reg):
        pass
    assert reg.get("phase.demo.seconds")["count"] == 1
    m.record_compile("sweeps.run_group", 0, 1.0, reg)
    assert "compile.sweeps_run_group.events" not in reg.names()
    m.record_compile("sweeps.run_group", 2, 1.0, reg)
    assert reg.get("compile.sweeps_run_group.events")["value"] == 2.0


def _record(h, bench="sweep_smoke", **values):
    return {"schema": h.SCHEMA_VERSION, "bench": bench, "manifest": f"BENCH_{bench}.json",
            "written_at": 0.0, "provenance": {k: None for k in h._PROV_KEYS},
            "metrics": values, "warnings": 0}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_history_append_read_and_env_override(pkg, tmp_path, monkeypatch):
    h = PACKAGES[pkg][1]
    assert (h.HISTORY_ENV, h.HISTORY_BASENAME) == ("REPRO_BENCH_HISTORY",
                                                    "BENCH_history.jsonl")
    monkeypatch.delenv(h.HISTORY_ENV, raising=False)
    assert h.history_path(tmp_path / "BENCH_x.json") == str(tmp_path / "BENCH_history.jsonl")
    monkeypatch.setenv(h.HISTORY_ENV, "/elsewhere/h.jsonl")
    assert h.history_path(tmp_path / "BENCH_x.json") == "/elsewhere/h.jsonl"
    path = tmp_path / "h.jsonl"
    assert h.append_record(path, _record(h, rows_per_sec=100.0))
    with open(path, "a") as f:
        f.write("{torn line\n\n")
    assert h.append_record(path, _record(h, rows_per_sec=101.0))
    got = h.read_history(path)
    assert len(got) == 2 and all(h.valid_record(r) for r in got)
    assert h.read_history(tmp_path / "missing.jsonl") == []
    assert not h.append_record(tmp_path / "no" / "dir" / "h.jsonl", _record(h))
    assert not h.append_record(path, _record(h, x=float("nan")))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_history_trend_report(pkg):
    h = PACKAGES[pkg][1]
    assert h.metric_direction("rows_per_sec") == "higher"
    assert h.metric_direction("run_s") == "lower" and h.metric_direction("trace_events") is None
    slow = [_record(h, rows_per_sec=v) for v in [100.0, 101.0, 99.0, 100.5, 100.0, 40.0, 39.0]]
    hard = h.hard_regressions(h.trend_report(slow))
    assert len(hard) == 1 and hard[0]["value"] == pytest.approx(39.5)
    noisy = [_record(h, rows_per_sec=v) for v in [100, 98, 103, 101, 99, 100, 75]]
    assert h.hard_regressions(h.trend_report(noisy)) == []
    up = [_record(h, run_s=1.0) for _ in range(5)] + [_record(h, run_s=0.4),
                                                      _record(h, run_s=0.41)]
    report = h.trend_report(up)
    assert h.hard_regressions(report) == [] and len(report["regressions"]) == 1
    with pytest.raises(ValueError):
        h.trend_report([], recent=0)


def test_port_history_record_differs_from_the_jax_one_only_in_the_framework_key():
    assert set(history._PROV_KEYS) ^ set(jhistory._PROV_KEYS) == {"torch", "jax"}
    assert history.RECORD_KEYS == jhistory.RECORD_KEYS


# ---------------------------------------------------------------------------
# provenance and manifests
# ---------------------------------------------------------------------------

def test_provenance_schema():
    doc = obs.provenance(1234.5, device=CPU)
    assert has_required_fields(doc)
    assert set(doc) == {"git_sha", "git_dirty", "torch", "cuda", "backend", "device",
                        "power_limit_w", "python", "platform", "timestamp"}
    assert doc["timestamp"] == 1234.5 and doc["torch"] == torch.__version__
    assert (doc["backend"], doc["device"], doc["power_limit_w"]) == ("cpu", "cpu", None)
    head = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                          cwd=ROOT, timeout=30).stdout.strip()
    assert doc["git_sha"] == head and isinstance(doc["git_dirty"], bool)
    assert "jax" not in doc and "jaxlib" not in doc
    json.dumps(doc, allow_nan=False)
    assert not has_required_fields({k: v for k, v in doc.items() if k != "power_limit_w"})


def test_provenance_never_raises(tmp_path, monkeypatch):
    prov = sys.modules["repro_torch.obs.provenance"]
    doc = obs.provenance(0.0, root=str(tmp_path), device=CPU)
    assert doc["git_sha"] is None and doc["git_dirty"] is None and has_required_fields(doc)
    monkeypatch.setenv("PATH", str(tmp_path))      # no nvidia-smi, no git
    assert prov.power_limit_w() is None
    assert has_required_fields(obs.provenance(0.0, device="not a device"))


def test_power_limit_is_read_from_nvidia_smi(monkeypatch):
    prov = sys.modules["repro_torch.obs.provenance"]
    monkeypatch.setattr(prov, "_run", lambda args, cwd=None:
                        "NVIDIA H100 80GB HBM3, 700.00 W" if args[0] == "nvidia-smi" else None)
    assert prov.power_limit_w() == 700.0
    monkeypatch.setattr(prov, "_run", lambda args, cwd=None: "NVIDIA H100, [N/A]")
    assert prov.power_limit_w() is None


def test_manifest_write_and_history_record_round_trip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    hist = tmp_path / "elsewhere" / "history.jsonl"
    hist.parent.mkdir()
    monkeypatch.setenv("REPRO_BENCH_HISTORY", str(hist))
    results = sweeps.run("fig3", rounds=64, device=CPU)
    doc = sweeps.manifest(results, bench="port_demo", timestamp=99.0, device=CPU,
                          extra={"rows_per_sec": 123.0})
    assert doc["provenance"]["timestamp"] == 99.0 and doc["warnings"] == []
    assert has_required_fields(doc["provenance"]) and len(doc["results"]) == 4
    out = tmp_path / "out" / "BENCH_port_demo.json"
    out.parent.mkdir()
    sweeps.write_manifest(out, doc)
    assert json.loads(out.read_text()) == json.loads(json.dumps(doc))
    rec, = history.read_history(hist)
    assert history.valid_record(rec) and rec["bench"] == "port_demo"
    assert rec["metrics"] == {"scenarios": 4.0, "rows_per_sec": 123.0}
    assert rec["provenance"]["torch"] == torch.__version__
    assert sorted(p.name for p in tmp_path.iterdir()) == ["elsewhere", "out"]
    # a hand-assembled document gets the stamps; an existing one is kept
    sweeps.write_manifest(out, {"bench": "x", "provenance": {"timestamp": 7.0}})
    assert json.loads(out.read_text())["provenance"] == {"timestamp": 7.0}
    assert len(history.read_history(hist)) == 2


# ---------------------------------------------------------------------------
# profiling: phase spans and the REPRO_PROFILE gate
# ---------------------------------------------------------------------------

def test_phase_gating_without_a_trace(monkeypatch):
    monkeypatch.delenv(obs.PROFILE_ENV, raising=False)
    assert obs.profile_dir() is None
    with obs.profile_trace("t") as out:
        assert out is None
        with obs.phase("allocate", CPU):
            x = torch.arange(3) * 2
    assert x.tolist() == [0, 2, 4]


def test_profile_trace_holds_the_engine_phase_spans(tmp_path, monkeypatch):
    monkeypatch.setenv(obs.PROFILE_ENV, str(tmp_path))
    spec = lagrange.CodeSpec(6, 2, 3, 1)
    rng = np.random.default_rng(0)
    coded = coded_ops.encode_dataset(spec, torch.from_numpy(
        rng.standard_normal((spec.k, 4, 5)).astype(np.float32)))
    _, _, _, args, geometry = _grid(32)
    with obs.profile_trace("phases") as out:
        assert out == str(tmp_path)
        sweeps.run("fig3", rounds=32, device=CPU)
        faults.sweep_faults(7, *args, **geometry, device=CPU)
        coded_ops.coded_matmul_device(coded, torch.ones(5, 1), torch.ones(spec.nr, dtype=bool))
    trace, = tmp_path.glob("phases.*.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "phases" in names
    assert {n for n in names if n.startswith("repro.")} == {
        f"repro.{name}" for name in ENGINE_PHASES}


class _CountingDraws:
    """A draw source that counts the static resampler's draws."""

    def __init__(self, seed):
        self.inner, self.static_calls = as_draws(seed, CPU), 0

    def initial(self, *a):
        return self.inner.initial(*a)

    def steps(self, *a):
        return self.inner.steps(*a)

    def static(self, *a):
        self.static_calls += 1
        return self.inner.static(*a)

    def single(self, *a):
        return self.inner.single(*a)


@pytest.mark.parametrize("round_chunk", [None, 40])
def test_static_wait_spans_count_the_resamplers_host_reads(round_chunk):
    """One ``repro.static_wait`` a try that draws, and one more a block for
    the read that ends it (no round reaches the 128-try cap here)."""
    group, = sweeps.build_groups(sweeps.expand("fig3", rounds=100), seeds=2)
    draws = _CountingDraws(3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sweeps.run_group(group, round_chunk=round_chunk, draws=draws, device=CPU)
    calls = {e.key: e.count for e in prof.key_averages()}
    blocks = 1 if round_chunk is None else -(-100 // round_chunk)
    assert 0 < draws.static_calls < blocks * throughput.STATIC_MAX_TRIES
    assert calls["repro.static_wait"] == draws.static_calls + blocks
    assert calls["repro.static_loads"] == calls["repro.score"] == blocks


def test_profile_trace_stops_and_writes_when_the_body_raises(tmp_path, monkeypatch):
    monkeypatch.setenv(obs.PROFILE_ENV, str(tmp_path / "new"))
    with pytest.raises(RuntimeError, match="boom"):
        with obs.profile_trace("crash"):
            torch.arange(4).sum()
            raise RuntimeError("boom")
    assert len(list((tmp_path / "new").glob("crash.*.trace.json"))) == 1
    with obs.profile_trace("after"):       # a second trace starts cleanly
        pass
    assert len(list((tmp_path / "new").glob("after.*.trace.json"))) == 1


# ---------------------------------------------------------------------------
# counters: kernel builds, persistent-cache hits, launches
# ---------------------------------------------------------------------------

def test_counter_registry_and_the_three_aliases(monkeypatch):
    from repro_torch.kernels import build
    names = obs.counter_names()
    assert {f"build.{s}" for s in build.sources()} <= set(names)
    assert names == tuple(sorted(names))
    monkeypatch.setattr(build, "_BUILDS", {})
    assert obs.compile_events() == 0 and counters.persistent_cache_hits() == 0
    for alias in (sweeps.compile_cache_size, faults.fault_compile_cache_size,
                  serving.serving_compile_cache_size):
        assert alias() == obs.compile_events("build.poisson_binomial") == 0
    # an nvcc run in this process is a compile event; a library found built
    # is a persistent-cache hit
    build._BUILDS["poisson_binomial"] = build.BuildResult("poisson_binomial", Path("x"), 3.5, "")
    build._BUILDS["gf_matmul"] = build.BuildResult("gf_matmul", Path("y"), 0.0, "")
    assert obs.compile_events() == 1 and counters.persistent_cache_hits() == 1
    for alias in (sweeps.compile_cache_size, faults.fault_compile_cache_size,
                  serving.serving_compile_cache_size):
        assert alias() == 1
    with pytest.raises(KeyError):
        obs.compile_events("no.such.counter")
    with pytest.raises(TypeError):
        obs.register_compiled("bad.hook", object())


def test_launch_counts_cover_every_kernel_module():
    from repro_torch.kernels.coded_gradient import kernel as cg
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.gf import kernel as gfk
    from repro_torch.kernels.lagrange_encode import kernel as le
    from repro_torch.kernels.packet_counts import kernel as pc
    from repro_torch.kernels.poisson_binomial import kernel as pb
    from repro_torch.kernels.static_resample import kernel as sr
    mods = (cg, fa, gfk, le, pc, pb, sr)
    want = {}
    for mod in mods:
        want.update(mod.launch_counts())
    assert set(counters.launch_counts()) == set(want) == {
        "coded_gradient_cuda", "flash_attention_cuda", "matmul_gf_cuda", "bmm_gf_cuda",
        "encode_matrix_cuda", "success_tails_cuda", "success_tails_cuda_w",
        "allocate_masked_cuda", "static_resample_cuda", "packet_counts_cuda"}
    pb._LAUNCHES["success_tails_cuda_w"] += 3
    assert counters.launch_counts()["success_tails_cuda_w"] == pb.launch_counts()[
        "success_tails_cuda_w"]
    counters.reset_launch_counts()
    assert not any(counters.launch_counts().values())
    # the CPU runs the plain versions: a CPU sweep launches no kernel
    sweeps.run("fig3", rounds=16, device=CPU)
    assert not any(counters.launch_counts().values())


def test_run_group_attributes_its_wall_clock():
    group, = sweeps.build_groups(sweeps.expand("fig3", rounds=16), seeds=1)
    name = "phase.sweeps_run_group.seconds"
    before = obs.default_metrics.get(name)["count"] if name in obs.default_metrics.names() else 0
    sweeps.run_group(group, device=CPU)
    assert obs.default_metrics.get(name)["count"] == before + 1


# ---------------------------------------------------------------------------
# the serving CLI's flags
# ---------------------------------------------------------------------------

def test_serve_cli_progress_and_tap_log(tmp_path, capsys):
    log = tmp_path / "taps.jsonl"
    plain = serve.main(["--smoke", "--device", "cpu"], echo=lambda line: None)
    got = serve.main(["--smoke", "--device", "cpu", "--progress", "--tap-log", str(log)],
                     echo=lambda line: None)
    assert got == plain
    events = [json.loads(line) for line in log.read_text().splitlines()]
    assert [e["rounds_done"] for e in events] == [8 * (i + 1) for i in range(8)]
    for e in events:
        obs.validate_event(e)
    assert events[-1]["admitted_so_far"] == got["lea"]["admitted"]
    err = capsys.readouterr().err
    assert "[serve]" in err and "64/64" in err
    strided = tmp_path / "strided.jsonl"
    serve.main(["--smoke", "--device", "cpu", "--tap-stride", "20", "--tap-log", str(strided)],
               echo=lambda line: None)
    assert [json.loads(x)["rounds_done"] for x in strided.read_text().splitlines()] == [
        20, 40, 60, 64]


def test_sweeps_run_threads_tap_through():
    with obs.capture_taps() as events:
        res_on = sweeps.run("deadline_sweep", rounds=64, tap=True, tap_stride=32, device=CPU)
    res_off = sweeps.run("deadline_sweep", rounds=64, device=CPU)
    assert [r.throughput for r in res_on] == [r.throughput for r in res_off]
    assert events and all(int(e["row"]) >= 0 for e in events)
    for e in events:
        obs.validate_event(e)


# ---------------------------------------------------------------------------
# the port imports neither JAX nor the JAX package
# ---------------------------------------------------------------------------

def test_observability_modules_import_without_jax_or_repro():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.obs, repro_torch.sweeps, repro_torch.faults\n"
        "import repro_torch.serving, repro_torch.launch.serve\n"
        "import repro_torch.core.coded_ops\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')"
        " and sys.modules[m] is not None))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
