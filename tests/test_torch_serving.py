"""Parity of the port's streaming serving slice (``repro_torch.serving``,
``lea.allocate_queue``, ``throughput.serve_rollout``, the ``arrival_grid``
family, ``launch.serve`` and the ``serve_coded`` example) with the JAX
package, on the CPU.

:class:`JaxServingDraws` extends the fault replay (``JaxFaultDraws``) with
the variates ``repro.serving`` draws for its arrivals from
``fold_in(key, arrival tag)``: Poisson counts and Exp(1) gaps on that key,
and for ``mmpp`` its ``split`` into a chain key (the calm/burst chain's
per-step uniforms, ``sample_trajectory_from``'s draws) and a counts key.
On those draws every ``ServingOutcomes`` field of the port equals
``repro``'s exactly: the outputs are integers, so the tolerance is
equality, and a flipped allocation tie would show as a differing round
(counted and required to be zero).
"""

import functools
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro import serving as jserving
from repro import sweeps as jsweeps
from repro.core import lea as jlea
from repro.core import throughput as jtp
from repro.launch import serve as jserve
from repro.serving import queue as jqueue
from repro.serving.arrivals import _ARRIVAL_KEY_TAG
from repro_torch import faults, serving, sweeps
from repro_torch.core import lea, throughput
from repro_torch.core.lea import PoolLoad
from repro_torch.examples import serve_coded
from repro_torch.launch import serve
from repro_torch.random import (ARRIVAL_TAG, ArrivalDraws, RecordedDraws, ReplayedDraws,
                                torch_draws)
from repro_torch.serving import arrivals
from test_torch_engine import JaxDraws, _split_rows, _uniforms
from test_torch_faults import JaxFaultDraws, _as_keys, _fold, _split2

CPU = "cpu"
N = 15
MU_G, MU_B, D = 10.0, 3.0, 1.0
KS, EG, EB = 50, 10, 3
ROOT = Path(__file__).resolve().parents[1]

_poisson = jax.jit(jax.vmap(lambda k, lam: jax.random.poisson(k, lam, lam.shape)))


@functools.lru_cache(maxsize=None)
def _exponential(count):
    return jax.jit(jax.vmap(lambda k: jax.random.exponential(k, (count,))))


class JaxServingDraws(JaxFaultDraws):
    """``JaxFaultDraws`` that also replays ``repro.serving``'s arrival
    variates on ``keys`` for a process named ``process``."""

    def __init__(self, keys, process=None, channel=(), **kw):
        super().__init__(keys, channel, **kw)
        root = _fold(_as_keys(keys), _ARRIVAL_KEY_TAG)
        if process == "mmpp":
            halves = _split2(root)
            self.k_chain, self.k_counts = halves[:, 0], halves[:, 1]
        else:
            self.k_chain, self.k_counts = None, root

    def poisson(self, rate):
        lam = jnp.asarray(rate.cpu().numpy())
        return torch.from_numpy(np.array(_poisson(self.k_counts, lam))).to(torch.int32)

    def exponential(self, rows, count):
        return self._t(_exponential(count)(self.k_counts))

    def chain(self, rows, rounds):
        return self._t(_uniforms(1, 2)(_split_rows(rounds - 1)(self.k_chain)))


def _keys(b, base=0):
    return np.array(jax.vmap(lambda i: jax.random.PRNGKey(base + i))(jnp.arange(b)))


def _compare(got, want, what=""):
    """Every ServingOutcomes field equal; differing (row, strategy, round)
    triples counted, which would show a flipped allocation tie."""
    want = [np.asarray(x) for x in want]
    ev_got, ev_want = got.events.numpy(), want[-2]
    flips = int((ev_got != ev_want).any(axis=-1).sum())
    assert flips == 0, f"{what}: {flips} rounds differ from JAX's"
    for field, g, w in zip(serving.ServingOutcomes._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what} {field}")


PROCESSES = {
    "constant": {"per_round": [1, 2, 0, 1]},
    "poisson": {"rate": [0.5, 1.5, 3.0, 2.4]},
    "shift_exp": {"t_const": [0.2, 0.1, 0.0, 0.3], "mean": [0.8, 0.5, 0.3, 0.4]},
    "mmpp": {"rate_lo": [0.3, 0.5, 1.0, 0.2], "rate_hi": [3.0, 2.5, 4.0, 3.5],
             "p_stay_lo": [0.9, 0.8, 0.95, 0.7], "p_stay_hi": [0.7, 0.6, 0.5, 0.8]},
}


def _processes(name, rows=4):
    params = {k: np.float32(v[:rows]) for k, v in PROCESSES[name].items()}
    return (jserving.make_process(name, **{k: jnp.asarray(v) for k, v in params.items()}),
            serving.make_process(name, **{k: torch.from_numpy(v) for k, v in params.items()}))


# ---------------------------------------------------------------------------
# arrivals and draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PROCESSES))
@pytest.mark.parametrize("rounds", [1, 37, 300])
def test_arrival_counts_match_jax(name, rounds):
    keys = _keys(4, 10 * rounds)
    jproc, proc = _processes(name)
    want = jax.vmap(lambda k, p: jserving.sample_arrivals(k, p, rounds))(
        jnp.asarray(keys), jproc)
    draws = object() if name == "constant" else JaxServingDraws(keys, name)
    got = arrivals.sample_arrivals(draws, proc, 4, rounds, device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scalar_parameters_match_one_jax_row():
    key = jax.random.PRNGKey(4)
    for name, params in (("poisson", {"rate": 1.3}), ("shift_exp", {"t_const": 0.2, "mean": 0.8}),
                         ("mmpp", {"rate_lo": 0.3, "rate_hi": 3.0})):
        want = jserving.sample_arrivals(key, jserving.make_process(name, **params), 200)
        got = arrivals.sample_arrivals(JaxServingDraws(np.array(key)[None], name),
                                       serving.make_process(name, **params), 1, 200, device=CPU)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want), err_msg=name)


def test_dense_shift_exp_binning_at_2000_rounds_matches_jax():
    """A stream of 8 x 2 000 events: the event times' summation order
    decides the round of events near a boundary (a plain float cumsum bins
    a few of them differently here)."""
    keys = _keys(8, 77)
    params = {"t_const": np.zeros(8, np.float32), "mean": np.full(8, 0.3, np.float32)}
    want = jax.vmap(lambda k, p: jserving.sample_arrivals(k, p, 2000))(
        jnp.asarray(keys), jserving.make_process("shift_exp", **params))
    got = arrivals.sample_arrivals(JaxServingDraws(keys, "shift_exp"),
                                   serving.make_process("shift_exp", **params), 8, 2000,
                                   device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("length", [1, 16, 17, 100, 257, 4096, 16000])
def test_blocked_cumsum_is_jax_cumsum_to_the_bit(length):
    rng = np.random.default_rng(length)
    x = (0.2 + 0.8 * rng.exponential(size=(3, length))).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=-1))(jnp.asarray(x)))
    got = arrivals._blocked_cumsum(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_registry_matches_jax_and_rejects_unknown_names():
    assert serving.process_names() == jserving.process_names()
    with pytest.raises(KeyError, match="unknown arrival process"):
        serving.make_process("nope")
    assert ARRIVAL_TAG == _ARRIVAL_KEY_TAG


def test_arrival_draws_are_checked_where_taken_and_leave_engine_draws_alone():
    engine_only = JaxDraws(_keys(1))
    assert not isinstance(engine_only, ArrivalDraws)
    with pytest.raises(TypeError, match="ArrivalDraws"):
        arrivals.sample_arrivals(engine_only, serving.make_process("poisson", rate=1.0), 1, 8,
                                 device=CPU)
    mask = torch.ones((1, N), dtype=torch.bool)
    chain = (np.full((1, N), 0.8, np.float32), np.full((1, N), 0.7, np.float32))
    alone = throughput.serve_rollout(torch_draws(5, CPU), mask, *chain, 50, device=CPU)
    draws = torch_draws(5, CPU)
    for name in ("poisson", "shift_exp", "mmpp"):
        _, proc = _processes(name, 1)
        arrivals.sample_arrivals(draws, proc, 1, 50, device=CPU)
    after = throughput.serve_rollout(draws, mask, *chain, 50, device=CPU)
    assert torch.equal(after[0], alone[0]) and torch.equal(after[1], alone[1])


# ---------------------------------------------------------------------------
# the queue
# ---------------------------------------------------------------------------

def _random_queues(rng, b, q):
    """(b, q) queues with ties on deadline AND arrival, as numpy fields."""
    return dict(
        occupied=rng.random((b, q)) < 0.6,
        kstar=rng.integers(1, 60, (b, q)).astype(np.int32),
        ell_g=rng.integers(1, 11, (b, q)).astype(np.int32),
        ell_b=rng.integers(0, 4, (b, q)).astype(np.int32),
        deadline_abs=rng.integers(3, 6, (b, q)).astype(np.int32),
        arrival=rng.integers(0, 3, (b, q)).astype(np.int32),
    )


def _queues(fields):
    return (jqueue.RequestQueue(**{k: jnp.asarray(v) for k, v in fields.items()}),
            serving.RequestQueue(**{k: torch.from_numpy(v) for k, v in fields.items()}))


@pytest.mark.parametrize("seed", range(4))
def test_admit_edf_order_and_release_match_jax(seed):
    rng = np.random.default_rng(seed)
    b, q = 64, 6
    fields = _random_queues(rng, b, q)
    jq, pq = _queues(fields)
    count = rng.integers(0, 5, b).astype(np.int32)
    spec = [rng.integers(1, 60, b).astype(np.int32), rng.integers(1, 11, b).astype(np.int32),
            rng.integers(0, 4, b).astype(np.int32), rng.integers(0, 4, b).astype(np.int32)]
    t = 2
    jq2, jn = jax.vmap(lambda qq, c, ks, eg, eb, dl: jqueue.admit(qq, t, c, ks, eg, eb, dl))(
        jq, jnp.asarray(count), *map(jnp.asarray, spec))
    pq2, pn = serving.admit(pq, t, torch.from_numpy(count), *map(torch.from_numpy, spec))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    for field in serving.RequestQueue._fields:
        np.testing.assert_array_equal(getattr(pq2, field).numpy(),
                                      np.asarray(getattr(jq2, field)), err_msg=field)
    # EDF with ties on deadline and arrival: before and after admission
    for jqq, pqq in ((jq, pq), (jq2, pq2)):
        np.testing.assert_array_equal(serving.edf_order(pqq).numpy(),
                                      np.asarray(jax.vmap(jqueue.edf_order)(jqq)))
    done = rng.random((b, q)) < 0.4
    jr = jax.vmap(jqueue.release)(jq2, jnp.asarray(done))
    pr = serving.release(pq2, torch.from_numpy(done))
    np.testing.assert_array_equal(pr.occupied.numpy(), np.asarray(jr.occupied))


def test_edf_order_breaks_full_ties_by_slot_index():
    fields = dict(occupied=np.array([[True, False, True, True, True, True]]),
                  kstar=np.full((1, 6), 5, np.int32), ell_g=np.full((1, 6), 2, np.int32),
                  ell_b=np.ones((1, 6), np.int32),
                  deadline_abs=np.array([[4, 1, 4, 3, 4, 3]], np.int32),
                  arrival=np.array([[1, 0, 1, 2, 0, 2]], np.int32))
    jq, pq = _queues(fields)
    got = serving.edf_order(pq)[0].tolist()
    assert got == np.asarray(jax.vmap(jqueue.edf_order)(jq))[0].tolist()
    assert got == [3, 5, 4, 0, 2, 1]


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padded", [False, True])
def test_predicted_success_matches_jax(padded):
    rng = np.random.default_rng(int(padded))
    b, a, m = 3, 2, 40
    p = rng.uniform(0, 1, (a, b, m, N)).astype(np.float32)
    p[..., :3] = 0.5                                    # ties
    mask = np.ones((b, N), bool)
    if padded:
        mask[1, 11:] = False
        mask[2, ::4] = False
    ks = np.array([50, 30, 20], np.int32)
    eg, eb = np.array([10, 8, 6], np.int32), np.array([3, 2, 1], np.int32)
    want = jax.vmap(lambda pp, mm, k, g, e: jserving.predicted_success(pp, mm, k, g, e),
                    in_axes=(1, 0, 0, 0, 0), out_axes=1)(
        jnp.asarray(p), jnp.asarray(mask), jnp.asarray(ks), jnp.asarray(eg), jnp.asarray(eb))
    got = serving.predicted_success(torch.from_numpy(p), torch.from_numpy(mask)[:, None, :],
                                    torch.from_numpy(ks)[:, None], torch.from_numpy(eg)[:, None],
                                    torch.from_numpy(eb)[:, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_minimal_demand_and_admission_room_match_jax():
    rng = np.random.default_rng(7)
    occ = rng.random((50, 6)) < 0.5
    ks = rng.integers(-3, 99, (50, 6)).astype(np.int32)
    eg = rng.integers(0, 11, (50, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        serving.minimal_demand(torch.from_numpy(occ), torch.from_numpy(ks),
                               torch.from_numpy(eg)).numpy(),
        np.asarray(jserving.minimal_demand(jnp.asarray(occ), jnp.asarray(ks), jnp.asarray(eg))))
    m_active = rng.integers(0, 20, 50).astype(np.int32)
    m_new = rng.integers(0, 8, 50).astype(np.int32)
    for cap in (0.7, 1.0, 0.33, 1.7, jserving.ADMIT_ALL_CAP):
        for n_valid in (15, 13, 10, 20, 1):
            want = jserving.admission_room(jnp.asarray(m_active), jnp.asarray(m_new),
                                           jnp.int32(n_valid), cap)
            got = serving.admission_room(torch.from_numpy(m_active), torch.from_numpy(m_new),
                                         torch.tensor(n_valid), cap)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{cap}")
    # the float32 budget: 0.7f * 10 rounds to 7.0 in float32 (a float64
    # product, 6.99999988, would floor to 6)
    assert int(serving.admission_budget(torch.tensor(10), 0.7)) == 7
    assert int(serving.admission_budget(torch.tensor(15), 0.7)) == 10


# ---------------------------------------------------------------------------
# allocate_queue
# ---------------------------------------------------------------------------

def _jax_allocate_queue(p, pool_mask, fields, order):
    return jax.vmap(lambda pp, mm, act, ks, eg, eb, od: jlea.allocate_queue(
        pp, mm, act, ks, eg, eb, od))(
        jnp.asarray(p), jnp.asarray(pool_mask), jnp.asarray(fields["occupied"]),
        jnp.asarray(fields["kstar"]), jnp.asarray(fields["ell_g"]),
        jnp.asarray(fields["ell_b"]), jnp.asarray(order))


@pytest.mark.parametrize("seed", range(3))
def test_allocate_queue_matches_jax_exactly(seed):
    """Random queues, including oversubscribed ones (summed minimal demand
    above the pool) and padded pools."""
    rng = np.random.default_rng(seed)
    b, q = 96, 6
    fields = _random_queues(rng, b, q)
    fields["kstar"] = rng.integers(1, 70, (b, q)).astype(np.int32)
    fields["ell_g"] = rng.integers(4, 11, (b, q)).astype(np.int32)
    p = rng.uniform(0, 1, (b, N)).astype(np.float32)
    p[:, 5:9] = 0.5
    pool_mask = rng.random((b, N)) < 0.9
    _, pq = _queues(fields)
    order = serving.edf_order(pq)
    want = _jax_allocate_queue(p, pool_mask, fields, order.numpy())
    got = lea.allocate_queue(torch.from_numpy(p), torch.from_numpy(pool_mask), pq.occupied,
                             pq.kstar, pq.ell_g, pq.ell_b, order)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    demand = np.where(fields["occupied"], -(-fields["kstar"] // fields["ell_g"]), 0).sum(-1)
    assert (demand > pool_mask.sum(-1)).any()           # oversubscription was exercised
    assert not bool(got[2][torch.from_numpy(demand > pool_mask.sum(-1))].all())


def test_one_active_slot_is_allocate_masked():
    rng = np.random.default_rng(3)
    b, q = 40, 4
    p = torch.from_numpy(rng.uniform(0, 1, (b, N)).astype(np.float32))
    pool_mask = torch.from_numpy(rng.random((b, N)) < 0.85)
    slot = torch.from_numpy(rng.integers(0, q, b))
    active = torch.nn.functional.one_hot(slot, q).bool()
    ks = torch.from_numpy(rng.integers(10, 60, (b, q)).astype(np.int32))
    eg = torch.full((b, q), 10, dtype=torch.int32)
    eb = torch.full((b, q), 3, dtype=torch.int32)
    order = torch.from_numpy(np.stack([rng.permutation(q) for _ in range(b)]))
    loads, i_star, feas = lea.allocate_queue(p, pool_mask, active, ks, eg, eb, order)
    pick = lambda x: x.gather(-1, slot[:, None])[:, 0]
    ref = lea.allocate_masked(p, PoolLoad(kstar=pick(ks), ell_g=pick(eg), ell_b=pick(eb),
                                          mask=pool_mask))
    rows = torch.arange(b)
    assert torch.equal(loads[rows, slot], ref[0])
    assert torch.equal(i_star[rows, slot], ref[1]) and torch.equal(feas[rows, slot], ref[2])
    assert not loads[~active].any() and not feas[~active].any()


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

def _grid_inputs(b):
    """Per-row specs: the first half admit-all, the second controlled."""
    half = b // 2
    thr = np.float32([0.0] * half + [0.5] * (b - half))
    cap = np.float32([jserving.ADMIT_ALL_CAP] * half + [0.7] * (b - half))
    dl = np.int32([0, 1, 3, 2][:b])
    return thr, cap, dl


@pytest.mark.parametrize("grace", [0, 1])
@pytest.mark.parametrize("name", sorted(PROCESSES))
def test_sweep_serving_matches_jax(name, grace):
    b, rounds, strategies = 4, 48, ("lea", "oracle")
    keys = _keys(b, 100)
    jproc, proc = _processes(name, b)
    thr, cap, dl = _grid_inputs(b)
    rng = np.random.default_rng(1)
    p_gg = rng.uniform(0.7, 0.9, (b, N)).astype(np.float32)
    p_bb = rng.uniform(0.5, 0.8, (b, N)).astype(np.float32)
    jspec = jserving.RequestSpec(kstar=KS, ell_g=EG, ell_b=EB, deadline_rel=jnp.asarray(dl),
                                 admit_threshold=jnp.asarray(thr), reserve_cap=jnp.asarray(cap))
    want = jserving.sweep_serving(jnp.asarray(keys), jnp.ones((b, N), bool), jnp.asarray(p_gg),
                                  jnp.asarray(p_bb), MU_G, MU_B, D, jspec, jproc, rounds=rounds,
                                  strategies=strategies, capacity=3, grace=grace)
    spec = serving.RequestSpec(kstar=KS, ell_g=EG, ell_b=EB, deadline_rel=torch.from_numpy(dl),
                               admit_threshold=torch.from_numpy(thr),
                               reserve_cap=torch.from_numpy(cap))
    got = serving.sweep_serving(JaxServingDraws(keys, name), torch.ones((b, N), dtype=torch.bool),
                                p_gg, p_bb, MU_G, MU_B, D, spec, proc, rounds=rounds,
                                strategies=strategies, capacity=3, grace=grace, device=CPU)
    _compare(got, want, f"{name} grace={grace}")
    assert got.events.shape == (b, 2, rounds, 3)
    assert torch.equal(got.arrivals, got.admitted + got.rejected)
    assert torch.equal(got.admitted, got.served_on_time + got.served_late + got.expired
                       + got.in_flight)


def test_simulate_serving_with_a_time_axis_channel_matches_jax():
    key = jax.random.PRNGKey(5)
    rounds = 60
    spec_args = dict(kstar=KS, ell_g=EG, ell_b=EB, deadline_rel=2, admit_threshold=0.3,
                     reserve_cap=1.0)
    chan_spec = [("crash_restart", {"p_crash": 0.1, "p_restart": 0.5}),
                 ("preempt", {"p_preempt": 0.3, "min_frac": 0.2})]
    want = jserving.simulate_serving(
        key, jnp.ones((N,), bool), jnp.full((N,), 0.8), jnp.full((N,), 0.7), MU_G, MU_B, D,
        jserving.RequestSpec(**spec_args), jserving.make_process("poisson", rate=1.5),
        rounds=rounds, strategies=("lea", "oracle"), capacity=4, grace=1,
        channel=jfaults.make_channel(chan_spec))
    channel = faults.make_channel(chan_spec)
    got = serving.simulate_serving(
        JaxServingDraws(np.array(key)[None], "poisson", channel), torch.ones(N, dtype=torch.bool),
        [0.8] * N, [0.7] * N, MU_G, MU_B, D, serving.RequestSpec(**spec_args),
        serving.make_process("poisson", rate=1.5), rounds=rounds, strategies=("lea", "oracle"),
        capacity=4, grace=1, channel=channel, device=CPU)
    _compare(got, want, "channel")
    base = serving.simulate_serving(
        JaxServingDraws(np.array(key)[None], "poisson"), torch.ones(N, dtype=torch.bool),
        [0.8] * N, [0.7] * N, MU_G, MU_B, D, serving.RequestSpec(**spec_args),
        serving.make_process("poisson", rate=1.5), rounds=rounds, strategies=("lea", "oracle"),
        capacity=4, grace=1, device=CPU)
    assert (got.served_on_time <= base.served_on_time).all()


def test_arrival_grid_family_and_its_sweep_match_jax():
    got, want = sweeps.expand("arrival_grid", rounds=64), jsweeps.expand("arrival_grid", rounds=64)
    assert [s.name for s in got] == [s.name for s in want]
    for s, js in zip(got, want):
        assert (s.meta, s.rounds, s.strategies, s.baseline) == (
            js.meta, js.rounds, js.strategies, js.baseline)
        assert (s.lp.n, s.lp.kstar, s.lp.ell_g, s.lp.ell_b) == (
            js.lp.n, js.lp.kstar, js.lp.ell_g, js.lp.ell_b)
        assert (s.p_gg, s.p_bb, s.mu_g, s.mu_b, s.deadline) == (
            js.p_gg, js.p_bb, js.mu_g, js.mu_b, js.deadline)
    assert sweeps.describe("arrival_grid") == jsweeps.describe("arrival_grid")
    # the grid as bench_serving runs it: admit-all and controlled, same keys
    b, lp, meta = len(got), got[0].lp, [dict(s.meta) for s in got]
    keys = _keys(b, 2000)
    col = lambda k, dt: np.asarray([m[k] for m in meta], dt)
    rates, dl = col("rate", np.float32), col("deadline_rel", np.int32)
    p_gg = np.asarray([s.p_gg for s in got], np.float32)
    p_bb = np.asarray([s.p_bb for s in got], np.float32)
    for thr, cap in ((np.zeros(b, np.float32), np.full(b, jserving.ADMIT_ALL_CAP, np.float32)),
                     (col("admit_threshold", np.float32), col("reserve_cap", np.float32))):
        want_out = jserving.sweep_serving(
            jnp.asarray(keys), jnp.ones((b, lp.n), bool), jnp.asarray(p_gg), jnp.asarray(p_bb),
            got[0].mu_g, got[0].mu_b, got[0].deadline,
            jserving.RequestSpec(kstar=jnp.full((b,), lp.kstar, jnp.int32),
                                 ell_g=jnp.full((b,), lp.ell_g, jnp.int32),
                                 ell_b=jnp.full((b,), lp.ell_b, jnp.int32),
                                 deadline_rel=jnp.asarray(dl), admit_threshold=jnp.asarray(thr),
                                 reserve_cap=jnp.asarray(cap)),
            jserving.make_process("poisson", rate=jnp.asarray(rates)), rounds=64,
            strategies=("lea",), capacity=meta[0]["capacity"], grace=meta[0]["grace"])
        got_out = serving.sweep_serving(
            JaxServingDraws(keys, "poisson"), torch.ones((b, lp.n), dtype=torch.bool), p_gg, p_bb,
            got[0].mu_g, got[0].mu_b, got[0].deadline,
            serving.RequestSpec(kstar=lp.kstar, ell_g=lp.ell_g, ell_b=lp.ell_b,
                                deadline_rel=torch.from_numpy(dl),
                                admit_threshold=torch.from_numpy(thr),
                                reserve_cap=torch.from_numpy(cap)),
            serving.make_process("poisson", rate=torch.from_numpy(rates)), rounds=64,
            strategies=("lea",), capacity=meta[0]["capacity"], grace=meta[0]["grace"],
            device=CPU)
        _compare(got_out, want_out, f"arrival_grid thr={thr[0]}")


# ---------------------------------------------------------------------------
# properties
# ---------------------------------------------------------------------------

def _admit_all(deadline_rel=0):
    return dict(kstar=KS, ell_g=EG, ell_b=EB, deadline_rel=deadline_rel, admit_threshold=0.0,
                reserve_cap=serving.ADMIT_ALL_CAP)


def test_degenerate_single_slot_is_the_offline_engine_in_both_packages():
    key, rounds = jax.random.PRNGKey(7), 120
    mask = torch.ones(N, dtype=torch.bool)
    out = serving.simulate_serving(
        JaxServingDraws(np.array(key)[None]), mask, [0.8] * N, [0.7] * N, MU_G, MU_B, D,
        serving.RequestSpec(**_admit_all()), serving.make_process("constant", per_round=1),
        rounds=rounds, strategies=("lea",), capacity=1, device=CPU)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    pool = PoolLoad(kstar=i32(KS), ell_g=i32(EG), ell_b=i32(EB), mask=mask)
    succ = throughput.simulate_strategies_pool(JaxDraws(np.array(key)[None]), pool, [0.8] * N,
                                               [0.7] * N, MU_G, MU_B, D, rounds, ("lea",),
                                               device=CPU)[:, 0]
    jsucc = np.asarray(jtp.simulate_strategies_pool(
        key, jlea.PoolLoad(kstar=jnp.int32(KS), ell_g=jnp.int32(EG), ell_b=jnp.int32(EB),
                           mask=jnp.ones((N,), bool)),
        jnp.full((N,), 0.8), jnp.full((N,), 0.7), MU_G, MU_B, D, rounds,
        strategies=("lea",)))[:, 0].astype(bool)
    served = out.events[0, :, 0] == serving.EVENT_ON_TIME
    assert torch.equal(served, succ)
    np.testing.assert_array_equal(served.numpy(), jsucc)
    assert torch.equal(out.events[0, :, 0] == serving.EVENT_EXPIRED, ~succ)
    assert int(out.arrivals[0]) == int(out.admitted[0]) == rounds
    assert int(out.rejected[0]) == int(out.in_flight[0]) == 0
    assert bool((out.sojourn[0, :, 0][served] == 1).all())
    # the same with the port's own draws
    out_t = serving.simulate_serving(
        11, mask, [0.8] * N, [0.7] * N, MU_G, MU_B, D, serving.RequestSpec(**_admit_all()),
        serving.make_process("constant", per_round=1), rounds=rounds, capacity=1, device=CPU)
    succ_t = throughput.simulate_strategies_pool(11, pool, [0.8] * N, [0.7] * N, MU_G, MU_B, D,
                                                 rounds, ("lea",), device=CPU)[:, 0]
    assert torch.equal(out_t.events[0, :, 0] == serving.EVENT_ON_TIME, succ_t)


def test_zero_arrivals_is_the_idle_engine():
    mask = torch.ones(N, dtype=torch.bool)
    draws = torch_draws(3, CPU)
    out = serving.simulate_serving(
        draws, mask, [0.8] * N, [0.7] * N, MU_G, MU_B, D, serving.RequestSpec(**_admit_all()),
        serving.make_process("poisson", rate=0.0), rounds=80, capacity=4, device=CPU)
    for field in serving.ServingOutcomes._fields:
        assert not getattr(out, field).any(), field
    # the engine draws were untouched: the next rollout continues the same
    # stream as a fresh source's second rollout
    fresh = torch_draws(3, CPU)
    chain = (np.full((1, N), 0.8, np.float32), np.full((1, N), 0.7, np.float32))
    throughput.serve_rollout(fresh, mask[None], *chain, 80, device=CPU)
    a = throughput.serve_rollout(draws, mask[None], *chain, 80, device=CPU)
    b = throughput.serve_rollout(fresh, mask[None], *chain, 80, device=CPU)
    assert torch.equal(a[0], b[0])
    pool = PoolLoad(kstar=torch.tensor(KS, dtype=torch.int32),
                    ell_g=torch.tensor(EG, dtype=torch.int32),
                    ell_b=torch.tensor(EB, dtype=torch.int32), mask=mask)
    states_r, _, _ = throughput.rollout_pool(torch_draws(3, CPU), pool, [0.8] * N, [0.7] * N,
                                             80, ("lea",), device=CPU)
    states_s, _ = throughput.serve_rollout(torch_draws(3, CPU), mask[None], *chain, 80,
                                           device=CPU)
    assert torch.equal(states_s[0], states_r)


def test_batched_rows_equal_unbatched_runs():
    b, rounds = 3, 40
    rates = torch.tensor([0.5, 1.5, 3.0])
    dl = torch.tensor([1, 2, 3], dtype=torch.int32)
    spec = serving.RequestSpec(kstar=KS, ell_g=EG, ell_b=EB, deadline_rel=dl,
                               admit_threshold=0.4, reserve_cap=0.8)
    rng = np.random.default_rng(2)
    p_gg = rng.uniform(0.7, 0.9, (b, N)).astype(np.float32)
    p_bb = rng.uniform(0.5, 0.8, (b, N)).astype(np.float32)
    recorder = RecordedDraws(torch_draws(8, CPU))
    kwargs = dict(rounds=rounds, strategies=("lea", "oracle"), capacity=3, device=CPU)
    out = serving.sweep_serving(recorder, torch.ones((b, N), dtype=torch.bool), p_gg, p_bb,
                                MU_G, MU_B, D, spec, serving.make_process("poisson", rate=rates),
                                **kwargs)
    assert recorder.kinds == ["initial", "steps", "poisson"]
    for i in range(b):
        single = serving.simulate_serving(
            ReplayedDraws(recorder.calls, row=i), torch.ones(N, dtype=torch.bool), p_gg[i],
            p_bb[i], MU_G, MU_B, D, spec._replace(deadline_rel=int(dl[i])),
            serving.make_process("poisson", rate=float(rates[i])), **kwargs)
        for field in serving.ServingOutcomes._fields:
            assert torch.equal(getattr(out, field)[i], getattr(single, field)), (field, i)


def test_per_round_spec_rows_match_jax():
    key, rounds = jax.random.PRNGKey(9), 30
    ks = np.int32(np.where(np.arange(rounds) % 3 == 0, 30, 50))
    dl = np.int32(np.arange(rounds) % 3)
    want = jserving.simulate_serving(
        key, jnp.ones((N,), bool), jnp.full((N,), 0.8), jnp.full((N,), 0.7), MU_G, MU_B, D,
        jserving.RequestSpec(kstar=jnp.asarray(ks), ell_g=EG, ell_b=EB,
                             deadline_rel=jnp.asarray(dl), admit_threshold=0.4, reserve_cap=0.9),
        jserving.make_process("constant", per_round=2), rounds=rounds, capacity=4)
    got = serving.simulate_serving(
        JaxServingDraws(np.array(key)[None]), torch.ones(N, dtype=torch.bool), [0.8] * N,
        [0.7] * N, MU_G, MU_B, D,
        serving.RequestSpec(kstar=torch.from_numpy(ks), ell_g=EG, ell_b=EB,
                            deadline_rel=torch.from_numpy(dl), admit_threshold=0.4,
                            reserve_cap=0.9),
        serving.make_process("constant", per_round=2), rounds=rounds, capacity=4, device=CPU)
    _compare(got, want, "per-round spec")


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals_match_the_jax_package():
    mask = torch.ones(N, dtype=torch.bool)
    args = (mask, [0.8] * N, [0.7] * N, MU_G, MU_B, D, serving.RequestSpec(**_admit_all()),
            serving.make_process("constant", per_round=1))
    with pytest.raises(ValueError, match="packet"):
        serving.simulate_serving(0, *args, rounds=8, capacity=1, device=CPU,
                                 channel=faults.make_channel([("packet_bernoulli",
                                                               {"p_drop": 0.1})]))
    with pytest.raises(ValueError, match="static draws"):
        serving.simulate_serving(0, *args, rounds=8, strategies=("static",), device=CPU)
    with pytest.raises(ValueError, match="static draws"):
        throughput.serve_rollout(0, mask[None], np.full((1, N), 0.8, np.float32),
                                 np.full((1, N), 0.7, np.float32), 8, ("lea", "static_equal"),
                                 device=CPU)
    # a tap stride must be positive, in both packages and through the CLI
    jargs = (jnp.ones((N,), bool), jnp.full((N,), 0.8), jnp.full((N,), 0.7), MU_G, MU_B, D,
             jserving.RequestSpec(**_admit_all()), jserving.make_process("constant",
                                                                         per_round=1))
    with pytest.raises(ValueError, match="tap_stride"):
        jserving.simulate_serving(jax.random.PRNGKey(0), *jargs, rounds=8, tap=True,
                                  tap_stride=0)
    with pytest.raises(ValueError, match="tap_stride"):
        serving.simulate_serving(0, *args, rounds=8, device=CPU, tap=True, tap_stride=0)
    with pytest.raises(ValueError, match="tap_stride"):
        serving.sweep_serving(0, mask, np.full((1, N), 0.8, np.float32),
                              np.full((1, N), 0.7, np.float32), *args[3:], rounds=8,
                              device=CPU, tap=True, tap_stride=-1)
    with pytest.raises(ValueError, match="tap_stride"):
        serve.main(["--smoke", "--device", "cpu", "--progress", "--tap-stride", "0"],
                   echo=lambda line: None)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_serve_cli_summary_matches_the_jax_cli(capsys):
    want = jserve.main(["--smoke"])
    draws = JaxServingDraws(np.array(jax.random.PRNGKey(0))[None], "shift_exp")
    got = serve.main(["--smoke", "--device", "cpu"], draws=draws, echo=lambda line: None)
    assert got == want
    # and the port's own draws run the same accounting
    own = serve.main(["--smoke", "--device", "cpu", "--process", "mmpp", "--strategies",
                      "lea,oracle"], echo=lambda line: None)
    for row in own.values():
        assert row["arrivals"] == row["admitted"] + row["rejected"]


def test_serve_coded_example_matches_the_jax_example(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_EXAMPLE_ROUNDS", "40")
    g = runpy.run_path(str(ROOT / "examples" / "serve_coded.py"))
    key = np.array(jax.random.PRNGKey(0))[None]
    lines = []
    got = serve_coded.run(device=CPU, rounds=40,
                          draws=(JaxDraws(key), JaxServingDraws(key, "shift_exp")),
                          echo=lines.append)
    assert lines[-1] == "OK"
    out = g["out"]
    assert (got["served"], got["checked"]) == (g["served"], g["checked"])
    for field in ("arrivals", "admitted", "served_on_time", "served_late", "rejected",
                  "expired", "in_flight"):
        assert got[field] == int(getattr(out, field)[0]), field
