"""Parity of the port's engine (``repro_torch.core`` + ``policies``) with the
JAX package, on the CPU.

The port draws its randomness through a ``Draws`` source; :class:`JaxDraws`
replays, position for position, the uniforms ``repro``'s engine draws from
``jax.random`` on the same key.  With it the port's trajectories,
allocations and per-round successes equal ``repro``'s exactly.  Float
stages whose summation order differs between XLA and PyTorch
(``lea_discount``'s recurrence, ``ucb``'s ``log1p``) are held to stated
tolerances instead.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lea as jlea
from repro.core import markov as jmarkov
from repro.core import throughput as jtp
from repro.policies import registry as jregistry
from repro.policies.api import PolicyContext as JPolicyContext
from repro_torch import convert
from repro_torch.core import lea, markov, throughput
from repro_torch.core.lea import LoadParams
from repro_torch.policies import registry
from repro_torch.policies.api import PolicyContext

CPU = "cpu"
LP = LoadParams(n=15, kstar=99, ell_g=10, ell_b=3)
FIG3_CHAINS = [(0.8, 0.8), (0.8, 0.7), (0.8, 0.533), (0.9, 0.6)]


@functools.lru_cache(maxsize=None)
def _uniforms(n, depth):
    """jit of uniform(k, (n,)) vmapped over ``depth`` leading key axes."""
    f = lambda k: jax.random.uniform(k, (n,))
    for _ in range(depth):
        f = jax.vmap(f)
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _split_rows(num):
    """jit of split(k, num) vmapped over the row axis."""
    return jax.jit(jax.vmap(lambda k: jax.random.split(k, num)))


_split_pairs = jax.jit(jax.vmap(jax.vmap(jax.random.split)))


class JaxDraws:
    """The uniforms ``repro``'s engine draws on ``keys`` (B, 2), replayed.

    Mirrors ``throughput.engine_preamble`` / ``markov.sample_trajectory`` /
    ``throughput._static_loads_batch``: ``k_traj, k_rounds = split(key)``;
    ``k0, k1 = split(k_traj)`` feed the initial states and the per-step
    keys ``split(k1, M-1)``; the round keys ``split(k_rounds, M)`` feed the
    static resampler's per-try chains (``k, sub = split(k)``) and
    ``static_single``'s one draw.  ``trajectory_keys=True`` takes ``keys`` as
    the keys handed to ``markov.sample_trajectory`` itself.
    """

    def __init__(self, keys, trajectory_keys=False):
        keys = jnp.asarray(np.array(keys), jnp.uint32).reshape(-1, 2)
        if trajectory_keys:
            k_traj, self.k_rounds = keys, None
        else:
            kk = _split_rows(2)(keys)
            k_traj, self.k_rounds = kk[:, 0], kk[:, 1]
        kt = _split_rows(2)(k_traj)
        self.k0, self.k1 = kt[:, 0], kt[:, 1]
        self._tries = {}

    @staticmethod
    def _t(x):
        return torch.from_numpy(np.array(x, np.float32))

    def initial(self, rows, n):
        assert rows == self.k0.shape[0]
        return self._t(_uniforms(n, 1)(self.k0))

    def steps(self, rows, rounds, n):
        return self._t(_uniforms(n, 2)(_split_rows(rounds - 1)(self.k1)))

    def static(self, rows, rounds, start, stop, n, try_index):
        chain = self._tries.setdefault(
            (rounds, n), {"keys": _split_rows(rounds)(self.k_rounds), "u": []})
        while len(chain["u"]) <= try_index:
            pair = _split_pairs(chain["keys"])            # (B, M, 2, 2)
            chain["keys"] = pair[:, :, 0]
            chain["u"].append(self._t(_uniforms(n, 2)(pair[:, :, 1])))
        return chain["u"][try_index][:, start:stop]

    def single(self, rows, rounds, start, stop, n):
        u = _uniforms(n, 2)(_split_rows(rounds)(self.k_rounds))
        return self._t(u)[:, start:stop]


def _key(i):
    return jax.random.PRNGKey(i)


def _chain(rng, n, rounds=None):
    shape = (n,) if rounds is None else (rounds, n)
    return (rng.uniform(0.55, 0.95, shape).astype(np.float32),
            rng.uniform(0.4, 0.9, shape).astype(np.float32))


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["stationary", "time_varying", "worker_mask"])
def test_sample_trajectory_matches_jax_exactly(case):
    rng = np.random.default_rng(7)
    n, rounds = 12, 300
    p_gg, p_bb = _chain(rng, n, rounds if case == "time_varying" else None)
    mask = (np.arange(n) < 9) if case == "worker_mask" else None
    key = _key(5)
    want = np.array(jmarkov.sample_trajectory(
        key, jnp.asarray(p_gg), jnp.asarray(p_bb), rounds,
        worker_mask=None if mask is None else jnp.asarray(mask)))
    got = markov.sample_trajectory(
        JaxDraws(key[None], trajectory_keys=True), torch.from_numpy(p_gg)[None],
        torch.from_numpy(p_bb)[None], rounds,
        worker_mask=None if mask is None else torch.from_numpy(mask)[None])
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("rounds", [1, 2, 3, 17, 257])
def test_doubling_scan_equals_sequential_recurrence(rounds):
    rng = np.random.default_rng(rounds)
    p_gg, p_bb = _chain(rng, 6)
    args = (torch.from_numpy(np.stack([p_gg] * 3)),
            torch.from_numpy(np.stack([p_bb] * 3)), rounds)
    fast = markov.sample_trajectory(JaxDraws(np.stack([_key(i) for i in range(3)])), *args)
    slow = markov.sample_trajectory_scan(JaxDraws(np.stack([_key(i) for i in range(3)])), *args)
    np.testing.assert_array_equal(fast.numpy(), slow.numpy())


def test_t_step_transitions_match_jax_exactly():
    for t in (1, 2, 3, 7, 12):
        want = jmarkov.t_step_transitions(0.85, 0.6, t)
        got = markov.t_step_transitions(0.85, 0.6, t)
        for a, b in zip(got, want):
            assert float(a) == float(b)


# ---------------------------------------------------------------------------
# estimator + policies
# ---------------------------------------------------------------------------

def test_sequential_estimator_matches_jax_and_converts():
    rng = np.random.default_rng(3)
    states = rng.integers(0, 2, (40, 9)).astype(np.int32)
    js = jlea.init_estimator(9)
    ts = lea.init_estimator(9, device=CPU)
    for row in states:
        js = jlea.update_estimator(js, jnp.asarray(row))
        ts = lea.update_estimator(ts, torch.from_numpy(row))
        np.testing.assert_array_equal(lea.predicted_good_prob(ts).numpy(),
                                      np.array(jlea.predicted_good_prob(js)))
    carried = convert.estimator_state(js, device=CPU)
    np.testing.assert_array_equal(carried.counts.numpy(), ts.counts.numpy())
    np.testing.assert_array_equal(carried.prev_state.numpy(), ts.prev_state.numpy())


# (policy, rtol): 0 means bit-equal
POLICY_TOLERANCE = [
    ("lea", 0.0), ("oracle", 0.0), ("lea_window64", 0.0),
    ("lea_discount97", 1e-6), ("ucb", 1e-6),
]


@pytest.mark.parametrize("name,rtol", POLICY_TOLERANCE)
@pytest.mark.parametrize("time_varying", [False, True])
def test_policy_replays_match_jax(name, rtol, time_varying):
    rng = np.random.default_rng(11)
    rounds, n = 400, 10
    p_gg, p_bb = _chain(rng, n, rounds if time_varying else None)
    states = np.array(jmarkov.sample_trajectory(
        _key(2), jnp.asarray(p_gg), jnp.asarray(p_bb), rounds))
    row0 = (p_gg[0], p_bb[0]) if time_varying else (p_gg, p_bb)
    pi_g = np.array(jmarkov.stationary_good_prob(*map(jnp.asarray, row0)))
    replay = jax.jit(lambda *a: jregistry.resolve(name).p_good_trajectory(
        JPolicyContext(*a, key=_key(0))))
    want = np.array(replay(*map(jnp.asarray, (states, p_gg, p_bb, pi_g))))
    got = registry.resolve(name).p_good_trajectory(PolicyContext(
        states=torch.from_numpy(states)[None], p_gg=torch.from_numpy(p_gg)[None],
        p_bb=torch.from_numpy(p_bb)[None], pi_g=torch.from_numpy(pi_g)[None]))
    got = got[0].numpy()
    assert got.dtype == np.float32
    if rtol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


# ---------------------------------------------------------------------------
# the whole engine
# ---------------------------------------------------------------------------

STRATS = ("lea", "static", "oracle")


@pytest.mark.parametrize("round_chunk", [None, 96])
@pytest.mark.parametrize("scenario", [1, 3])
def test_simulate_strategies_matches_jax_per_round(scenario, round_chunk):
    p_gg, p_bb = FIG3_CHAINS[scenario - 1]
    rounds = 500
    args = (np.full(15, p_gg, np.float32), np.full(15, p_bb, np.float32),
            10.0, 3.0, 1.0, rounds)
    jlp = jlea.LoadParams(15, 99, 10, 3)
    want = np.array(jtp.simulate_strategies(
        _key(scenario), jlp, *map(jnp.asarray, args[:2]), *args[2:],
        strategies=STRATS + ("static_equal", "static_single"),
        round_chunk=round_chunk))
    got = throughput.simulate_strategies(
        JaxDraws(_key(scenario)[None]), convert.load_params(jlp), *args,
        strategies=STRATS + ("static_equal", "static_single"),
        round_chunk=round_chunk, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("round_chunk", [None, 128])
@pytest.mark.parametrize("padded", [False, True])
def test_simulate_strategies_pool_matches_jax_per_round(padded, round_chunk):
    rng = np.random.default_rng(4)
    n_valid, n = (11, 15) if padded else (15, 15)
    p_gg, p_bb = _chain(rng, n)
    if padded:
        p_gg[n_valid:], p_bb[n_valid:] = 1.0, 0.0
    jpool = jlea.PoolLoad(kstar=jnp.asarray(60, jnp.int32),
                          ell_g=jnp.asarray(8, jnp.int32),
                          ell_b=jnp.asarray(2, jnp.int32),
                          mask=jnp.arange(n) < n_valid)
    rounds = 400
    want = np.array(jtp.simulate_strategies_pool(
        _key(9), jpool, jnp.asarray(p_gg), jnp.asarray(p_bb), 10.0, 3.0, 0.9,
        rounds, strategies=STRATS, round_chunk=round_chunk))
    got = throughput.simulate_strategies_pool(
        JaxDraws(_key(9)[None]), convert.pool_load(jpool, device=CPU),
        p_gg, p_bb, 10.0, 3.0, 0.9, rounds, STRATS, round_chunk, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)


def test_full_width_pool_equals_static_load_params():
    args = (np.full(15, 0.8, np.float32), np.full(15, 0.7, np.float32),
            10.0, 3.0, 1.0, 300)
    static = throughput.simulate_strategies(
        JaxDraws(_key(2)[None]), LP, *args, device=CPU)
    pooled = throughput.simulate_strategies_pool(
        JaxDraws(_key(2)[None]), lea.pool_load(LP, device=CPU), *args,
        device=CPU)
    np.testing.assert_array_equal(static.numpy(), pooled.numpy())


def test_time_varying_engine_matches_jax():
    rng = np.random.default_rng(8)
    rounds = 300
    p_gg, p_bb = _chain(rng, 15, rounds)
    jlp = jlea.LoadParams(15, 99, 10, 3)
    strategies = ("lea", "lea_window64", "static", "oracle")
    want = np.array(jtp.simulate_strategies(
        _key(6), jlp, jnp.asarray(p_gg), jnp.asarray(p_bb), 10.0, 3.0, 1.0,
        rounds, strategies=strategies))
    got = throughput.simulate_strategies(
        JaxDraws(_key(6)[None]), LP, p_gg, p_bb, 10.0, 3.0, 1.0, rounds,
        strategies, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)


def test_compare_rollout_and_score_match_jax():
    p = (np.full(15, 0.8, np.float32), np.full(15, 0.533, np.float32))
    jlp = jlea.LoadParams(15, 99, 10, 3)
    want = jtp.compare(_key(3), jlp, *map(jnp.asarray, p), 10.0, 3.0, 1.0, 400)
    got = throughput.compare(JaxDraws(_key(3)[None]), LP, *p, 10.0, 3.0, 1.0,
                             400, device=CPU)
    assert got == want
    states, loads, feas = throughput.rollout(JaxDraws(_key(3)[None]), LP, *p,
                                             400, STRATS, device=CPU)
    jstates, jloads, jfeas = jtp.rollout(_key(3), jlp, *map(jnp.asarray, p),
                                         400, STRATS)
    np.testing.assert_array_equal(states.numpy(), np.array(jstates))
    np.testing.assert_array_equal(loads.numpy(), np.array(jloads))
    np.testing.assert_array_equal(feas.numpy(), np.array(jfeas))
    scored = throughput.score_rollout(states, loads, feas, LP, 10.0, 3.0, 1.0)
    assert {s: throughput.timely_throughput(scored[:, j])
            for j, s in enumerate(STRATS)} == want


def test_torch_draws_are_reproducible_and_seed_dependent():
    args = (LP, np.full(15, 0.8), np.full(15, 0.7), 10.0, 3.0, 1.0, 200)
    a = throughput.simulate_strategies(1, *args, device=CPU)
    b = throughput.simulate_strategies(1, *args, device=CPU)
    c = throughput.simulate_strategies(2, *args, device=CPU)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_unknown_strategy_and_bad_chain_raise():
    with pytest.raises(ValueError, match="unknown strategy"):
        throughput.simulate_strategies(0, LP, np.full(15, 0.8), np.full(15, 0.7),
                                       10.0, 3.0, 1.0, 10, ("nope",), device=CPU)
    with pytest.raises(ValueError, match="one row per round"):
        throughput.simulate_strategies(0, LP, np.full((5, 15), 0.8),
                                       np.full((5, 15), 0.7), 10.0, 3.0, 1.0,
                                       10, device=CPU)
