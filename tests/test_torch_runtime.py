"""Parity of the port's runtime (``repro_torch.runtime``: the retry/degrade
executor and the elastic estimator remap) and of the ported quickstart with
the JAX package, on the CPU.

The JAX executor threads one key: ``split`` for its initial states, one
per Markov step, one per attempt's fault channel (injector ``i`` then
draws from ``fold_in(that, i)``) and one per resize.  :class:`ExecutorJaxDraws`
replays that chain as the port's draws calls, so both executors see the
same worker states and faults: outcome histograms, per-round info and
gradients are compared round by round, case by case with
``tests/runtime/test_fault_tolerance.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro import sweeps as jsweeps
from repro.core import lea as jlea
from repro.runtime import elastic as jelastic
from repro.runtime import fault_tolerance as jft
from repro_torch import faults
from repro_torch.core import lea
from repro_torch.examples import quickstart
from repro_torch.runtime import elastic
from repro_torch.runtime import fault_tolerance as ft
from test_torch_engine import JaxDraws
from test_torch_faults import jax_fault_uniforms

CPU = "cpu"


class ExecutorJaxDraws:
    """The uniforms ``repro``'s executor draws from ``PRNGKey(seed)``, in
    the order the port's executor asks for them."""

    def __init__(self, seed, channel=()):
        self.key = jax.random.PRNGKey(seed)
        self.parts = [type(inj).parts for inj in channel]
        self._fault_key = None

    def _next(self):
        self.key, k = jax.random.split(self.key)
        self._fault_key = None
        return k

    @staticmethod
    def _t(x):
        return torch.from_numpy(np.array(x, np.float32))

    def initial(self, rows, n):
        return self._t(jax.random.uniform(self._next(), (n,)))[None]

    def steps(self, rows, rounds, n):
        assert rounds == 2
        return self._t(jax.random.uniform(self._next(), (n,)))[None, None]

    def static(self, *args):
        raise AssertionError("the executor draws no static resamples")

    single = static

    def fault(self, rows, position, part, shape):
        if self._fault_key is None:          # the attempt's channel key
            self._fault_key = self._next()
        return self._t(jax_fault_uniforms(self._fault_key[None], self.parts[position],
                                          position, part, shape))


def _jgrad(params, shard):
    return {"w": jnp.mean(shard["x"], axis=0)}


def _grad(params, shard):
    return {"w": torch.mean(shard["x"], dim=0)}


X = np.arange(64, dtype=np.float32).reshape(16, 4)


def _pair(kwargs, seed, spec=()):
    """The JAX executor and the port's on replayed draws, same config."""
    jex = jft.CodedDataParallelExecutor(jft.CodedDPConfig(**kwargs), _jgrad, seed=seed,
                                        channel=jfaults.make_channel(spec))
    channel = faults.make_channel(spec)
    ex = ft.CodedDataParallelExecutor(ft.CodedDPConfig(**kwargs), _grad,
                                      draws=ExecutorJaxDraws(seed, channel),
                                      channel=channel, device=CPU)
    return jex, ex


def _rounds(jex, ex, count, x=X):
    """``count`` rounds of both, compared round by round; the port's
    (gradient, info) pairs."""
    out = []
    for _ in range(count):
        jg, jinfo = jex.round({"w": jnp.zeros(4)}, {"x": jnp.asarray(x)})
        g, info = ex.round({"w": torch.zeros(4)}, {"x": torch.from_numpy(x)})
        assert info == jinfo
        assert (g is None) == (jg is None) == (info["outcome"] == "dropped")
        if g is not None:
            np.testing.assert_allclose(g["w"].numpy(), np.asarray(jg["w"]), rtol=1e-6)
        out.append((g, info))
    assert ex.outcomes == jex.outcomes
    assert (ex.rounds, ex.successes) == (jex.rounds, jex.successes)
    np.testing.assert_array_equal(ex.est.counts.numpy(), np.asarray(jex.est.counts))
    return out


CASES = {
    "every_round_one_outcome": (dict(p_gg=0.6, p_bb=0.8, packets=4, max_retries=1,
                                     allow_partial=True), 3,
                                [("preempt", {"p_preempt": 0.4})]),
    "defaults_all_or_nothing": (dict(p_gg=0.7, p_bb=0.7), 0, []),
    "retries": (dict(p_gg=0.5, p_bb=0.85, max_retries=3, backoff_base=2), 1, []),
    "partial_burst": (dict(p_gg=0.9, p_bb=0.3, packets=4, p1=1, allow_partial=True), 2,
                      [("burst", {"p_event": 0.3, "frac": 0.5})]),
    "bench_faults_demo": (dict(packets=4, max_retries=2, allow_partial=True, p1=1), 0,
                          [("preempt", {"p_preempt": 0.35})]),
    "crash_and_erasure": (dict(packets=2, max_retries=1, allow_partial=True), 4,
                          [("crash_restart", {"p_crash": 0.2, "p_restart": 0.5}),
                           ("gilbert_elliott", {"p_gb": 0.3, "p_bg": 0.4})]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_executor_matches_jax_round_by_round(case):
    kwargs, seed, spec = CASES[case]
    jex, ex = _pair(kwargs, seed, spec)
    infos = [info for _, info in _rounds(jex, ex, 30)]
    assert sum(ex.outcomes.values()) == ex.rounds == 30
    assert all(i["outcome"] in ft.OUTCOMES for i in infos)
    if case == "defaults_all_or_nothing":
        assert ex.outcomes["late"] == ex.outcomes["partial"] == 0
        assert ex.successes == ex.outcomes["on_time"]
        assert ex.timely_throughput == ex.successes / 30
    if case == "retries":
        assert ex.outcomes["late"] > 0
        assert all(i["attempts"] > 1 for i in infos if i["outcome"] == "late")


def test_partial_serving_requires_allow_partial():
    kwargs = dict(p_gg=0.9, p_bb=0.3, packets=4, p1=1)
    spec = [("burst", {"p_event": 0.3, "frac": 0.5})]
    _, no = _pair(kwargs, 2, spec)
    _, yes = _pair(dict(kwargs, allow_partial=True), 2, spec)
    for _ in range(40):
        no.round({"w": torch.zeros(4)}, {"x": torch.from_numpy(X)})
        g, info = yes.round({"w": torch.zeros(4)}, {"x": torch.from_numpy(X)})
        if info["outcome"] == "partial":
            assert g is not None
    assert no.outcomes["partial"] == 0 < yes.outcomes["partial"]
    assert yes.outcomes["on_time"] == no.outcomes["on_time"]
    assert yes.outcomes["partial"] + yes.outcomes["dropped"] == no.outcomes["dropped"]


def test_gradient_is_the_uncoded_mean_whenever_served():
    jex, ex = _pair(dict(p_gg=0.95, p_bb=0.3), 0)
    want = X.reshape(16, -1, 4).mean(axis=(0, 1))
    served = [g for g, _ in _rounds(jex, ex, 10) if g is not None]
    assert served
    for g in served:
        np.testing.assert_allclose(g["w"].numpy(), want, rtol=1e-6)


def test_state_dict_round_trip_and_legacy_checkpoints():
    jex, ex = _pair(dict(p_gg=0.6, p_bb=0.8, packets=2, max_retries=1, allow_partial=True), 5)
    _rounds(jex, ex, 12)
    d = ex.state_dict()
    assert d == jex.state_dict()
    other = ft.CodedDataParallelExecutor(ex.cfg, _grad, draws=99, device=CPU)
    other.load_state_dict(d)
    assert other.outcomes == ex.outcomes
    assert (other.rounds, other.successes) == (ex.rounds, ex.successes)
    assert torch.equal(other.est.counts, ex.est.counts)
    del d["outcomes"]
    fresh = ft.CodedDataParallelExecutor(ft.CodedDPConfig(), _grad, draws=1, device=CPU)
    fresh.load_state_dict(d)
    assert fresh.outcomes == {name: 0 for name in ft.OUTCOMES}


def test_mark_dead_feasibility_and_dead_workers_send_nothing():
    cfg = dict(n_workers=5, r=4, k=16, p_gg=0.99, p_bb=0.01)
    jex, ex = _pair(cfg, 0)
    assert ex.decode_feasible
    ex.mark_dead(0)
    assert ex.decode_feasible                 # 4 * 4 = 16 >= 16
    ex.mark_dead(1)
    assert not ex.decode_feasible             # 3 * 4 = 12 < 16
    jex.mark_dead(0)
    jex.mark_dead(1)
    mask, loads, info = ex._attempt()
    jmask, jloads, jinfo = jex._attempt()
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(loads, jloads)
    assert info == jinfo
    assert not mask[:2 * 4].any() and loads[0] == loads[1] == 0


@pytest.mark.parametrize("new_n,survivors", [(8, None), (5, [6, 2, 4, 0, 7])])
def test_resize_matches_jax(new_n, survivors):
    start = 5 if survivors is None else 8
    jex, ex = _pair(dict(n_workers=start, r=4, k=16), 0)
    _rounds(jex, ex, 5)
    ex.mark_dead(1)
    jex.mark_dead(1)
    old = ex.est.counts.clone()
    ex.resize(new_n, survivors)
    jex.resize(new_n, survivors)
    assert ex.cfg.n_workers == new_n and ex.live.shape == (new_n,)
    np.testing.assert_array_equal(ex.live, jex.live)
    np.testing.assert_array_equal(ex._true_states.numpy(), np.asarray(jex._true_states))
    if survivors is None:
        assert not ex.live[1] and ex.live[5:].all()
        assert torch.equal(ex.est.counts[:5], old)
    else:
        assert torch.equal(ex.est.counts, old[survivors])
    _rounds(jex, ex, 3)
    assert sum(ex.outcomes.values()) == ex.rounds


@pytest.mark.parametrize("old_n,new_n,survivors", [
    (5, 5, None), (5, 8, None), (8, 5, None), (8, 5, [6, 2, 4, 0, 7]), (4, 6, [3, 1]),
    (3, 2, []),
])
def test_remap_estimator_matches_jax(old_n, new_n, survivors):
    rng = np.random.default_rng(old_n * 10 + new_n)
    counts = rng.integers(0, 9, (old_n, 4)).astype(np.float32)
    prev = rng.integers(0, 2, old_n).astype(np.int32)
    jest = jlea.EstimatorState(counts=jnp.asarray(counts), prev_state=jnp.asarray(prev),
                               seen_prev=jnp.asarray(True))
    est = lea.EstimatorState(counts=torch.from_numpy(counts), prev_state=torch.from_numpy(prev),
                             seen_prev=torch.tensor(True))
    want = jelastic.remap_estimator(jest, old_n, new_n, survivors)
    got = elastic.remap_estimator(est, old_n, new_n, survivors)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.prev_state.numpy(), np.asarray(want.prev_state))
    assert bool(got.seen_prev) and got.counts.dtype == torch.float32
    np.testing.assert_array_equal(lea.predicted_good_prob(got).numpy(),
                                  np.asarray(jlea.predicted_good_prob(want)))


def test_quickstart_sweep_rows_match_the_jax_example():
    """The JAX example's two sweeps (fig3 at REPRO_QUICKSTART_ROUNDS, the
    drifting chain at max(rounds, 300)), replayed: the same printed rows."""
    rounds = 150
    fig3 = jsweeps.run("fig3", rounds=rounds)
    drifting = jsweeps.run("drifting_chains", periods=(150,), rounds=300, step=25)
    keys = {tuple(sc.name for sc in g.scenarios): np.array(g.batch.keys)
            for scen in (jsweeps.expand("fig3", rounds=rounds),
                         jsweeps.expand("drifting_chains", periods=(150,), rounds=300,
                                        step=25))
            for g in jsweeps.build_groups(scen, seeds=1)}
    draws = lambda group: JaxDraws(keys[tuple(sc.name for sc in group.scenarios)])
    printed = []
    got = quickstart.run(device=CPU, rounds=rounds, draws=draws, echo=printed.append)
    assert got["lines"] == quickstart.sweep_lines(fig3, drifting)
    assert printed[-1] == "OK" and got["kstar"] == 6
    for r, jr in zip(got["fig3"], fig3):
        assert r.throughput == jr.throughput
