"""The port's sweep subsystem (``repro_torch.sweeps``) against ``repro.sweeps``.

With draws replayed from the JAX package's own per-row keys, the port's
grouped sweep gives the same per-scenario, per-seed throughputs and regret
columns as ``repro.sweeps.run`` — the paper's fig3 grid, the fused
heterogeneous-K* grid, a mask-padded pool ramp and the EC2 replay.
"""

import numpy as np
import pytest
import torch

from repro import sweeps as jsweeps
from repro_torch import convert, sweeps
from test_torch_engine import JaxDraws

CPU = "cpu"


def _replayed(jax_scenarios, seeds):
    """A ``draws=`` callable handing each port group the JAX group's keys."""
    by_names = {
        tuple(sc.name for sc in g.scenarios): np.array(g.batch.keys)
        for g in jsweeps.build_groups(jax_scenarios, seeds=seeds)
    }
    return lambda group: JaxDraws(by_names[tuple(sc.name for sc in group.scenarios)])


def _assert_same_results(got, want):
    assert [r.name for r in got] == [r.name for r in want]
    for g, w in zip(got, want):
        assert g.throughput == w.throughput, g.name
        assert g.per_seed == w.per_seed, g.name
        assert g.ratio == w.ratio, g.name
        assert g.regret == w.regret, g.name
        assert g.regret_ci95 == pytest.approx(w.regret_ci95), g.name
        assert g.ci95 == pytest.approx(w.ci95), g.name


@pytest.mark.parametrize("family,params,seeds", [
    ("fig3", {"rounds": 500}, 2),
    ("hetero_kstar", {"rounds": 300}, 1),
    ("elastic_pool", {"rounds": 200}, 1),
    ("fig4", {"rounds": 200}, 1),
])
def test_sweep_matches_jax_per_scenario(family, params, seeds):
    want = jsweeps.run(family, seeds=seeds, **params)
    draws = _replayed(jsweeps.expand(family, **params), seeds)
    got = sweeps.run(family, seeds=seeds, draws=draws, device=CPU, **params)
    _assert_same_results(got, want)


def test_chunked_sweep_matches_unchunked_with_replayed_draws():
    draws = _replayed(jsweeps.expand("fig3", rounds=300), 1)
    full = sweeps.run("fig3", rounds=300, draws=draws, device=CPU)
    chunked = sweeps.run("fig3", rounds=300, draws=draws, device=CPU,
                         round_chunk=64)
    _assert_same_results(chunked, full)


def test_batches_convert_from_the_jax_package_exactly():
    for family, params in [("hetero_kstar", {"rounds": 100}),
                           ("elastic_pool", {"rounds": 100}),
                           ("drifting_chains", {"rounds": 200, "periods": (100,)})]:
        jgroups = jsweeps.build_groups(jsweeps.expand(family, **params), seeds=2)
        groups = sweeps.build_groups(sweeps.expand(family, **params), seeds=2)
        assert len(groups) == len(jgroups)
        for g, jg in zip(groups, jgroups):
            carried = convert.scenario_batch(jg.batch, device=CPU,
                                             seeds=g.batch.seeds)
            assert torch.equal(convert.to_torch(jg.batch, device=CPU).p_gg,
                               g.batch.p_gg)
            pool = convert.to_torch(jg.batch.pool, device=CPU)
            assert torch.equal(pool.mask, g.batch.worker_mask)
            for name in carried._fields:
                assert torch.equal(getattr(carried, name), getattr(g.batch, name)), name
            assert g.rows == tuple(tuple(r) for r in jg.rows)


def test_catalogue_holds_every_family_of_this_slice():
    assert set(sweeps.family_names()) == set(jsweeps.family_names())
    for name in sweeps.family_names():
        assert sweeps.describe(name) == jsweeps.describe(name)


def test_group_generator_is_reproducible_and_seed_dependent():
    a = sweeps.run("hetero_kstar", rounds=150, device=CPU)
    b = sweeps.run("hetero_kstar", rounds=150, device=CPU)
    assert [r.throughput for r in a] == [r.throughput for r in b]
    g1, = sweeps.build_groups(sweeps.expand("fig3", rounds=50), seeds=1)
    g2, = sweeps.build_groups(sweeps.expand("fig3", rounds=50), seeds=2)
    assert g1.generator_seed != g2.generator_seed
    assert g1.batch.seeds[:, 0].tolist() == [1, 2, 3, 4]
    # the LEA edge holds on the port's own streams too
    for r in sweeps.run("fig3", rounds=400, device=CPU):
        assert r.throughput["lea"] > r.throughput["static"]


def test_catalogue_only_family_raises_and_round_chunk_suggestion():
    with pytest.raises(ValueError, match="catalogue-only"):
        sweeps.run("kstar_table", device=CPU)
    group, = sweeps.build_groups(sweeps.expand("fig3"), seeds=64)
    assert sweeps.suggest_round_chunk(group, budget_bytes=1 << 40) is None
    chunk = sweeps.suggest_round_chunk(group, budget_bytes=1 << 26)
    assert chunk is not None and 1 <= chunk < group.rounds
