"""The plain reference against the port at small sizes on the CPU, and the
control (the reference in the precision below the configuration's) failing
the limits it has to fail."""

import itertools

import numpy as np
import pytest
import torch

from portbench import control
from portbench.draws import KeyedDraws
from portbench.reference import engine as ref

# small sizes of each cell: the traffic's parameters overridden
SMALL = {
    "lea_sim.fig3_sweep": {"seeds": 3, "family_params": {"rounds": 400},
                           "checked_rows_per_chain": 2},
    "lea_sim.fault_grid": {"seeds": 2, "family_params": {"rounds": 400}},
}


def test_tails_equal_the_enumerated_poisson_binomial():
    rng = np.random.default_rng(3)
    n = 7
    p = np.sort(rng.random((5, n)).astype(np.float32), axis=1)[:, ::-1].copy()
    w = ref.thresholds(n, kstar=20, ell_g=4, ell_b=2)
    got = ref.tails(p, w)
    for row in range(5):
        for i in range(n):
            want = 0.0
            for bits in itertools.product((0, 1), repeat=i + 1):
                if w[i] <= i + 1 and sum(bits) >= max(w[i], 0):
                    want += np.prod([p[row, j] if b else 1 - p[row, j]
                                     for j, b in enumerate(bits)], dtype=np.float64)
            assert abs(got[row, i] - want) <= 1e-6


def test_trajectory_follows_the_chain_step_by_step():
    u0 = np.array([[0.1, 0.9]], np.float32)
    u = np.array([[[0.85, 0.1], [0.5, 0.95]]], np.float32)
    p_gg = np.full((1, 2), 0.8, np.float32)
    p_bb = np.full((1, 2), 0.6, np.float32)
    # pi_g = 0.4 / 0.6: worker 0 starts good, worker 1 bad; good stays iff
    # u < 0.8, bad leaves iff u < 0.4
    assert ref.trajectory(u0, u, p_gg, p_bb).tolist() == [[[1, 0], [0, 1], [0, 0]]]


def test_keyed_draws_repeat_and_differ_by_position():
    a, b = KeyedDraws(2**31 + 7, 3, "cpu"), KeyedDraws(2**31 + 7, 3, "cpu")
    assert torch.equal(a.static(4, 100, 10, 20, 15, 2), b.static(4, 100, 10, 20, 15, 2))
    assert not torch.equal(a.static(4, 100, 10, 20, 15, 2), a.static(4, 100, 10, 20, 15, 3))
    assert not torch.equal(a.steps(4, 10, 15), KeyedDraws(2**31 + 7, 4, "cpu").steps(4, 10, 15))


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_reference_matches_the_port_and_the_control_fails(cell):
    seen = control.readings(cell, 2**31 + 11, 2, device="cpu", overrides=SMALL[cell])
    limits = seen["limits"]
    assert all(seen["program"][k] <= limits[k] for k in limits), seen
    assert all(v == 0 for v in seen["program"].values()), seen
    assert any(seen["control"][k] > limits[k] for k in limits), seen


def test_the_sweep_takes_the_programs_own_round_chunk(monkeypatch):
    """The cell's blocks are whatever the program suggests at its default
    budget, so a change of that default is measured by the cell."""
    from repro_torch.sweeps import executor

    from portbench import run

    asked = []
    monkeypatch.setattr(executor, "suggest_round_chunk",
                        lambda *a, **k: asked.append((a, k)) or 150)
    _, config, traffic = run.cell_parts(run.benchmark(), "lea_sim.fig3_sweep")
    traffic = {**traffic, **SMALL["lea_sim.fig3_sweep"]}
    driver = run.load_driver(traffic)(config, traffic, 7, "cpu")
    driver.setup()
    assert driver.chunk == 150 and len(asked) == 1
    (group,), kwargs = asked[0]
    assert group is driver.group and kwargs == {}
