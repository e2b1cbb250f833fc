"""A run whose timed path is broken underneath reads ``correct`` false.

Each test drives the rest of a run on the CPU (no look for a chip), at a
small size, with one fault planted in the program the window calls: an
answer altered where it is produced, half of the batch left out, a sweep
that hands back the previous sweep's state."""

import pytest

from portbench import run
from portbench.tests.test_portbench_reference import SMALL


def run_small(cell):
    # two sweeps whatever the CPU's speed
    result, _ = run.run_cell(cell, 2**31 + 3, 0.1, False, device="cpu",
                             overrides=SMALL[cell], min_jobs=2)
    return result


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_small_run_is_correct(cell):
    result = run_small(cell)
    assert result["correct"] and result["failed"] == 0, result
    assert list(result)[-1] == "checks"


def _flip_every_sweep(monkeypatch, fault):
    from repro_torch import sweeps

    real = sweeps.run_group

    def broken(*a, **k):
        return fault(real(*a, **k).copy())

    monkeypatch.setattr(sweeps, "run_group", broken)


def test_sweep_with_one_success_flipped_is_not_correct(monkeypatch):
    def flip(succ):
        succ[..., 0] = ~succ[..., 0]     # every row's LEA column, every round
        return succ

    _flip_every_sweep(monkeypatch, flip)
    assert not run_small("lea_sim.fig3_sweep")["correct"]


def test_sweep_with_half_the_rows_left_out_is_not_correct(monkeypatch):
    def half(succ):
        succ[succ.shape[0] // 2:] = False
        return succ

    _flip_every_sweep(monkeypatch, half)
    assert not run_small("lea_sim.fig3_sweep")["correct"]


def test_sweep_that_returns_the_last_sweep_is_not_correct(monkeypatch):
    from repro_torch import sweeps

    real = sweeps.run_group
    last = {}

    def stale(*a, **k):
        out = real(*a, **k)
        prev = last.get("out", out)
        last["out"] = out
        return prev

    monkeypatch.setattr(sweeps, "run_group", stale)
    assert not run_small("lea_sim.fig3_sweep")["correct"]


def _break_every_fault_sweep(monkeypatch, fault):
    from repro_torch import faults

    real = faults.sweep_faults
    monkeypatch.setattr(faults, "sweep_faults", lambda *a, **k: fault(real(*a, **k)))


def test_fault_grid_with_an_outcome_altered_is_not_correct(monkeypatch):
    _break_every_fault_sweep(monkeypatch,
                             lambda out: out._replace(partial=out.full_aon.clone()))
    assert not run_small("lea_sim.fault_grid")["correct"]


def test_fault_grid_with_half_the_rows_left_out_is_not_correct(monkeypatch):
    def half(out):
        fields = {}
        for name, x in out._asdict().items():
            x = x.clone()
            x[x.shape[0] // 2:] = False
            fields[name] = x
        return out._replace(**fields)

    _break_every_fault_sweep(monkeypatch, half)
    assert not run_small("lea_sim.fault_grid")["correct"]


def test_fault_grid_that_returns_the_last_sweep_is_not_correct(monkeypatch):
    last = {}

    def stale(out):
        prev = last.get("out", out)
        last["out"] = out
        return prev

    _break_every_fault_sweep(monkeypatch, stale)
    assert not run_small("lea_sim.fault_grid")["correct"]
