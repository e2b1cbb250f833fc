"""The program's spans as the benchmark reads them: the idle split on a
hand-made trace, a traced small run of each cell on the CPU, and on the
card the share of device work that no span covers."""

import pytest

from portbench import run
from portbench.tests.test_portbench_reference import SMALL
from portbench.work import idle, trace

NEW = {"lea_sim.fig3_sweep": ("static_loads_ms.sweep", "static_tries.sweep",
                              "fetch_ms.sweep", "lift_host_ms.sweep"),
       "lea_sim.fault_grid": ("static_loads_ms.sweep", "static_tries.sweep",
                              "lift_host_ms.sweep", "channel_ms.grid")}


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_idle_is_split_by_the_span_the_host_was_in():
    events = [
        _x("user_annotation", "repro.static_loads", 100, 300),     # 100..400
        _x("user_annotation", "repro.static_wait", 150, 100),      # 150..250, nested
        _x("user_annotation", "repro.fetch", 500, 100),            # 500..600
        _x("cpu_op", "aten::item", 150, 100),
        _x("kernel", "a", 0, 120),          # busy 0..120
        _x("kernel", "b", 110, 20),         # overlaps a: busy 0..130
        _x("kernel", "c", 200, 50),         # busy 200..250
        _x("gpu_memcpy", "d", 450, 100),    # busy 450..550
        _x("kernel", "e", 700, 10),         # busy 700..710
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 900},
    ]
    # idle: 130..200 (static_loads, 50 of it under static_wait), 250..450
    # (150 under static_loads, 50 outside), 550..700 (50 under fetch, 100
    # outside)
    got = idle.idle_under(events)
    assert got == pytest.approx({"repro.static_loads": 0.22, "repro.static_wait": 0.05,
                                 "repro.fetch": 0.05, "": 0.15})
    busy_us = trace.read(events)["busy_s"] * 1e6
    union_us = 220 + 50          # idle inside static_loads, inside fetch
    assert got[""] * 1e3 + union_us == pytest.approx(710 - busy_us)


def test_idle_without_spans_is_all_outside_and_without_device_work_is_zero():
    events = [_x("kernel", "a", 0, 10), _x("kernel", "b", 30, 10)]
    assert idle.idle_under(events) == pytest.approx({"": 0.02})
    assert idle.idle_under([_x("user_annotation", "repro.lift", 0, 5)]) == {
        "repro.lift": 0.0, "": 0.0}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_run_reports_the_span_metrics(cell):
    result, _ = run.run_cell(cell, 2**31 + 7, 0.0, True, device="cpu",
                             overrides=SMALL[cell], min_jobs=2)
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(NEW[cell]) <= set(metrics), metrics
    assert metrics["static_tries.sweep"] >= 2 and metrics["lift_host_ms.sweep"] > 0


CARD = {"lea_sim.fig3_sweep": {"seeds": 16, "family_params": {"rounds": 5000}},
        "lea_sim.fault_grid": {"seeds": 8, "family_params": {"rounds": 5000}}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CARD))
def test_spans_cover_the_device_work_on_the_card(card, cell, monkeypatch):
    from repro_torch.sweeps import executor

    # one block of rounds, as the full-size cell runs its few large ones
    monkeypatch.setattr(executor, "suggest_round_chunk", lambda group, **kw: None)
    result, _ = run.run_cell(cell, 2**31 + 9, 0.0, True, device=card,
                             overrides=CARD[cell], min_jobs=2)
    jobs = run.cell_parts(run.benchmark(), cell)[2]["trace_jobs"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(NEW[cell]) <= set(metrics), metrics
    busy_ms = result["device"]["busy_s"] * 1e3
    assert metrics["unspanned_ms.sweep"] * jobs < 0.02 * busy_ms, (metrics, busy_ms)
