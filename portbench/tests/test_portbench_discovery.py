"""BENCHMARK.json against the benchmark's contract, and discovery by name:
a cell and a metric added as files appear with no file edited."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:   # the metric moves one its cell reports
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_every_cell_has_its_files_and_reports_enough():
    b = bench()
    for w in b["workloads"]:
        entry, config, traffic = run.cell_parts(b, w["name"])
        assert (run.HERE / "drivers" / f"{traffic['driver']}.py").is_file()
        e2e = [m["name"] for m in run.metrics_for(b, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = run.metrics_for(b, w["name"], "per_layer")
        assert layers
        for m in layers:
            assert (run.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert all(isinstance(v, (int, float)) for v in traffic["limits"].values())


def test_check_fits_the_time_of_a_full_check():
    b = bench()
    cells = 24          # the most a later PR may bring
    total = 2 + 14 * cells
    assert total * (b["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "portbench")

    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "lea_sim.fig3_short", "config": "lea_sim",
                           "traffic": "fig3_short", "chips": 1, "why": "a test cell"})
    b["per_layer"].append({"name": "jobs_traced.test", "unit": "count", "better": "higher",
                           "source": "host_clock", "layer": "device",
                           "moves": "row_rounds_per_s", "workloads": ["lea_sim.fig3_short"]})
    b["end_to_end"][0]["workloads"].append("lea_sim.fig3_short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    traffic = json.loads((run.HERE / "workloads" / "lea_sim.fig3_sweep.json").read_text())
    (tmp_path / "portbench" / "workloads" / "lea_sim.fig3_short.json").write_text(
        json.dumps({**traffic, "traffic": "fig3_short", "seeds": 2}))
    (tmp_path / "portbench" / "metrics" / "jobs_traced.test.py").write_text(
        "def read(ctx):\n    return float(ctx['jobs'])\n")

    after = _digest(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before

    copy = run.load_module(tmp_path / "portbench" / "run.py", "portbench_run_copy")
    assert copy.ROOT == tmp_path
    nb = copy.benchmark()
    entry, config, traffic = copy.cell_parts(nb, "lea_sim.fig3_short")
    assert traffic["seeds"] == 2 and config["name"] == "lea_sim"
    assert copy.load_driver(traffic).__name__ == "Driver"
    layers = [m["name"] for m in copy.metrics_for(nb, "lea_sim.fig3_short", "per_layer")]
    assert layers == ["jobs_traced.test"]
    reader = copy.load_module(copy.HERE / "metrics" / "jobs_traced.test.py", "m")
    assert reader.read({"jobs": 3}) == 3.0
    assert "row_rounds_per_s" in [
        m["name"] for m in copy.metrics_for(nb, "lea_sim.fig3_short", "end_to_end")]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        run.cell_parts(bench(), "no.such_cell")
