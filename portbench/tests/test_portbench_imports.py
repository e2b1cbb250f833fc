"""The run refuses JAX and the JAX package, compared by whole top-level
module names, and refuses to run without a card."""

import os
import subprocess
import sys

import pytest

from portbench import run


@pytest.mark.parametrize("loaded, found", [
    (["repro_torch", "repro_torch.core"], []),
    (["repro"], ["repro"]),
    (["repro.core.throughput"], ["repro"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "reprolib", "flaxen"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(loaded, found):
    assert run.forbidden_modules(["portbench.run", "torch", *loaded]) == found


def test_nothing_the_harness_imports_loads_jax_or_repro():
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from portbench import run, control, draws\n"
        "from portbench.reference import engine, faults\n"
        "from portbench.work import b1, peaks, trace\n"
        "import repro_torch.sweeps, repro_torch.faults\n"
        "for d in ('sweep', 'fault_grid'):\n"
        "    run.load_driver({'driver': d})\n"
        "import pathlib\n"
        "for p in sorted(pathlib.Path('portbench/metrics').glob('*.py')):\n"
        "    run.load_module(p, 'm_' + p.stem.replace('.', '_'))\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_no_program():
    for path in sorted((run.HERE / "reference").glob("*.py")):
        text = path.read_text()
        assert "repro" not in text.replace("reproduc", ""), path.name
        assert "jax" not in text, path.name


def test_a_run_without_a_card_gives_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "lea_sim.fig3_sweep", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=run.ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "refused" in out.stderr


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: ({"correct": True}, []))
    monkeypatch.setitem(sys.modules, "jax", sys)
    rc = run.main(["--workload", "lea_sim.fig3_sweep", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err
