"""On the card: each cell at a small size through the run's own path, and
a checkout that holds only the benchmark refuses to give a result."""

import shutil
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests.test_portbench_reference import SMALL


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_small_cell_on_the_card_is_correct(card, cell):
    result, _ = run.run_cell(cell, 2**31 + 5, 0.5, False, device=card,
                             overrides=SMALL[cell], min_jobs=2)
    assert result["correct"] and result["device"]["platform"] == "gpu", result


@pytest.mark.cuda
def test_the_benchmark_alone_gives_no_result(card, tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "lea_sim.fig3_sweep", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
