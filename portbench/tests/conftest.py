"""Test set-up for the benchmark's own tests: the program's ``src`` on the
path, the marker of tests that need an NVIDIA GPU, and short round blocks
for the small sweeps."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one); run on the card "
        "with `python -m pytest -m cuda portbench/tests`")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


SMALL_BLOCK_BYTES = 4 * 12 * 15 * 60 * 150     # 150 rounds a block at 12 rows of 15


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    """The program's ``round_chunk`` at a small budget: a small sweep then
    runs several blocks of the static resampler, as the full-size cell
    does, where the default budget would run it in one."""
    from repro_torch.sweeps import executor

    real = executor.suggest_round_chunk
    monkeypatch.setattr(executor, "suggest_round_chunk",
                        lambda group, **kw: real(group, budget_bytes=SMALL_BLOCK_BYTES, **kw))
