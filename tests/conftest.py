"""Shared test config.  NOTE: XLA_FLAGS/device-count overrides are deliberately
NOT set here — smoke tests and benches must see the single real CPU device.
Multi-device tests spawn subprocesses with their own XLA_FLAGS."""

import os
import sys

# Make `src` importable when pytest is run without PYTHONPATH=src.
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

# Property tests use the REAL `hypothesis` whenever it is installed (genuine
# shrinking in dev environments); only when the package is absent (the pinned
# container) does tests/_hypothesis_stub.py register its deterministic seeded
# fallback so the tests still collect and run.
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _hypothesis_stub import install_if_missing

install_if_missing()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one); run on the card "
        "with `python -m pytest -m cuda tests/test_torch_kernels.py`")
