"""Run provenance: the who/where/when stamped into every manifest.

A manifest is a regression baseline; a baseline without provenance is
unfalsifiable ("was that number from this card? at which power limit? a
dirty tree?").  :func:`provenance` answers with a small JSON-able dict;
:func:`repro_torch.sweeps.results.write_manifest` stamps it into every
manifest it writes.

The JAX package's schema with ``jax`` / ``jaxlib`` replaced by ``torch``,
``cuda`` (``torch.version.cuda``) and ``power_limit_w`` (the card's power
limit, which a card may have set below its maximum, and which moves every
time taken on it).  ``backend`` is ``cuda`` or ``cpu``; ``device`` the
card's name (``torch.cuda.get_device_name``) or ``cpu``.

The timestamp is PASSED IN by the caller (``time.time()`` at the call
site) rather than read here, so two provenance calls in one process agree.
"""

from __future__ import annotations

import os
import platform
import re
import subprocess
import sys
from typing import Any

import torch

_SCHEMA_KEYS = (
    "git_sha", "git_dirty", "torch", "cuda", "backend", "device",
    "power_limit_w", "python", "platform", "timestamp",
)


def _repo_root() -> str:
    # src/repro_torch/obs/provenance.py -> the checkout root three levels up
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def _run(args: list[str], cwd: str | None = None) -> str | None:
    try:
        proc = subprocess.run(args, capture_output=True, text=True, timeout=30, cwd=cwd)
    except (OSError, subprocess.SubprocessError):
        return None
    return proc.stdout.strip() if proc.returncode == 0 else None


def power_limit_w() -> float | None:
    """The first card's power limit in watts, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` reports it; None
    when that fails."""
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    match = re.search(r",\s*([0-9.]+)\s*W", out.splitlines()[0]) if out else None
    return float(match.group(1)) if match else None


def provenance(
    timestamp: float | str | None = None, *, root: str | None = None, device=None
) -> dict[str, Any]:
    """The run's provenance record (all keys always present, None if unknown).

    ``timestamp`` is caller-supplied (see module docstring); ``root`` the
    git checkout to interrogate (defaults to this package's checkout);
    ``device`` the device the run used (default: ``cuda`` when a card is
    present, else ``cpu``).  Outside a git checkout ``git_sha`` /
    ``git_dirty`` are None; without ``nvidia-smi`` the power limit is None
    — provenance never fails a run.
    """
    cwd = root or _repo_root()
    sha = _run(["git", "rev-parse", "HEAD"], cwd)
    status = _run(["git", "status", "--porcelain"], cwd)
    doc: dict[str, Any] = {
        "git_sha": sha,
        "git_dirty": bool(status) if status is not None else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "timestamp": timestamp,
        "backend": None, "device": None, "power_limit_w": None,
    }
    try:
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        dev = torch.device(device)
        doc["backend"] = dev.type
        if dev.type == "cuda":
            doc["device"] = torch.cuda.get_device_name(dev)
            doc["power_limit_w"] = power_limit_w()
        else:
            doc["device"] = dev.type
    except (RuntimeError, AssertionError, ValueError):
        pass   # an unusable device string or driver: the keys stay None
    return doc


def has_required_fields(doc: dict[str, Any]) -> bool:
    """True iff ``doc`` carries the port's full provenance schema (values
    may be None — the keys are the contract)."""
    return all(k in doc for k in _SCHEMA_KEYS)
