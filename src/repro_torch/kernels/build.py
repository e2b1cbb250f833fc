"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` exposes a plain C interface and is compiled, at
first use, into a shared library under ``build/repro_torch/`` of the
checkout (``build/`` is git-ignored)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>_<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  A missing
``nvcc`` raises; nothing falls back to a plain version.  :func:`build_all`
starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float      # since build_all began; 0.0 when reused
    log: str            # nvcc's output (ptxas register / spill report)


_LIBS: dict[str, ctypes.CDLL] = {}
_BUILDS: dict[str, BuildResult] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from source at first "
            "use and need the CUDA toolkit"
        )
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def sources() -> list[str]:
    """The names of every CUDA source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names=None) -> list[BuildResult]:
    """Build ``names`` (default: every source) unless their hashed libraries
    exist: one ``nvcc`` process per source, all started together, then waited
    for in turn.  Raises on the first build that fails."""
    names = sources() if names is None else list(names)
    t0 = time.perf_counter()
    started = {}
    try:
        for name in names:
            if name in _BUILDS or name in started:
                continue
            out = library_path(name)
            if out.exists():
                _BUILDS[name] = BuildResult(name, out, 0.0, "")
                continue
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            started[name] = (proc, tmp, out)
        for name, (proc, tmp, out) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
            os.replace(tmp, out)
            _BUILDS[name] = BuildResult(name, out, time.perf_counter() - t0, log)
    finally:
        for proc, tmp, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return [_BUILDS[name] for name in names]


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless its hashed library already exists."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name).path))
        _LIBS[name] = lib
    return lib


__all__ = ["BUILD_DIR", "BuildResult", "CSRC", "NVCC_FLAGS", "build",
           "build_all", "find_nvcc", "library_path", "load", "sources"]
