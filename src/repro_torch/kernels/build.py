"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` exposes a plain C interface and is compiled, at
first use, into a shared library under ``build/repro_torch/`` of the
checkout (``build/`` is git-ignored)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>_<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  A missing
``nvcc`` raises; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
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
    seconds: float      # 0.0 when an existing library was reused
    log: str            # nvcc's output (ptxas register / spill report)


_LOCK = threading.Lock()
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


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless its hashed library already exists."""
    with _LOCK:
        if name in _BUILDS:
            return _BUILDS[name]
        out = library_path(name)
        if out.exists():
            result = BuildResult(name, out, 0.0, "")
        else:
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                    capture_output=True, text=True, check=False,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed to build {name}.cu:\n{proc.stdout}{proc.stderr}"
                    )
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            result = BuildResult(name, out, time.perf_counter() - t0,
                                 proc.stdout + proc.stderr)
        _BUILDS[name] = result
        return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name).path))
        _LIBS[name] = lib
    return lib


__all__ = ["BUILD_DIR", "BuildResult", "CSRC", "NVCC_FLAGS", "build",
           "find_nvcc", "library_path", "load"]
