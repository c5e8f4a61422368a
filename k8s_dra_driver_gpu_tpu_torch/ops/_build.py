"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build runs at a kernel's first launch, never at import, so the package
imports (and its CPU paths run) where there is no CUDA toolkit. The
library goes under ``k8s_dra_driver_gpu_tpu_torch/build/`` (listed in
``.gitignore``), named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is reused within a checkout.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Library:
    """A loaded kernel library and how it came to be."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    log: str  # nvcc's diagnostics, including ptxas register/smem usage


_loaded: dict[str, Library] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    the toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built only where the CUDA "
        "toolkit is installed (set CUDA_HOME or put nvcc on PATH)")


def nvcc_command(nvcc: str, source: Path, output: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, every ``csrc/*.cuh`` header (any of
    them may be included) and the compiler flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def load(name: str) -> Library:
    """Compile ``csrc/<name>.cu`` if this checkout has no build of its
    current source, then load it. Raises with nvcc's output on failure."""
    if name in _loaded:
        return _loaded[name]
    source = CSRC_DIR / f"{name}.cu"
    output = BUILD_DIR / f"{name}-{source_digest(name)}.so"
    seconds, log = 0.0, ""
    if not output.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = output.with_name(f"{output.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(nvcc_command(find_nvcc(), source, tmp),
                              capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {source} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, output)  # a concurrent build never sees half a file
        log = proc.stdout + proc.stderr
    library = Library(lib=ctypes.CDLL(str(output)), path=output,
                      build_seconds=seconds, log=log)
    _loaded[name] = library
    return library
