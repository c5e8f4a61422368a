"""Build the native tenancy preflight hook, ``csrc/tenancy_preflight.cc``,
and install it where a CDI spec can point.

- **At first use, from the checkout.** ``build()`` compiles the source
  with the host C++ compiler (``$CXX``, else ``c++``, else ``g++``) and
  ``COMPILE_FLAGS`` into ``k8s_dra_driver_gpu_tpu_torch/build/`` (listed
  in ``.gitignore``), named by a digest of the source, the compiler's
  path and the flags, so an edited source is rebuilt and an unchanged
  one reused. The build runs under a file lock, into a temporary file
  renamed over the output, so concurrent builds never see half a binary.
  Nothing builds at import.
- **No fallback.** A failed build raises ``HookBuildError`` quoting the
  compiler's output, and so fails the prepare that needed the hook: the
  plugin never puts a script in the binary's place.
- **Static.** ``-static``, as the JAX package's Makefile links its hook:
  a runtime runs the hook on the host, whose C++ runtime may differ from
  the build machine's.
- ``install(bin_dir)`` copies the build to ``<bin_dir>/tenancy-preflight``
  (the JAX plugin's ``_hook_binary``), replacing an older copy.
"""

from __future__ import annotations

import dataclasses
import filecmp
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..pkg.flock import Flock

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "tenancy_preflight.cc"
BUILD_DIR = PACKAGE_DIR / "build"
COMPILE_FLAGS = ("-O2", "-Wall", "-Wextra", "-std=c++17", "-static")
INSTALLED_NAME = "tenancy-preflight"
BUILD_LOCK_TIMEOUT_S = 300.0


class HookBuildError(RuntimeError):
    """The hook could not be built."""


@dataclasses.dataclass(frozen=True)
class HookBuild:
    """A built hook and how it came to be."""

    path: str
    compiler: str
    flags: tuple[str, ...]
    seconds: float  # 0.0 when an earlier build was reused
    log: str  # the compiler's diagnostics


def find_compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on PATH."""
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        if cand and (path := shutil.which(cand)):
            return path
    raise HookBuildError(
        "no C++ compiler ($CXX, c++ or g++ on PATH): the tenancy preflight "
        f"hook is built from {SOURCE} on this host")


def build() -> HookBuild:
    """The hook built from this checkout's source, compiled now unless
    an earlier build of the same source is there."""
    compiler = find_compiler()
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update("\0".join((compiler, *COMPILE_FLAGS)).encode())
    output = BUILD_DIR / f"tenancy_preflight-{digest.hexdigest()[:16]}"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds, log = 0.0, ""
    with Flock(str(BUILD_DIR / "tenancy_preflight.lock")).acquire(
            timeout=BUILD_LOCK_TIMEOUT_S):
        if not output.exists():
            tmp = output.with_name(f"{output.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [compiler, *COMPILE_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True, check=False)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise HookBuildError(
                    f"{compiler} {' '.join(COMPILE_FLAGS)} failed to build "
                    f"{SOURCE} (exit {proc.returncode}):\n{log}")
            os.replace(tmp, output)
    return HookBuild(path=str(output), compiler=compiler,
                     flags=COMPILE_FLAGS, seconds=seconds, log=log)


def install(bin_dir: str) -> str:
    """Build the hook if need be and copy it to
    ``<bin_dir>/tenancy-preflight`` unless the copy there is the same;
    the copy's path."""
    built = build().path
    os.makedirs(bin_dir, exist_ok=True)
    target = os.path.join(bin_dir, INSTALLED_NAME)
    if not (os.path.exists(target)
            and filecmp.cmp(built, target, shallow=False)):
        tmp = f"{target}.{os.getpid()}.tmp"
        shutil.copy2(built, tmp)
        os.replace(tmp, target)
    return target
