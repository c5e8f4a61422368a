"""Probe: does reading NVML beside CUDA in one process corrupt its heap?

    python -m k8s_dra_driver_gpu_tpu_torch.tpulib.heap_probe \\
        [--procs 160] [--reads 30] [--parallel 8] [MODE ...]

Each mode starts ``--procs`` fresh processes, ``--parallel`` at a time.
Each process loads ``NvmlLib``, enumerates, polls ``health()`` once and
takes ``--reads`` ``chip_telemetry()`` samples (each reads every NVLink
error field of every GPU), as the device layer's callers do. The modes:

- ``cuda``: torch initialises CUDA in the process first;
- ``nocuda``: the process never imports torch;
- ``padded``: as ``cuda``, but the NVLink fields are read by direct
  ``nvmlDeviceGetFieldValues`` calls into an array with 64 guard entries
  on each side, filled with 0xAB, and the guards are checked after each
  call.

It prints one line a mode: the processes that died (and the first
lines of their errors, with ``PYTHONFAULTHANDLER`` set) and, for
``padded``, any guard byte NVML wrote. Needs a host with NVML; ``cuda``
and ``padded`` need a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

MODES = ("cuda", "nocuda", "padded")
GUARD = 64  # guard entries on each side of the padded field array


def _padded_reads(lib, gpulib, reads: int) -> list[dict]:
    """``reads`` NVLink field reads of GPU 0 into a guarded array; where
    NVML wrote a guard byte, its offsets from the array's start."""
    size = ctypes.sizeof(gpulib.NvmlFieldValue)
    handle = lib._handles[0]
    hits = []
    for read in range(reads):
        links = []
        for link in range(gpulib.NVML_NVLINK_MAX_LINKS):
            active = ctypes.c_int()
            if lib._lib.nvmlDeviceGetNvLinkState(
                    handle, link, ctypes.byref(active)) == 0 and \
                    active.value == gpulib.NVML_FEATURE_ENABLED:
                links.append(link)
        wanted = [(link, field) for link in links
                  for field in gpulib.NVML_FIELD_IDS.values()]
        n = len(wanted)
        buf = (gpulib.NvmlFieldValue * (n + 2 * GUARD))()
        base = ctypes.addressof(buf)
        ctypes.memset(base, 0xAB, GUARD * size)
        ctypes.memset(base + (GUARD + n) * size, 0xAB, GUARD * size)
        values = (gpulib.NvmlFieldValue * n).from_address(base + GUARD * size)
        for fv, (link, field) in zip(values, wanted):
            fv.fieldId, fv.scopeId = field, link
        lib._lib.nvmlDeviceGetFieldValues(handle, n, values)
        front = ctypes.string_at(base, GUARD * size)
        back = ctypes.string_at(base + (GUARD + n) * size, GUARD * size)
        written = [i - GUARD * size for i, b in enumerate(front) if b != 0xAB]
        written += [n * size + i for i, b in enumerate(back) if b != 0xAB]
        if written:
            hits.append({"read": read, "first": written[0],
                         "last": written[-1], "bytes": len(written)})
        for fv in values:
            for counter in (0, 1, 2, 3):
                count = ctypes.c_ulonglong()
                lib._lib.nvmlDeviceGetNvLinkErrorCounter(
                    handle, fv.scopeId, counter, ctypes.byref(count))
    return hits


def child(mode: str, reads: int) -> None:
    if mode in ("cuda", "padded"):
        import torch

        torch.cuda.get_device_properties(0)
    from . import binding as gpulib

    lib = gpulib.NvmlLib()
    # The probe of the very fault for which NvmlLib refuses these reads
    # beside CUDA.
    lib.allow_beside_cuda = True
    try:
        lib.enumerate()
        lib.health()
        hits = []
        if mode == "padded":
            hits = _padded_reads(lib, gpulib, reads)
        else:
            for _ in range(reads):
                lib.chip_telemetry()
    finally:
        lib.close()
    print(json.dumps({"hits": hits}))


def run(mode: str, procs: int, reads: int, parallel: int) -> dict:
    env = dict(os.environ, PYTHONFAULTHANDLER="1")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    def one(_):
        return subprocess.run(
            [sys.executable, "-m", __spec__.name, "--child", mode,
             "--reads", str(reads)], capture_output=True, text=True,
            timeout=300, env=env, cwd=root)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(parallel) as pool:
        done = list(pool.map(one, range(procs)))
    died = [p for p in done if p.returncode]
    hits = [h for p in done if not p.returncode
            for h in json.loads(p.stdout.splitlines()[-1])["hits"]]
    return {"mode": mode, "procs": procs, "reads": reads, "died": len(died),
            "guard_hits": hits[:8], "n_guard_hits": len(hits),
            "seconds": round(time.perf_counter() - t0, 1),
            "errors": [" | ".join(line.strip() for line in
                                  p.stderr.splitlines()[:6])
                       for p in died[:3]]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("modes", nargs="*", metavar="MODE",
                        help=f"of {', '.join(MODES)} (default: all)")
    parser.add_argument("--procs", type=int, default=160)
    parser.add_argument("--reads", type=int, default=30)
    parser.add_argument("--parallel", type=int, default=8)
    parser.add_argument("--child", choices=MODES, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        child(args.child, args.reads)
        return 0
    unknown = sorted(set(args.modes) - set(MODES))
    if unknown:
        parser.error(f"unknown mode(s) {unknown}")
    for mode in args.modes or MODES:
        print(json.dumps(run(mode, args.procs, args.reads, args.parallel)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
