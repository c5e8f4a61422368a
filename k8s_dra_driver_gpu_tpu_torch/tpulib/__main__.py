"""CLI: print this host's GPU enumeration as JSON.

Usage:
    python -m k8s_dra_driver_gpu_tpu_torch.tpulib          # NVML
    GPULIB_MOCK_TOPOLOGY=h100-16 python -m k8s_dra_driver_gpu_tpu_torch.tpulib

The keys are the reference's (``k8s_dra_driver_gpu_tpu/tpulib/
__main__.py``: the host's fields, ``backend``, ``profiles``) plus
``health_events_supported``: false when NVML refused Xid/ECC event
registration on some GPU. Exits 1 with the NVML error when NVML cannot be
loaded and no mock is asked for.
"""

import dataclasses
import json
import sys

from .binding import EnumerateOptions, GpuLibError, load


def main() -> int:
    try:
        lib = load()
    except GpuLibError as err:
        print(f"tpulib: {err}", file=sys.stderr)
        return 1
    opts = EnumerateOptions.from_env()
    doc = dataclasses.asdict(lib.enumerate(opts))
    doc["backend"] = lib.name
    doc["profiles"] = [
        dataclasses.asdict(p) for p in lib.subslice_profiles(opts)
    ]
    doc["health_events_supported"] = lib.health_events_supported
    print(json.dumps(doc, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
