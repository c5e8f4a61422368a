"""tpulib: the device layer on an NVIDIA H100 host (NVML).

The port of ``k8s_dra_driver_gpu_tpu/tpulib/``, under the same directory
name: ``NvmlLib`` binds NVIDIA's ``libnvidia-ml.so.1`` over ctypes (the
counterpart of the reference's ``NativeTpuLib`` over its in-tree
``libtpuinfo.so``), and ``PyGpuLib`` is the pure-Python mock and devfs
backend (the counterpart of ``PyTpuLib``). Neither needs torch.
"""

from .binding import (
    ChipTelemetry,
    EnumerateOptions,
    GpuChip,
    GpuHostInfo,
    GpuLibError,
    HealthEvent,
    MigInstance,
    NvmlError,
    NvmlLib,
    PyGpuLib,
    SubSliceProfile,
    TenantUsage,
    load,
)

__all__ = [
    "ChipTelemetry",
    "EnumerateOptions",
    "GpuChip",
    "GpuHostInfo",
    "GpuLibError",
    "HealthEvent",
    "MigInstance",
    "NvmlError",
    "NvmlLib",
    "PyGpuLib",
    "SubSliceProfile",
    "TenantUsage",
    "load",
]
