"""The kubelet plugin's whole-GPU prepare path on an NVIDIA H100 host.

The counterpart of the JAX package's ``kubeletplugin/`` (and of the
upstream driver's ``cmd/gpu-kubelet-plugin/``) for whole GPUs: enumerate
the GPUs once through the port's ``tpulib`` (NVML), describe each as a
DRA ``ResourceSlice`` device, and prepare a claim with a two-phase
checkpoint and a CDI spec; unprepare tears both down. ``DeviceState`` is
driven by direct calls: there is no gRPC transport and no kube client
yet (ROADMAP.md §1b). Standard library only.
"""

DRIVER_NAME = "gpu.nvidia.com"
# The CDI kind of the per-claim specs, "nvidia.com/gpu".
CDI_VENDOR = "nvidia.com"
CDI_CLASS = "gpu"
