"""The kubelet plugin for whole GPUs, MIG devices and tenant partitions
on an NVIDIA H100 host.

The counterpart of the JAX package's ``kubeletplugin/`` (and of the
upstream driver's ``cmd/gpu-kubelet-plugin/``) for whole GPUs and MIG
devices:

- ``device_state``: enumerate the GPUs once through the port's
  ``tpulib`` (NVML), describe each, and each MIG device NVML offers or
  holds (``subslice``), as a DRA ``ResourceSlice`` device
  (``deviceinfo``), and prepare a claim (``claim``) with a two-phase
  checkpoint (``checkpoint``) and a CDI spec that injects its device
  nodes and the driver's libraries (``cdi``), and the claim's sharing
  (``sharing``: a GPU's timeslice through ``nvidia-smi``, an MPS control
  daemon a claim request, admitted through a tenancy agent
  (``tenancy_agent``) and the native preflight hook (``native_hook``,
  ``tenancy_preflight``)), each behind its feature gate
  (``pkg.featuregates``), and creates a dynamic MIG device through NVML;
  tenant partitions over MIG instances (``pkg.partition``), with one MPS
  daemon over an oversubscribed partition's instance; unprepare tears
  them down;
- ``driver``: the node service over an API server (``pkg.kubeclient``):
  ResourceSlice publication (``combined`` or ``split``) with per-GPU
  shared counters (``partitions``), claim
  lookup for prepare and unprepare, health taints (``health``), the
  reconcile sweep (``cleanup``, ``reconcile``) and the PartitionSet CRD
  watch (``pkg.partition.watch``).

There is no gRPC transport yet (ROADMAP.md §1b item 8): the callbacks
are driven by direct calls. Standard library only.
"""

DRIVER_NAME = "gpu.nvidia.com"
# The CDI kind of the per-claim specs, "nvidia.com/gpu".
CDI_VENDOR = "nvidia.com"
CDI_CLASS = "gpu"
