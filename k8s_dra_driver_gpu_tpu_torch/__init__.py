"""PyTorch/CUDA port of the workload that a prepared claim runs.

The serving and training paths of the JAX package
(``k8s_dra_driver_gpu_tpu``) written for an NVIDIA H100: Llama-3 with a
KV cache (``models/``), its training step and gang launcher
(``train/``), both also sharded over a ``torch.distributed`` device mesh
(``parallel/``), the attention dispatcher, the chunked loss, an
all-reduce benchmark and hand-written Hopper flash-attention kernels,
forward and backward (``ops/``, ``csrc/``); and the driver side's
device layer (``tpulib/``, NVML) and the kubelet plugin's whole-GPU
prepare path (``kubeletplugin/`` with ``api/`` and ``pkg/``). The JAX
package stays the reference; this package imports nothing of it and
nothing of JAX.

Entry points run on the card unless the caller asks for the CPU
(``ops.resolve_device``). On CPU tensors every kernel wrapper computes
its plain PyTorch version; on CUDA tensors it launches the kernel or
raises.
"""
