"""PyTorch/CUDA port of the workload that a prepared claim runs.

The serving and training paths of the JAX package
(``k8s_dra_driver_gpu_tpu``) written for an NVIDIA H100: Llama-3 with a
KV cache (``models/``), its training step and gang launcher
(``train/``), both also sharded over a ``torch.distributed`` device mesh
(``parallel/``), the attention dispatcher, the chunked loss, an
all-reduce benchmark and hand-written Hopper flash-attention kernels,
forward and backward (``ops/``, ``csrc/``); and the driver side's
device layer (``tpulib/``, NVML), the kubelet plugin
(``kubeletplugin/`` with ``api/`` and ``pkg/``: metrics, tracing and
the flight recorder among them), the ComputeDomain stack
(``computedomain/``: controller with its binary, daemon, CD plugin) and
the admission webhook (``webhook/``). The JAX
package stays the reference; this package imports nothing of it and
nothing of JAX.

Entry points run on the card unless the caller asks for the CPU
(``ops.resolve_device``). On CPU tensors every kernel wrapper computes
its plain PyTorch version; on CUDA tensors it launches the kernel or
raises.
"""


def _read_version() -> str:
    """The repository's ``VERSION`` file without its ``v`` (the JAX
    package reads the same file); ``0.0.0+unknown`` without one."""
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "VERSION")
    try:
        with open(path, encoding="utf-8") as f:
            return f.read().strip().lstrip("v")
    except OSError:
        return "0.0.0+unknown"


__version__ = _read_version()
