"""The port's five DeviceClasses, as the objects to create (the JAX
chart's ``templates/deviceclasses.yaml``, its selectors moved to the
port's drivers; the upstream chart's five class names).

- ``gpu.nvidia.com``: whole GPUs (no ``profile``, no ``passthrough``
  attribute);
- ``mig.nvidia.com``: MIG devices and tenant partitions (a ``profile``);
- ``vfio.gpu.nvidia.com``: GPUs published for passthrough
  (``gpu-<i>-passthrough``, with the ``PassthroughSupport`` gate on);
- ``compute-domain-default-channel.nvidia.com`` and
  ``compute-domain-daemon.nvidia.com``: the ComputeDomain plugin's
  channel and daemon devices.

They are dicts, not YAML: the card's image has no PyYAML, and the port
renders no chart. The JAX chart's optional ``extendedResourceName`` on
its chip class (KEP-5004) is left out; a test that wants it patches the
class.
"""

from __future__ import annotations

from ..computedomain import COMPUTE_DOMAIN_DRIVER_NAME as CD
from ..kubeletplugin import DRIVER_NAME as GPU

GPU_CLASS = "gpu.nvidia.com"
MIG_CLASS = "mig.nvidia.com"
VFIO_CLASS = "vfio.gpu.nvidia.com"
CHANNEL_CLASS = "compute-domain-default-channel.nvidia.com"
DAEMON_CLASS = "compute-domain-daemon.nvidia.com"

SELECTORS = {
    GPU_CLASS: (f'device.driver == "{GPU}" && '
                f'!("profile" in device.attributes["{GPU}"]) && '
                f'!("passthrough" in device.attributes["{GPU}"])'),
    MIG_CLASS: (f'device.driver == "{GPU}" && '
                f'("profile" in device.attributes["{GPU}"])'),
    VFIO_CLASS: (f'device.driver == "{GPU}" && '
                 f'("passthrough" in device.attributes["{GPU}"])'),
    CHANNEL_CLASS: (f'device.driver == "{CD}" && '
                    f'device.attributes["{CD}"].type == "channel"'),
    DAEMON_CLASS: (f'device.driver == "{CD}" && '
                   f'device.attributes["{CD}"].type == "daemon"'),
}


def device_classes() -> list[dict]:
    """The five DeviceClass objects (fresh dicts each call)."""
    return [{"apiVersion": "resource.k8s.io/v1", "kind": "DeviceClass",
             "metadata": {"name": name},
             "spec": {"selectors": [{"cel": {"expression": expression}}]}}
            for name, expression in SELECTORS.items()]


def create_all(kube) -> None:
    """Create the five classes through a kube client."""
    for cls in device_classes():
        kube.create("resource.k8s.io", "v1", "deviceclasses", cls)
