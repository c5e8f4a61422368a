"""vfio passthrough: hand a whole GPU's PCI function to ``vfio-pci`` (the
JAX package's ``kubeletplugin/vfio.py``; the upstream driver's
``cmd/gpu-kubelet-plugin/vfio-device.go`` and ``vfio-cdi.go``).

``VfioPciManager.configure`` unbinds the function from its driver, sets
its ``driver_override`` to ``vfio-pci`` and binds it there;
``unconfigure`` clears the override and binds it back to the driver it
had (``nvidia`` when none was recorded). The CDI edits give the
container ``/dev/vfio/vfio`` and the group's node: ``/dev/vfio/<group>``
in the legacy mode, ``/dev/vfio/devices/vfio<group>`` with iommufd, and
``TPU_VFIO_GROUP``, ``TPU_VFIO_MODE`` (the JAX contract's names).

``VfioRegistry`` (``<root>/vfio.json``) records each rebind and the
driver to restore before sysfs is touched, so the plugin's start can
undo a rebind that a crash left without a claim record. Every path is
under ``sys_root`` and ``dev_root``, so the whole flow runs on a fake
sysfs tree; binding a card in use to ``vfio-pci`` takes it from its
driver's processes.
"""

from __future__ import annotations

import json
import logging
import os

from ..api.configs import VfioDeviceConfig
from ..pkg.flock import Flock
from .cdi import ContainerEdits

logger = logging.getLogger(__name__)

VFIO_DRIVER = "vfio-pci"
NATIVE_DRIVER = "nvidia"  # rebound to on release when none was recorded
LOCK_TIMEOUT_S = 10.0


class VfioRegistry:
    """The functions this plugin rebound to ``vfio-pci``, with their
    drivers before: ``<root>/vfio.json``, read-modify-written under its
    own flock and fsync'd."""

    def __init__(self, root: str):
        os.makedirs(root, exist_ok=True)
        self._path = os.path.join(root, "vfio.json")
        self._lock = Flock(self._path + ".lock")

    def list(self) -> dict[str, dict]:
        try:
            with open(self._path, encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return {}

    def _write(self, entries: dict[str, dict]) -> None:
        tmp = self._path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(entries, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path)

    def add(self, pci_bdf: str, native_driver: str | None) -> None:
        with self._lock.acquire(timeout=LOCK_TIMEOUT_S):
            entries = self.list()
            entries[pci_bdf] = {"nativeDriver": native_driver or ""}
            self._write(entries)

    def remove(self, pci_bdf: str) -> None:
        with self._lock.acquire(timeout=LOCK_TIMEOUT_S):
            entries = self.list()
            if entries.pop(pci_bdf, None) is not None:
                self._write(entries)

    def native_driver(self, pci_bdf: str) -> str | None:
        return self.list().get(pci_bdf, {}).get("nativeDriver") or None


class VfioPciManager:
    def __init__(self, sys_root: str = "/sys", dev_root: str = "/dev",
                 registry: VfioRegistry | None = None):
        self._sys = sys_root
        self._dev = dev_root
        self.registry = registry

    def _device_dir(self, pci_bdf: str) -> str:
        return os.path.join(self._sys, "bus", "pci", "devices", pci_bdf)

    def _driver_override(self, pci_bdf: str) -> str:
        return os.path.join(self._device_dir(pci_bdf), "driver_override")

    def _current_driver(self, pci_bdf: str) -> str | None:
        try:
            return os.path.basename(os.readlink(
                os.path.join(self._device_dir(pci_bdf), "driver")))
        except OSError:
            return None

    def iommu_group(self, pci_bdf: str) -> int:
        """The function's IOMMU group, -1 when it has none (no IOMMU, or
        no such function)."""
        try:
            return int(os.path.basename(os.readlink(
                os.path.join(self._device_dir(pci_bdf), "iommu_group"))))
        except (OSError, ValueError):
            return -1

    def _write(self, path: str, value: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(value)

    def _driver_file(self, driver: str, name: str) -> str:
        return os.path.join(self._sys, "bus", "pci", "drivers", driver, name)

    def _unbind(self, pci_bdf: str, driver: str) -> None:
        try:
            self._write(self._driver_file(driver, "unbind"), pci_bdf)
        except OSError as e:
            logger.warning("unbind %s from %s: %s", pci_bdf, driver, e)

    def configure(self, pci_bdf: str, cfg: VfioDeviceConfig
                  ) -> ContainerEdits:
        """Rebind the function to ``vfio-pci`` (upstream
        ``vfio-device.go:145``); the container's edits."""
        if self.iommu_group(pci_bdf) < 0:
            raise RuntimeError(
                f"device {pci_bdf} has no iommu group (IOMMU disabled?); "
                "refusing passthrough")
        current = self._current_driver(pci_bdf)
        if current != VFIO_DRIVER:
            # Recorded before sysfs is touched: a crash mid-rebind must be
            # undone at the next start.
            if self.registry is not None:
                self.registry.add(pci_bdf, current)
            if current:
                self._unbind(pci_bdf, current)
            self._write(self._driver_override(pci_bdf), VFIO_DRIVER)
            self._write(self._driver_file(VFIO_DRIVER, "bind"), pci_bdf)
        group = self.iommu_group(pci_bdf)
        if cfg.iommu_mode == "iommufd":
            node = os.path.join(self._dev, "vfio", "devices", f"vfio{group}")
        else:
            node = os.path.join(self._dev, "vfio", str(group))
        return ContainerEdits(
            env=[f"TPU_VFIO_GROUP={group}", f"TPU_VFIO_MODE={cfg.iommu_mode}"],
            device_nodes=[os.path.join(self._dev, "vfio", "vfio"), node])

    def unconfigure(self, pci_bdf: str) -> None:
        """Return the function to its recorded driver (upstream
        ``vfio-device.go:189``). Idempotent."""
        native = (self.registry.native_driver(pci_bdf)
                  if self.registry is not None else None) or NATIVE_DRIVER
        if self._current_driver(pci_bdf) == VFIO_DRIVER:
            self._unbind(pci_bdf, VFIO_DRIVER)
        try:
            self._write(self._driver_override(pci_bdf), "\n")
        except OSError:
            pass
        try:
            self._write(self._driver_file(native, "bind"), pci_bdf)
        except OSError as e:
            logger.warning("rebind %s to %s: %s", pci_bdf, native, e)
        if self.registry is not None:
            self.registry.remove(pci_bdf)
