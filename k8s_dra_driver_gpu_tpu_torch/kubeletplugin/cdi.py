"""CDI specs: inject a claim's GPUs, the NVIDIA driver's user-space
libraries and the env into its containers (the JAX package's
``kubeletplugin/cdi.py``; the upstream driver's
``cmd/gpu-kubelet-plugin/cdi.go``).

One transient spec a claim, of kind ``nvidia.com/gpu``:

- each GPU's device entry holds its node ``/dev/nvidia<minor>``;
- the spec's common edits hold ``/dev/nvidiactl``, ``/dev/nvidia-uvm``
  and ``/dev/nvidia-uvm-tools``, each only where it exists under the
  device root (checked with ``os.path.exists``: a device node is never
  opened); the driver's libraries and ``nvidia-smi`` (below); and the
  host env: ``TPU_ACCELERATOR_TYPE`` and ``TPU_WORKER_ID`` (the names of
  the launcher's ``TPU_*`` contract, which the port's launcher reads)
  and the two migration annotations;
- the claim's own line follows (``device_state``):
  ``CUDA_DEVICE_ORDER=PCI_BUS_ID``;
- an MPS request's GPUs (and an oversubscribed partition tenant's
  device) carry the tenancy preflight's ``createContainer`` and
  ``poststop`` hooks when the plugin runs tenancy agents
  (``sharing.py``), each with a 10 s timeout.

**Driver libraries** (the counterpart of the JAX plugin's libtpu mount,
as the upstream driver's CDI library discovery finds them): each of
``DRIVER_LIBRARIES`` as ``<name>.so.<driver version>``, the version
NVML reports, from the first directory under the driver root that has
it, bound read-only at its own path with the driver root stripped. The
directories searched are those this process maps ``libnvidia-ml`` from
(``/proc/self/maps``: the NVML the device layer loaded, so the driver
the host really runs), then ``LIBRARY_DIRS``. A driver version whose
``libcuda`` or ``libnvidia-ml`` is not found is an error: a spec
without them would start a container that cannot run CUDA. Every soname link in that directory that resolves to the
file (``libcuda.so.1``, ``libcuda.so``) gets a second bind of the same
host file at the link's path: the effect of the upstream's
``create-symlinks`` hook without a hook binary. A library of another
version is never mounted (a host may keep a CUDA compat copy beside the
driver's); without a driver version (the mock and devfs backends)
nothing is mounted. ``nvidia-smi`` and the MPS binaries
(``nvidia-cuda-mps-control``, ``nvidia-cuda-mps-server``) are bound
from the first of ``BINARY_DIRS`` that has each (``find_binary``, which
``sharing.py`` runs them from too), where found. Not ported: the
``update-ldcache`` hook (the container's loader cache does not list the
libraries; their soname binds sit in the image's own library
directory), and the persistenced binary (ROADMAP.md §1b). Nor has the
spec the JAX package's ``TPU_SKIP_MDS_QUERY`` (a GCE metadata switch).
"""

from __future__ import annotations

import json
import logging
import os
import re
from dataclasses import dataclass, field

from ..pkg.fsutil import write_json_atomic
from . import CDI_CLASS, CDI_VENDOR

logger = logging.getLogger(__name__)

CDI_VERSION = "0.6.0"
DEFAULT_CDI_ROOT = "/var/run/cdi"
# The control nodes every CUDA process opens besides its GPU's own.
COMMON_DEVICE_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")
# The driver's compute and utility libraries that the upstream mounts
# (nvidia-container-toolkit's library discovery).
DRIVER_LIBRARIES = ("libcuda", "libcudadebugger", "libnvidia-ml",
                    "libnvidia-ptxjitcompiler", "libnvidia-nvvm",
                    "libnvidia-gpucomp")
# nvidia-smi, and MPS's control daemon and server (``sharing.py``).
DRIVER_BINARIES = ("nvidia-smi", "nvidia-cuda-mps-control",
                   "nvidia-cuda-mps-server")
# Without them a container cannot run CUDA.
REQUIRED_LIBRARIES = ("libcuda", "libnvidia-ml")
# Searched in this order under the driver root, after the directories
# this process maps NVML from; the first that has a library wins. The
# H100 machine's CUDA processes map the driver from
# usr/lib/x86_64-linux-gnu (PERF.md); usr/local/nvidia/lib64 is the
# layout of GKE and of the GPU operator's driver container.
LIBRARY_DIRS = ("usr/lib/x86_64-linux-gnu", "usr/lib64",
                "lib/x86_64-linux-gnu", "lib64", "usr/lib", "lib",
                "usr/local/nvidia/lib64")
BINARY_DIRS = ("usr/local/sbin", "usr/local/bin", "usr/sbin", "usr/bin",
               "sbin", "bin")


def _first_file(root: str, dirs: tuple[str, ...], name: str) -> str | None:
    """The path relative to ``root`` of the first ``dir/name`` that is a
    file (a link to one counts), or None."""
    for d in dirs:
        rel = os.path.join(d, name)
        if os.path.isfile(os.path.join(root, rel)):
            return rel
    return None


def find_binary(driver_root: str, name: str) -> str | None:
    """The host path of the driver's binary ``name``: the first of
    ``BINARY_DIRS`` under ``driver_root`` that has it, or None."""
    rel = _first_file(driver_root, BINARY_DIRS, name)
    return None if rel is None else os.path.join(driver_root, rel)


def mapped_library_dirs(driver_root: str) -> tuple[str, ...]:
    """The directories, relative to ``driver_root``, that this process
    maps a ``libnvidia-ml`` from; those outside the root are left out."""
    root = os.path.realpath(driver_root)
    dirs: list[str] = []
    with open("/proc/self/maps", encoding="utf-8") as f:
        for fields in map(str.split, f):
            if len(fields) < 6 or not os.path.basename(
                    fields[5]).startswith("libnvidia-ml.so"):
                continue
            rel = os.path.relpath(os.path.dirname(fields[5]), root)
            if not rel.startswith("..") and rel not in dirs:
                dirs.append(rel)
    return tuple(dirs)


def driver_mounts(driver_root: str, version: str
                  ) -> list[tuple[str, str, bool]]:
    """The read-only binds of the driver's libraries at ``version`` and
    of its binaries under ``driver_root``: (hostPath, containerPath,
    read_only), each library file first, then its soname links.
    FileNotFoundError when a library of ``REQUIRED_LIBRARIES`` is not
    found."""
    mapped = mapped_library_dirs(driver_root)
    dirs = mapped + tuple(d for d in LIBRARY_DIRS if d not in mapped)
    missing = [lib for lib in REQUIRED_LIBRARIES
               if _first_file(driver_root, dirs,
                              f"{lib}.so.{version}") is None]
    if missing:
        raise FileNotFoundError(
            f"driver {version}: no {', '.join(missing)} of that version "
            f"under {driver_root} in {', '.join(dirs)}")
    mounts: list[tuple[str, str, bool]] = []
    for lib in DRIVER_LIBRARIES:
        rel = _first_file(driver_root, dirs, f"{lib}.so.{version}")
        if rel is None:
            continue
        host = os.path.join(driver_root, rel)
        mounts.append((host, "/" + rel, True))
        directory = os.path.dirname(host)
        target = os.path.realpath(host)
        soname = re.compile(re.escape(lib) + r"\.so(\.\d+)*")
        for entry in sorted(os.listdir(directory)):
            link = os.path.join(directory, entry)
            if (entry != os.path.basename(host) and soname.fullmatch(entry)
                    and os.path.islink(link)
                    and os.path.realpath(link) == target):
                mounts.append((host, "/" + os.path.join(
                    os.path.dirname(rel), entry), True))
    for binary in DRIVER_BINARIES:
        host = find_binary(driver_root, binary)
        if host is not None:
            mounts.append((host, "/" + os.path.relpath(host, driver_root),
                           True))
    return mounts


@dataclass
class ContainerEdits:
    env: list[str] = field(default_factory=list)
    device_nodes: list[str] = field(default_factory=list)
    # (hostPath, containerPath, read_only)
    mounts: list[tuple[str, str, bool]] = field(default_factory=list)
    # OCI hooks the runtime runs on the host: (hookName, path, args), the
    # args from argv[0]. The tenancy preflight is a createContainer hook,
    # so a DENIED admission fails the container's start.
    hooks: list[tuple[str, str, list[str]]] = field(default_factory=list)

    def to_dict(self) -> dict:
        out: dict = {}
        if self.env:
            out["env"] = self.env
        if self.device_nodes:
            out["deviceNodes"] = [{"path": p} for p in self.device_nodes]
        if self.mounts:
            out["mounts"] = [
                {"hostPath": h, "containerPath": c,
                 "options": (["ro"] if ro else ["rw"])
                 + ["nosuid", "nodev", "bind"]}
                for h, c, ro in self.mounts]
        if self.hooks:
            # The runtime kills a hook that outlives its timeout (a wedged
            # agent); for createContainer that fails the start, closed.
            out["hooks"] = [{"hookName": name, "path": path, "args": args,
                             "timeout": 10}
                            for name, path, args in self.hooks]
        return out

    def merge(self, other: "ContainerEdits") -> "ContainerEdits":
        return ContainerEdits(env=self.env + other.env,
                              device_nodes=self.device_nodes
                              + other.device_nodes,
                              mounts=self.mounts + other.mounts,
                              hooks=self.hooks + other.hooks)


def qualified_device_id(name: str) -> str:
    return f"{CDI_VENDOR}/{CDI_CLASS}={name}"


class CDIHandler:
    """Writes and removes the per-claim spec files under the CDI root.
    The driver's files are looked up under ``driver_root``, and the spec
    names them by that path: it must be the host's own path of the
    driver root as this process sees it ("/" for a plugin that runs in
    the host's mount namespace). A plugin that sees the host's root
    under another path needs the upstream's separate host driver root,
    which comes with the entry point (ROADMAP.md §1b item 8)."""

    def __init__(self, cdi_root: str = DEFAULT_CDI_ROOT,
                 dev_root: str = "/dev", driver_root: str = "/"):
        self._root = cdi_root
        self._dev_root = dev_root
        self._driver_root = driver_root
        # driver version -> its mounts (upstream GetCommonEditsCached).
        self._mounts: dict[str, list[tuple[str, str, bool]]] = {}
        os.makedirs(self._root, exist_ok=True)

    def driver_mounts(self, version: str) -> list[tuple[str, str, bool]]:
        """The driver's binds at ``version``, found once a version;
        FileNotFoundError when its ``libcuda`` or ``libnvidia-ml`` is
        missing."""
        if version not in self._mounts:
            if not version:
                logger.warning("no driver version (not NVML): the CDI "
                               "spec mounts no driver library")
                self._mounts[version] = []
            else:
                self._mounts[version] = driver_mounts(self._driver_root,
                                                      version)
                logger.info("driver %s: %d mounts under %s", version,
                            len(self._mounts[version]), self._driver_root)
        return list(self._mounts[version])

    def spec_path(self, claim_uid: str) -> str:
        return os.path.join(self._root,
                            f"{CDI_VENDOR}-{CDI_CLASS}_{claim_uid}.json")

    def common_edits(self, host) -> ContainerEdits:
        """The edits every claim on this host shares (upstream
        ``GetCommonEditsCached``, cdi.go:112)."""
        nodes = [path for name in COMMON_DEVICE_NODES
                 if os.path.exists(path := os.path.join(self._dev_root,
                                                        name))]
        return ContainerEdits(
            env=[f"TPU_ACCELERATOR_TYPE={host.accelerator_type}",
                 f"TPU_WORKER_ID={host.worker_id}",
                 ("TPU_DRA_MIGRATION_INTENT_ANNOTATION="
                  "resource.tpu.dra/migration-intent"),
                 ("TPU_DRA_MIGRATION_ACK_ANNOTATION="
                  "resource.tpu.dra/migration-ack")],
            device_nodes=nodes,
            mounts=self.driver_mounts(host.driver_version))

    def create_claim_spec_file(self, claim_uid: str,
                               device_edits: dict[str, ContainerEdits],
                               common: ContainerEdits | None = None
                               ) -> list[str]:
        """Write a claim's spec durably, before the checkpoint calls the
        claim PrepareCompleted; returns its qualified CDI device ids
        (upstream ``CreateClaimSpecFile``, cdi.go:181)."""
        devices = [{"name": name, "containerEdits": edits.to_dict()}
                   for name, edits in sorted(device_edits.items())]
        spec = {"cdiVersion": CDI_VERSION,
                "kind": f"{CDI_VENDOR}/{CDI_CLASS}", "devices": devices}
        if common and common.to_dict():
            spec["containerEdits"] = common.to_dict()
        write_json_atomic(self.spec_path(claim_uid), json.dumps(spec))
        return [qualified_device_id(d["name"]) for d in devices]

    def list_claim_uids(self) -> list[str]:
        """The claim uids that have a spec file: the reconcile sweep's
        inventory of the CDI layer."""
        prefix = f"{CDI_VENDOR}-{CDI_CLASS}_"
        try:
            names = os.listdir(self._root)
        except FileNotFoundError:
            return []
        return [name[len(prefix):-len(".json")] for name in names
                if name.startswith(prefix) and name.endswith(".json")]

    def delete_claim_spec_file(self, claim_uid: str) -> None:
        try:
            os.unlink(self.spec_path(claim_uid))
        except FileNotFoundError:
            pass

    def spec_exists(self, claim_uid: str) -> bool:
        return os.path.exists(self.spec_path(claim_uid))

    def read_spec(self, claim_uid: str) -> dict | None:
        """The spec, None when absent; ValueError when it is not JSON (a
        truncated spec)."""
        try:
            with open(self.spec_path(claim_uid), encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except json.JSONDecodeError as e:
            raise ValueError(f"corrupt CDI spec for {claim_uid}: {e}") from e
