"""Sharing managers: time-slicing and MPS (the JAX package's
``kubeletplugin/sharing.py``; the upstream driver's
``cmd/gpu-kubelet-plugin/sharing.go``: ``TimeSlicingManager`` sets a
GPU's compute timeslice through ``nvidia-smi`` (:135), ``MpsManager``
runs an MPS control daemon per claim and points the workload at its
pipe directory through CDI edits (:214-379)).

- ``TimeSlicingManager`` keeps the JAX plugin's holder-counted record a
  GPU, ``<root>/timeslice/gpu-<index>.json`` with ``interval`` (the last
  setter's) and ``holders`` (claim uid -> interval), and gone with the
  last holder. The GPU's effective level is the record's interval while
  a holder asks for a non-default one, else Default; ``nvidia-smi
  compute-policy -i <index> --set-timeslice=<level>`` runs only when it
  changes. A claim at the Default interval writes its record and starts
  no process.
- ``MultiTenancyManager`` starts one ``nvidia-cuda-mps-control -d`` a
  claim request, under ``<root>/mps/<hash>/``: ``claim.json`` (the JAX
  manifest's ``chips``, ``maxClients``, ``hbmCapacityBytes`` and
  ``hbmLimits``, the owner and the daemon's settings) and the daemon's
  claim-private ``pipe/`` and ``log/`` directories. The daemon sees the
  request's GPUs (``CUDA_VISIBLE_DEVICES`` by index, in PCI bus order)
  and gets ``set_default_device_pinned_mem_limit`` for each GPU with a
  memory limit; prepare waits until it answers a control command. The
  request's containers get ``CUDA_MPS_PIPE_DIRECTORY`` and the pipe
  directory mounted read-write at that path, and
  ``CUDA_MPS_PINNED_DEVICE_MEM_LIMIT`` in the daemon's numbering (the
  request's GPUs by index, from 0), which is what its clients see.
- An oversubscribed tenant partition (``pkg/partition``) has one MPS
  control daemon for its MIG instance, not one a claim: two servers
  over one MIG instance would contend. ``start_partition`` starts it
  with ``CUDA_VISIBLE_DEVICES=<the instance's MIG-… UUID>`` at the first
  tenant's attach (a running one is kept), under
  ``<root>/mps/<sha256("partition/" + device)[:12]>/``, its default
  pinned memory limit the tenant budget; each tenant's edits carry its
  pipe directory and ``CUDA_MPS_PINNED_DEVICE_MEM_LIMIT=0=<budget>M``
  (device 0 in the daemon's numbering). ``stop_partition`` quits it at
  the partition's teardown; so its life follows the partition's derived
  holder count, and the JAX plugin's per-slot tenancy ceiling
  (``_apply_oversubscription``) is the instance's MPS limit.
- An MPS request on one MIG device (``start_mig``) gets the same daemon,
  keyed by the MIG device's name, its limit the claim's ``hbmLimit`` (the
  instance's memory without one) and its ``maxClients`` recorded; the
  claim's unprepare quits it (``stop_partition``). One daemon sees one
  MIG instance, so such a request holds one device.
- **Tenancy agents** (with ``spawn_agents``, the plugin's production
  default, ``device_state.Config.tenancy_agents``): each MPS request, and
  each oversubscribed partition tenant's request, gets one supervised
  agent process (``tenancy_agent.py``, under
  ``computedomain.daemon.process.ProcessManager``) that admits the
  request's containers, started after the daemon answers; prepare
  returns once the agent answers ``READY``. Its directory is
  ``<root>/tenancy/<sha256(uid/request)[:12]>/`` (``tenancy.json``: the
  owner, ``chips``, ``maxClients``, ``hbmCapacityBytes`` (the GPU's
  memory), ``hbmLimits``; ``clients.json``, ``released.d/``,
  ``agent.pid``, ``agent.sock``). The request's edits carry the native
  preflight hook (``native_hook.py``, copied to ``<root>/bin/``) as a
  ``createContainer`` hook (``--dir <agent dir> --hbm-bytes <the
  smallest limit of the request's devices, 0 without one>``) and a
  ``poststop`` hook (``--release``). The agents die with the plugin (their
  parent-death signal); construction re-owns those of active claims
  (``reconcile``) and drops the other directories; ``stop`` stops a
  claim's agents before its daemons quit.

What differs from the JAX plugin, on an H100 host:

- **The GPU's driver enforces both.** The JAX plugin's env contract
  (``TPU_TIMESLICE_INTERVAL_US``, ``TPU_PROCESS_SHARING``,
  ``TPU_MULTI_TENANT``, ``TPU_TENANCY_DIR``, ``TPU_MAX_TENANTS``, the
  group's minimum ``TPU_HBM_LIMIT_BYTES``) is gone: the timeslice is the
  GPU's own, and MPS caps each device's memory by itself, so the limits
  are per device.
- **Memory limits in whole MiB.** MPS pins device memory in MiB
  (``set_default_device_pinned_mem_limit``, ``CUDA_MPS_PINNED_DEVICE_
  MEM_LIMIT``), while the JAX plugin hands its limit on in bytes. A limit
  that is zero or not a whole number of MiB (``"1000000"``, ``"0"``,
  ``"1572865"``) is refused at prepare, naming the request and the value,
  with nothing left behind: rounding it would enforce another limit than
  the claim records and the user asked for. ``"8Gi"`` and ``"512Mi"``
  pass as they are.
- **The client cap is the agent's.** MPS caps each client's memory but
  neither how many clients there are nor their sum: the tenancy agent
  refuses the container whose ``REGISTER`` would pass ``maxClients`` or
  push the request's registered memory past the GPU's, and the native
  hook makes the runtime refuse its start. An agent that cannot be
  reached fails admission closed. Without agents (``Config.mock``, a
  plugin run with ``tenancy_agents=False``) ``maxClients`` is recorded
  in ``claim.json`` only.
- **The agent's control plane is outside every mount.** A container gets
  the daemon's ``pipe/`` only; the agent's socket, grants and tombstones
  lie under ``<root>/tenancy/``, so a tenant cannot ``RELEASE`` a
  sibling (the protocol is unauthenticated).
- **A partition tenant's agent budgets against the whole GPU.** Its
  manifest's ``hbmCapacityBytes`` is the GPU's memory, not its MIG
  instance's, its limit the tenant budget and ``maxClients`` unset, as
  the JAX plugin's ``_apply_oversubscription`` writes it; the instance's
  MPS daemon caps each tenant at the budget.
- **The daemons outlive the plugin**, as the upstream's daemon
  Deployment does: a dead control daemon kills its clients, so the
  plugin's restart re-owns the live ones (``reconcile``) and only
  ``stop`` (unprepare) quits them.
- **Short pipe paths.** A request's directory is named by a hash of its
  claim uid and request name, so ``<root>/mps/<hash>/pipe/control``
  is ``len(root) + 31`` bytes whatever the names: AF_UNIX paths end at
  108. The default ``/tmp/nvidia-mps`` is never used: a leftover daemon
  there would capture every CUDA process of the node. An agent's socket
  is ``len(root) + 32`` bytes; a root too long for it fails the
  manager's construction, naming it (the JAX plugin's short symlinks are
  not needed).
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

from ..api.configs import MultiTenancyConfig, TimeSlicingConfig
from ..computedomain.daemon.process import ProcessManager, kill_recorded
from ..pkg.flock import Flock
from ..pkg.fsutil import write_json_atomic
from . import native_hook
from .cdi import ContainerEdits
from .tenancy_agent import MANIFEST_NAME, SOCKET_NAME, query

logger = logging.getLogger(__name__)

LOCK_TIMEOUT_S = 10.0
# nvidia-smi compute-policy --set-timeslice values (the upstream's
# Interval.Int()).
TIMESLICE_LEVELS = {"Default": 0, "Short": 1, "Medium": 2, "Long": 3}
MPS_CONTROL = "nvidia-cuda-mps-control"
MPS_SERVER = "nvidia-cuda-mps-server"
# Where a container finds its claim's pipe directory.
MPS_CONTAINER_ROOT = "/var/run/nvidia-mps"
MIB = 1 << 20
AGENT_MODULE = "k8s_dra_driver_gpu_tpu_torch.kubeletplugin.tenancy_agent"
# The directory that holds the package, which the agent imports from.
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# The longest AF_UNIX path: sun_path holds 108 bytes with its NUL.
SUN_PATH_MAX = 107


class SharingError(RuntimeError):
    """nvidia-smi or the MPS control daemon refused or failed."""


class TenancyAgentError(SharingError):
    """A tenancy agent did not answer, or its hook could not be built."""


def _run(argv: list[str], stdin: str | None = None,
         env: dict | None = None, timeout: float = 30.0
         ) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(argv, input=stdin, env=env, text=True,
                              capture_output=True, timeout=timeout,
                              check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SharingError(f"{' '.join(argv)}: {e}") from e


class TimeSlicingManager:
    """The compute timeslice of each GPU, holder-counted across claims."""

    def __init__(self, policy_root: str, nvidia_smi: str | None):
        self._root = os.path.join(policy_root, "timeslice")
        os.makedirs(self._root, exist_ok=True)
        self._lock = Flock(os.path.join(policy_root, "timeslice.lock"))
        self._smi = nvidia_smi

    def _path(self, index: int) -> str:
        return os.path.join(self._root, f"gpu-{index}.json")

    def _load(self, index: int) -> dict | None:
        try:
            with open(self._path(index), encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def _store(self, index: int, doc: dict | None) -> None:
        if doc is not None:
            write_json_atomic(self._path(index), json.dumps(doc))
            return
        try:
            os.unlink(self._path(index))
        except FileNotFoundError:
            pass

    @staticmethod
    def level(doc: dict | None) -> int:
        """The level a record asks of its GPU: its interval's while a
        holder asks for a non-default interval, else Default's."""
        if not doc or all(v == "Default" for v in doc["holders"].values()):
            return 0
        return TIMESLICE_LEVELS[doc["interval"]]

    def _set_level(self, index: int, level: int) -> None:
        if self._smi is None:
            raise SharingError("nvidia-smi not found: cannot set the "
                               f"timeslice of GPU {index}")
        argv = [self._smi, "compute-policy", "-i", str(index),
                f"--set-timeslice={level}"]
        out = _run(argv)
        if out.returncode != 0:
            raise SharingError(
                f"{' '.join(argv)} exited {out.returncode}: "
                f"{(out.stdout + out.stderr).strip()}")
        logger.info("GPU %d: timeslice level %d", index, level)

    def set_time_slice(self, claim_uid: str, gpu_indices: list[int],
                       cfg: TimeSlicingConfig) -> ContainerEdits:
        """Hold ``cfg.interval`` on each GPU for the claim (the last
        setter's interval wins). A GPU that nvidia-smi refuses raises
        ``SharingError`` with the GPUs of this call restored."""
        with self._lock.acquire(timeout=LOCK_TIMEOUT_S):
            done: list[tuple[int, dict | None, int, int]] = []
            try:
                for index in gpu_indices:
                    old = self._load(index)
                    doc = copy.deepcopy(old) if old else {"holders": {}}
                    doc["interval"] = cfg.interval
                    doc["holders"][claim_uid] = cfg.interval
                    before, after = self.level(old), self.level(doc)
                    if after != before:
                        self._set_level(index, after)
                    done.append((index, old, before, after))
                    self._store(index, doc)
            except BaseException:
                for index, old, before, after in reversed(done):
                    try:
                        if after != before:
                            self._set_level(index, before)
                    except SharingError:
                        logger.exception("GPU %d: timeslice not restored",
                                         index)
                    self._store(index, old)
                raise
        return ContainerEdits()

    def release(self, claim_uid: str, gpu_indices: list[int]) -> None:
        """Drop the claim's hold; a GPU's record goes with its last
        holder, and its level returns to Default with its last holder of
        a non-default interval. A refused reset is logged, not raised:
        unprepare and rollbacks go on."""
        with self._lock.acquire(timeout=LOCK_TIMEOUT_S):
            for index in gpu_indices:
                doc = self._load(index)
                if doc is None or claim_uid not in doc["holders"]:
                    continue
                before = self.level(doc)
                del doc["holders"][claim_uid]
                after = self.level(doc)
                if after != before:
                    try:
                        self._set_level(index, after)
                    except SharingError:
                        logger.exception("GPU %d: timeslice not reset",
                                         index)
                self._store(index, doc if doc["holders"] else None)

    def current(self, index: int) -> dict | None:
        return self._load(index)


def _whole_mib_limits(cfg: MultiTenancyConfig, device_names: list[str]
                      ) -> dict[str, int | None]:
    """Each device's memory limit in bytes (None: none set); a limit
    that is not a positive whole number of MiB is refused."""
    limits = {name: cfg.hbm_limit_bytes_for(name) for name in device_names}
    for name, limit in limits.items():
        if limit is not None and (limit <= 0 or limit % MIB):
            given = cfg.per_device_hbm_limits.get(
                name, cfg.per_device_hbm_limits.get("*"))
            raise SharingError(
                f"hbmLimit {given!r} of {name} is {limit} bytes: MPS pins "
                "device memory in whole MiB, so a limit must be a positive "
                "whole number of MiB")
    return limits


def _proc_argv(pid: str) -> list[str]:
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return [a.decode(errors="replace") for a in f.read().split(b"\0")]


def mps_pids(pipe_dir: str | None = None) -> list[int]:
    """The pids of MPS control daemons and servers (an argv[0] or argv[1]
    named ``nvidia-cuda-mps-*``), only those started with
    ``CUDA_MPS_PIPE_DIRECTORY=pipe_dir`` when it is given."""
    want = None if pipe_dir is None else (
        f"CUDA_MPS_PIPE_DIRECTORY={pipe_dir}".encode())
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            argv = _proc_argv(pid)
            if not any(os.path.basename(a).startswith("nvidia-cuda-mps-")
                       for a in argv[:2]):
                continue
            if want is not None:
                with open(f"/proc/{pid}/environ", "rb") as f:
                    if want not in f.read().split(b"\0"):
                        continue
        except OSError:
            continue
        pids.append(int(pid))
    return sorted(pids)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat", encoding="utf-8") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


class MultiTenancyManager:
    """One MPS control daemon a claim request (the upstream's
    ``MpsControlDaemon``)."""

    def __init__(self, tenancy_root: str, hbm_capacity_bytes: int | None,
                 control_binary: str | None, timeout: float = 10.0,
                 spawn_agents: bool = False):
        """``timeout``: how long a daemon or an agent may take to answer
        after its start, and a daemon to exit after ``quit``.
        ``spawn_agents``: give each request a tenancy agent and the
        preflight hooks; ValueError when the agents' sockets would not
        fit AF_UNIX's paths under ``tenancy_root``."""
        self._root = os.path.join(tenancy_root, "mps")
        os.makedirs(self._root, exist_ok=True)
        self._capacity = hbm_capacity_bytes
        self._control = control_binary
        self._timeout = timeout
        self._spawn = spawn_agents
        self._agent_root = os.path.join(os.path.abspath(tenancy_root),
                                        "tenancy")
        self._bin_dir = os.path.join(os.path.abspath(tenancy_root), "bin")
        # agent directory -> (its claim's uid, its supervisor)
        self._agents: dict[str, tuple[str, ProcessManager]] = {}
        self._agents_lock = threading.Lock()
        if spawn_agents:
            sock = os.path.join(self._agent_root, "0" * 12, SOCKET_NAME)
            if len(sock.encode()) > SUN_PATH_MAX:
                raise ValueError(
                    f"state root {tenancy_root!r} is too long for the "
                    f"tenancy agents' sockets: {sock} is "
                    f"{len(sock.encode())} bytes, AF_UNIX takes "
                    f"{SUN_PATH_MAX}")
            os.makedirs(self._agent_root, exist_ok=True)

    @staticmethod
    def dir_name(claim_uid: str, request: str) -> str:
        return hashlib.sha256(
            f"{claim_uid}/{request}".encode()).hexdigest()[:12]

    def _dir(self, claim_uid: str, request: str) -> str:
        return os.path.join(self._root, self.dir_name(claim_uid, request))

    @staticmethod
    def pipe_dir(d: str) -> str:
        return os.path.join(d, "pipe")

    def _owners(self) -> dict[str, dict | None]:
        """Each request directory -> its ``claim.json`` (None when it is
        missing or unreadable: a start that crashed before writing it)."""
        out: dict[str, dict | None] = {}
        for name in sorted(os.listdir(self._root)):
            d = os.path.join(self._root, name)
            try:
                with open(os.path.join(d, "claim.json"),
                          encoding="utf-8") as f:
                    out[d] = json.load(f)
            except (OSError, ValueError):
                out[d] = None
        return out

    def _dirs_of(self, claim_uid: str) -> list[str]:
        return [d for d, owner in self._owners().items()
                if owner is not None and owner.get("claim") == claim_uid]

    def _daemon_env(self, d: str, visible: str) -> dict:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("CUDA_MPS_")}
        env.update(CUDA_MPS_PIPE_DIRECTORY=self.pipe_dir(d),
                   CUDA_MPS_LOG_DIRECTORY=os.path.join(d, "log"),
                   CUDA_VISIBLE_DEVICES=visible,
                   CUDA_DEVICE_ORDER="PCI_BUS_ID")
        return env

    def _command(self, d: str, command: str, timeout: float = 5.0
                 ) -> subprocess.CompletedProcess:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("CUDA_MPS_")}
        env["CUDA_MPS_PIPE_DIRECTORY"] = self.pipe_dir(d)
        return _run([self._control], stdin=command + "\n", env=env,
                    timeout=timeout)

    def command(self, claim_uid: str, request: str, command: str) -> str:
        """One control command to the request's daemon; its output."""
        out = self._command(self._dir(claim_uid, request), command)
        if out.returncode != 0:
            raise SharingError(f"{command!r} exited {out.returncode}: "
                               f"{(out.stdout + out.stderr).strip()}")
        return out.stdout

    def start(self, claim_uid: str, request: str, gpu_indices: list[int],
              cfg: MultiTenancyConfig, device_names: list[str]
              ) -> ContainerEdits:
        """Write the request's manifest, start its daemon and wait until
        it answers; the edits of the request's containers.
        ``device_names`` name ``gpu_indices`` one for one."""
        if self._control is None:
            raise SharingError(f"{MPS_CONTROL} not found: MPS is not "
                               "available on this node")
        limits = _whole_mib_limits(cfg, device_names)
        d = self._dir(claim_uid, request)
        os.makedirs(self.pipe_dir(d), exist_ok=True)
        os.makedirs(os.path.join(d, "log"), exist_ok=True)
        # The daemon's numbering: the request's GPUs by index, from 0.
        by_index = sorted(zip(gpu_indices, device_names))
        pinned = {str(ordinal): f"{limits[name] // MIB}M"
                  for ordinal, (_, name) in enumerate(by_index)
                  if limits[name] is not None}
        owner = {"claim": claim_uid, "request": request,
                 "chips": list(gpu_indices), "maxClients": cfg.max_clients,
                 "hbmCapacityBytes": self._capacity, "hbmLimits": limits,
                 "visibleDevices": ",".join(str(i) for i, _ in by_index),
                 "pinnedMemLimits": pinned}
        write_json_atomic(os.path.join(d, "claim.json"), json.dumps(owner))
        self._ensure_daemon(d, owner)
        container = f"{MPS_CONTAINER_ROOT}/{os.path.basename(d)}"
        env = [f"CUDA_MPS_PIPE_DIRECTORY={container}"]
        if pinned:
            env.append("CUDA_MPS_PINNED_DEVICE_MEM_LIMIT=" + ",".join(
                f"{ordinal}={limit}" for ordinal, limit in pinned.items()))
        edits = ContainerEdits(env=env,
                               mounts=[(self.pipe_dir(d), container, False)])
        return edits.merge(self._admission(
            claim_uid, request, list(gpu_indices), cfg.max_clients, limits))

    def _ensure_daemon(self, d: str, owner: dict) -> None:
        """Start the directory's daemon unless it runs, wait until it
        answers, and give it its memory limits."""
        pipe = self.pipe_dir(d)
        if not mps_pids(pipe):
            # A dead daemon's sockets would stop a new one binding.
            for name in os.listdir(pipe):
                os.unlink(os.path.join(pipe, name))
            out = _run([self._control, "-d"],
                       env=self._daemon_env(d, owner["visibleDevices"]))
            if out.returncode != 0:
                raise SharingError(
                    f"{MPS_CONTROL} -d exited {out.returncode}: "
                    f"{(out.stdout + out.stderr).strip()}")
        deadline = time.monotonic() + self._timeout
        while True:
            out = self._command(d, "get_default_active_thread_percentage")
            if out.returncode == 0:
                break
            if time.monotonic() > deadline:
                raise SharingError(
                    f"MPS control daemon of {d} not ready after "
                    f"{self._timeout} s: "
                    f"{(out.stdout + out.stderr).strip()}")
            time.sleep(0.05)
        for ordinal, limit in owner["pinnedMemLimits"].items():
            command = f"set_default_device_pinned_mem_limit {ordinal} {limit}"
            out = self._command(d, command)
            if out.returncode != 0:
                raise SharingError(
                    f"{command!r} exited {out.returncode}: "
                    f"{(out.stdout + out.stderr).strip()}")

    def _quit(self, d: str) -> None:
        """Quit the directory's daemon and wait for it and its servers to
        exit; what outlives the timeout is killed."""
        pids = mps_pids(self.pipe_dir(d))
        if not pids:
            return
        self._command(d, "quit")
        deadline = time.monotonic() + self._timeout
        while any(map(_alive, pids)) and time.monotonic() < deadline:
            time.sleep(0.05)
        for pid in filter(_alive, pids):
            logger.warning("MPS process %d of %s did not quit: killed",
                           pid, d)
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass

    def stop(self, claim_uid: str) -> None:
        """Stop the claim's agents, then quit its daemons; their
        directories go."""
        self.stop_agents(claim_uid)
        for d in self._dirs_of(claim_uid):
            self._quit(d)
            shutil.rmtree(d, ignore_errors=True)

    def reconcile(self, active_claim_uids: set[str],
                  active_partitions: set[str] = frozenset()) -> None:
        """Plugin start: stop the agents and quit the daemons of
        directories no active claim or partition owns and remove them;
        start again the agent of an active claim request (with agents
        on) and the dead daemon of an active one (a live daemon is left
        alone). One that does not start is logged: its claim's
        unprepare, or its partition's next attach, deals with it."""
        for d, owner in self._agent_owners().items():
            if owner is None or owner.get("claim") not in active_claim_uids:
                self._drop_agent(d)
            elif self._spawn:
                try:
                    self._ensure_agent(d, owner["claim"])
                except TenancyAgentError:
                    logger.exception("could not re-own the tenancy agent "
                                     "of %s", d)
        for d, owner in self._owners().items():
            if owner is None or (
                    owner.get("claim") not in active_claim_uids
                    if "partition" not in owner
                    else owner["partition"] not in active_partitions):
                self._quit(d)
                shutil.rmtree(d, ignore_errors=True)
                continue
            if mps_pids(self.pipe_dir(d)):
                continue
            try:
                self._ensure_daemon(d, owner)
            except SharingError:
                logger.exception("could not re-own the MPS daemon of %s", d)

    def active(self, claim_uid: str) -> bool:
        """Whether an agent or a daemon of the claim runs."""
        with self._agents_lock:
            agents = [pm for uid, pm in self._agents.values()
                      if uid == claim_uid]
        return any(pm.alive() for pm in agents) or any(
            mps_pids(self.pipe_dir(d)) for d in self._dirs_of(claim_uid))

    # -- the tenancy agents ------------------------------------------------

    def agent_dir(self, claim_uid: str, request: str) -> str:
        """The agent directory of a claim request."""
        return os.path.join(self._agent_root,
                            self.dir_name(claim_uid, request))

    def _agent_owners(self) -> dict[str, dict | None]:
        """Each agent directory -> its manifest (None when it is missing
        or unreadable: a start that crashed before writing it)."""
        out: dict[str, dict | None] = {}
        if not os.path.isdir(self._agent_root):
            return out
        for name in sorted(os.listdir(self._agent_root)):
            d = os.path.join(self._agent_root, name)
            try:
                with open(os.path.join(d, MANIFEST_NAME),
                          encoding="utf-8") as f:
                    out[d] = json.load(f)
            except (OSError, ValueError):
                out[d] = None
        return out

    @staticmethod
    def _agent_identity(d: str) -> list[str]:
        """The argv prefix of ``d``'s agent under any supervisor."""
        return [sys.executable, "-m", AGENT_MODULE, "--dir", d]

    def _admission(self, claim_uid: str, request: str, chips: list[int],
                   max_clients: int | None, limits: dict[str, int | None]
                   ) -> ContainerEdits:
        """With agents on: write the request's agent manifest, start its
        agent and wait until it answers READY; the request's
        ``createContainer`` and ``poststop`` hooks. Without: no edits."""
        if not self._spawn:
            return ContainerEdits()
        try:
            hook = native_hook.install(self._bin_dir)
        except native_hook.HookBuildError as e:
            raise TenancyAgentError(str(e)) from e
        d = self.agent_dir(claim_uid, request)
        os.makedirs(d, exist_ok=True)
        write_json_atomic(os.path.join(d, MANIFEST_NAME), json.dumps({
            "claim": claim_uid, "request": request, "chips": chips,
            "maxClients": max_clients, "hbmCapacityBytes": self._capacity,
            "hbmLimits": limits}))
        self._ensure_agent(d, claim_uid)
        budget = min((v for v in limits.values() if v is not None),
                     default=0)
        base = [hook, "--dir", d]
        return ContainerEdits(hooks=[
            ("createContainer", hook, base + ["--hbm-bytes", str(budget)]),
            ("poststop", hook, base + ["--release"])])

    def _ensure_agent(self, d: str, claim_uid: str) -> None:
        """Start ``d``'s agent unless it runs (a stale one recorded in
        its pidfile is killed first), with its watchdog on, and wait
        until it answers READY."""
        with self._agents_lock:
            entry = self._agents.get(d)
            if entry is None:
                env = dict(os.environ)
                env["PYTHONPATH"] = os.pathsep.join(
                    p for p in (PACKAGE_PARENT, env.get("PYTHONPATH")) if p)
                identity = self._agent_identity(d)
                entry = self._agents[d] = (claim_uid, ProcessManager(
                    identity + ["--parent-pid", str(os.getpid())], env=env,
                    pidfile=os.path.join(d, "agent.pid"), identity=identity))
        pm = entry[1]
        try:
            pm.ensure_started()
        except OSError as e:
            raise TenancyAgentError(f"tenancy agent of {d}: {e}") from e
        pm.start_watchdog()
        deadline = time.monotonic() + self._timeout
        while True:
            try:
                if query(d, "STATUS", timeout=1.0) == "READY":
                    return
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise TenancyAgentError(f"tenancy agent of {d} not ready "
                                        f"after {self._timeout} s")
            time.sleep(0.01)

    def _drop_agent(self, d: str, pm: ProcessManager | None = None) -> None:
        """Stop ``d``'s agent (through ``pm``, else the one its pidfile
        names) and remove the directory."""
        if pm is not None:
            pm.stop()
        else:
            kill_recorded(os.path.join(d, "agent.pid"),
                          self._agent_identity(d))
        shutil.rmtree(d, ignore_errors=True)

    def stop_agents(self, claim_uid: str) -> None:
        """Stop the claim's agents and remove their directories."""
        with self._agents_lock:
            mine: dict[str, ProcessManager | None] = {
                d: pm for d, (uid, pm) in self._agents.items()
                if uid == claim_uid}
            for d in mine:
                del self._agents[d]
        for d, owner in self._agent_owners().items():
            if owner is not None and owner.get("claim") == claim_uid:
                mine.setdefault(d, None)
        for d, pm in mine.items():
            self._drop_agent(d, pm)

    def agent_count(self) -> int:
        with self._agents_lock:
            return len(self._agents)

    def shutdown(self) -> None:
        """Stop every agent (the plugin's stop). Their directories stay:
        the next plugin's ``reconcile`` re-owns them."""
        with self._agents_lock:
            agents = [pm for _, pm in self._agents.values()]
            self._agents.clear()
        for pm in agents:
            pm.stop()

    def start_tenant_agent(self, claim_uid: str, request: str, gpu: int,
                           device: str, limit_bytes: int) -> ContainerEdits:
        """The agent and hooks of an oversubscribed partition tenant's
        request (the JAX plugin's ``_apply_oversubscription``): no client
        cap, its limit the tenant budget, and its capacity the whole
        GPU's memory, not the MIG instance's, as the JAX plugin budgets
        it. No edits without agents."""
        return self._admission(claim_uid, request, [gpu], None,
                               {device: limit_bytes})

    # -- the daemon of an oversubscribed partition ----------------------

    def _partition_dir(self, device: str) -> str:
        return os.path.join(self._root, hashlib.sha256(
            f"partition/{device}".encode()).hexdigest()[:12])

    def start_partition(self, device: str, gpu: int, mig_uuid: str,
                        capacity_bytes: int, limit_bytes: int,
                        max_tenants: int) -> ContainerEdits:
        """Start (or keep) the MPS daemon of partition ``device`` over
        its MIG instance ``mig_uuid``, each client capped at
        ``limit_bytes``; a tenant's edits."""
        if self._control is None:
            raise SharingError(f"{MPS_CONTROL} not found: MPS is not "
                               "available on this node")
        if limit_bytes <= 0 or limit_bytes % MIB:
            raise SharingError(
                f"partition {device}: tenant budget {limit_bytes} bytes: "
                "MPS pins device memory in whole MiB")
        d = self._partition_dir(device)
        os.makedirs(self.pipe_dir(d), exist_ok=True)
        os.makedirs(os.path.join(d, "log"), exist_ok=True)
        limit = f"{limit_bytes // MIB}M"
        owner = {"partition": device, "chips": [gpu],
                 "maxClients": max_tenants,
                 "hbmCapacityBytes": capacity_bytes,
                 "hbmLimits": {device: limit_bytes},
                 "visibleDevices": mig_uuid, "pinnedMemLimits": {"0": limit}}
        if not mps_pids(self.pipe_dir(d)):
            # The first tenant's; a co-tenant's finds it running.
            write_json_atomic(os.path.join(d, "claim.json"),
                              json.dumps(owner))
            self._ensure_daemon(d, owner)
        container = f"{MPS_CONTAINER_ROOT}/{os.path.basename(d)}"
        return ContainerEdits(
            env=[f"CUDA_MPS_PIPE_DIRECTORY={container}",
                 f"CUDA_MPS_PINNED_DEVICE_MEM_LIMIT=0={limit}"],
            mounts=[(self.pipe_dir(d), container, False)])

    def start_mig(self, claim_uid: str, request: str, gpu: int,
                  device: str, mig_uuid: str, capacity_bytes: int,
                  cfg: MultiTenancyConfig) -> ContainerEdits:
        """MPS on one MIG device (the JAX plugin's multi-tenancy on a
        sub-slice): the daemon of ``start_partition`` over the device's
        MIG UUID, each client capped at the claim's ``hbmLimit`` (the
        instance's memory without one); with agents on, the request's
        agent and hooks. ``stop_partition(device)`` quits it."""
        limit = _whole_mib_limits(cfg, [device])[device]
        edits = self.start_partition(
            device, gpu, mig_uuid, capacity_bytes,
            limit if limit is not None else capacity_bytes // MIB * MIB,
            cfg.max_clients)
        return edits.merge(self._admission(claim_uid, request, [gpu],
                                           cfg.max_clients, {device: limit}))

    def stop_partition(self, device: str) -> None:
        """Quit the partition's daemon and remove its directory."""
        d = self._partition_dir(device)
        if os.path.isdir(d):
            self._quit(d)
            shutil.rmtree(d, ignore_errors=True)

    def partition_active(self, device: str) -> bool:
        """Whether the partition's daemon runs."""
        return bool(mps_pids(self.pipe_dir(self._partition_dir(device))))
