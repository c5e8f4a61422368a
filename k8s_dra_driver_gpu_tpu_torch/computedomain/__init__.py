"""The ComputeDomain stack (the JAX package's ``computedomain/``; the
upstream driver's ``cmd/compute-domain-{controller,daemon,kubelet-plugin}``).

A ComputeDomain names a gang of nodes that one multi-node job runs on.
The controller (``controller``) gives each domain a finalizer, a
DaemonSet of daemons and two ResourceClaimTemplates, and aggregates the
daemons' registrations into the domain's status. A workload's channel
claim labels its node, which schedules the domain's daemon there; the
daemon (``daemon``) registers in its clique, runs the rendezvous service
and writes ``bootstrap.json`` and ``members.json`` into the domain's
directory. The plugin (``plugin``) prepares the channel claim once the
domain is Ready: its CDI spec carries the gang's ``TPU_*`` env (the
coordinator, this node's process id, the process count) and mounts the
domain's directory, which is what ``train.main``, ``train.verify`` and
``entry.dryrun_multichip_multiprocess`` read. No IMEX daemon runs: the
port's workload needs only that env and those files.

The names are the JAX package's where a claim or an object carries them
(the CRD group, the node label, the finalizer, the ``TPU_*`` and
``MEGASCALE_*`` env), so one domain means the same to both stacks; the
driver's own name and device classes are the upstream's, as the GPU
plugin's are. Standard library only.
"""

import math

COMPUTE_DOMAIN_DRIVER_NAME = "compute-domain.nvidia.com"
CHANNEL_DEVICE_CLASS = "compute-domain-default-channel.nvidia.com"
DAEMON_DEVICE_CLASS = "compute-domain-daemon.nvidia.com"
# The CDI kind of the plugin's per-claim specs. It must differ from the
# GPU plugin's ("nvidia.com/gpu"): each plugin's reconcile sweep takes the
# specs of its kind in the CDI root for its own.
CDI_VENDOR = "k8s.compute-domain.nvidia.com"
CDI_CLASS = "claim"
NODE_LABEL = "resource.tpu.dra/computeDomain"
CLIQUE_POD_LABEL = "resource.tpu.dra/cliqueId"
FINALIZER = "resource.tpu.dra/computedomain-finalizer"
# The daemon's rendezvous service (STATUS / MEMBERS / WAIT).
DOMAIN_DAEMON_PORT = 7077
# The gang's coordinator, bound by the workload's process 0 (the store of
# its ``init_process_group``), not by the daemon; the reference's name
# and port.
JAX_COORDINATOR_PORT = 8476
# Slice 0's worker 0 hosts the cross-slice coordinator on this port.
MEGASCALE_PORT = 8080
API_GROUP = "resource.tpu.dra"
API_VERSION = "v1beta1"

# The daemon of clique index i: its stable DNS name (upstream
# compute-domain-daemon-%04d, dnsnames.go:36-37).
DAEMON_DNS_PATTERN = "compute-domain-daemon-{index:04d}"
# The keys of the bootstrap.json the daemon writes into the domain dir.
BOOTSTRAP_KEYS = ("coordinatorAddress", "numProcesses", "processId",
                  "workerHostnames")


def daemon_dns_name(index: int, cd_uid: str = "") -> str:
    base = DAEMON_DNS_PATTERN.format(index=index)
    return f"{base}.{cd_uid}" if cd_uid else base


def expected_slices(cd_spec: dict) -> int:
    """The slices a domain spans (``spec.numSlices``, default 1): its
    nodes split evenly over them, one clique a slice."""
    return max(1, int(cd_spec.get("numSlices", 1) or 1))


def per_slice_workers(cd_spec: dict) -> int:
    """Nodes a slice (a clique). ValueError when ``numNodes`` does not
    split evenly over ``numSlices``; the channel and daemon prepares both
    ask here, so they cannot disagree on the split."""
    total = expected_workers(cd_spec)
    slices = expected_slices(cd_spec)
    if total % slices:
        raise ValueError(
            f"numNodes={total} does not split evenly over "
            f"numSlices={slices}")
    return total // slices


def expected_workers(cd_spec: dict) -> int:
    """The nodes a domain spans: ``numNodes``, else its ``topology``'s
    chips over ``chipsPerHost`` (default 4), else 1. The controller's
    Ready threshold and the daemons' ``COMPUTE_DOMAIN_NUM_WORKERS`` both
    come from here."""
    if cd_spec.get("numNodes"):
        return cd_spec["numNodes"]
    topology = cd_spec.get("topology", "")
    if topology:
        chips = math.prod(int(d) for d in topology.split("x"))
        per_host = cd_spec.get("chipsPerHost", 4)
        return max(1, math.ceil(chips / per_host))
    return 1
