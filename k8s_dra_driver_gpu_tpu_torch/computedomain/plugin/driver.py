"""The ComputeDomain plugin's node service (the JAX package's
``computedomain/plugin/driver.py``; upstream
``cmd/compute-domain-kubelet-plugin/driver.go:40-233``).

A channel prepare depends on others: it succeeds only once the domain's
daemon on this node is Ready, and that daemon exists only because the
first try labeled the node. So each claim's prepare is retried with
backoff (``RETRY_LIMITER``) within a budget, ``retry_timeout`` (the
upstream's ErrorRetryMaxTimeout, 45 s), which is the gang's deadline. A
``RetryableError``, a claim not visible yet (404), a connection error
and a status of ``RETRIABLE_STATUSES`` are retried; a
``PermanentError`` and any other 4xx fail at once. When the budget runs
out, ``_abort_gang_prepare`` unwinds the node's half-prepared state
(``CDDeviceState.unwind_failed_prepare``), emits one
``GangPrepareAborted`` Warning Event on the claim, and the prepare
fails as retriable, so the kubelet tries again from a clean node.

The callbacks are driven by direct calls (no gRPC yet, ROADMAP.md §1b
item 8). ``publish_resources`` publishes the node's devices through
``pkg/sliceutil.py``; ``start_background`` runs the stale domain-dir GC
and the reconcile sweep (``kubeletplugin/reconcile.CDStateReconciler``)
every ``STALE_DIR_GC_INTERVAL_S``. Not ported: the JAX driver's flight
recorder, tracing, metrics and incident bundles.
"""

from __future__ import annotations

import logging
import threading
import time

from ...kubeletplugin.claim import ResourceClaim
from ...kubeletplugin.reconcile import CDStateReconciler
from ...pkg.events import RETRIABLE_STATUSES, emit_warning_event
from ...pkg.kubeclient import KubeError, NotFoundError
from ...pkg.sliceutil import publish_resource_slices
from ...pkg.workqueue import PermanentError, RateLimiter
from .. import COMPUTE_DOMAIN_DRIVER_NAME
from .device_state import CDDeviceState, RetryableError

logger = logging.getLogger(__name__)

ERROR_RETRY_MAX_TIMEOUT_S = 45.0
RETRY_LIMITER = RateLimiter(base_delay=0.25, max_delay=3.0, jitter=0.2)
STALE_DIR_GC_INTERVAL_S = 600.0


def _ref_field(ref, key: str):
    return getattr(ref, key, None) or (
        ref.get(key) if isinstance(ref, dict) else None)


class CDDriver:
    def __init__(self, state: CDDeviceState, kube, node_name: str,
                 retry_timeout: float = ERROR_RETRY_MAX_TIMEOUT_S):
        self.state = state
        self.kube = kube
        self.node_name = node_name
        self.retry_timeout = retry_timeout
        self.gang_aborts = 0
        # The retries of the last prepare of each claim uid.
        self.retries: dict[str, int] = {}
        self._gc_stop: threading.Event | None = None
        self._gc_thread: threading.Thread | None = None
        self.reconciler = CDStateReconciler(state, kube)

    def start_background(self) -> None:
        """The stale domain-dir GC and the reconcile sweep, on a thread."""
        self._gc_stop = threading.Event()

        def loop():
            while not self._gc_stop.wait(STALE_DIR_GC_INTERVAL_S):
                try:
                    self.state.cleanup_stale_domain_dirs()
                except Exception:  # noqa: BLE001
                    logger.exception("stale domain dir GC failed")
                try:
                    self.reconciler.reconcile_once()
                except Exception:  # noqa: BLE001
                    logger.exception("CD recovery sweep failed")

        self._gc_thread = threading.Thread(target=loop, name="cd-domain-gc",
                                           daemon=True)
        self._gc_thread.start()

    def stop_background(self) -> None:
        """Stop the GC thread and the state's informer; join them."""
        if self._gc_stop is not None:
            self._gc_stop.set()
            self._gc_thread.join(timeout=5.0)
        self.state.stop()

    def _fetch_claim(self, ref) -> ResourceClaim:
        uid = _ref_field(ref, "uid")
        namespace = _ref_field(ref, "namespace")
        name = _ref_field(ref, "name")
        obj = self.kube.get("resource.k8s.io", "v1", "resourceclaims", name,
                            namespace=namespace)
        if obj.get("metadata", {}).get("uid") != uid:
            raise PermanentError(f"claim {namespace}/{name} UID mismatch")
        return ResourceClaim.from_dict(obj, driver=COMPUTE_DOMAIN_DRIVER_NAME)

    def prepare_resource_claims(self, claim_refs: list) -> dict:
        """uid -> (devices, error): error "" on success."""
        out = {}
        for ref in claim_refs:
            uid = _ref_field(ref, "uid")
            try:
                out[uid] = (self._prepare_with_retry(ref), "")
            except Exception as e:  # noqa: BLE001 - the callback's boundary
                logger.warning("prepare failed for %s: %s", uid, e)
                out[uid] = ([], str(e))
        return out

    def _prepare_with_retry(self, ref) -> list[dict]:
        uid = _ref_field(ref, "uid")
        deadline = time.monotonic() + self.retry_timeout
        failures = 0
        self.retries[uid] = 0
        while True:
            try:
                claim = self._fetch_claim(ref)
                cdi_ids = self.state.prepare(claim)
                return [{"request_names": [r.request],
                         "pool_name": self.node_name,
                         "device_name": r.device,
                         "cdi_device_ids": cdi_ids} for r in claim.results]
            except PermanentError:
                raise
            except (RetryableError, KubeError, OSError, TimeoutError) as e:
                # A permanent 4xx (403, 400, 422) must not spend the
                # budget calling itself retriable.
                if isinstance(e, KubeError) and \
                        not isinstance(e, NotFoundError) and \
                        e.status not in RETRIABLE_STATUSES:
                    raise
                failures += 1
                self.retries[uid] = failures
                delay = RETRY_LIMITER.delay_for(failures)
                if time.monotonic() + delay >= deadline:
                    self._abort_gang_prepare(uid, e, ref=ref)
                    raise TimeoutError(
                        f"gang prepare deadline ({self.retry_timeout}s) "
                        f"exceeded; node state unwound, retriable: {e}"
                    ) from e
                logger.info("prepare retry %d in %.2fs: %s", failures,
                            delay, e)
                time.sleep(delay)

    def _abort_gang_prepare(self, uid: str, cause: Exception,
                            ref=None) -> None:
        """The deadline passed: report it once on the claim and unwind
        this node's half-prepared state."""
        self.gang_aborts += 1
        logger.warning("gang prepare abort for claim %s after %.0fs: %s "
                       "(unwinding node-local state)", uid,
                       self.retry_timeout, cause)
        name = _ref_field(ref, "name") if ref is not None else ""
        if name:
            emit_warning_event(
                self.kube, event_name=f"{name}.gang-abort",
                namespace=_ref_field(ref, "namespace") or "default",
                reason="GangPrepareAborted",
                message=(f"gang prepare deadline ({self.retry_timeout:.0f}s)"
                         f" exceeded on node {self.node_name}: "
                         f"{str(cause)[:300]}; node-local state unwound, "
                         "kubelet will retry"),
                involved_kind="ResourceClaim", involved_name=name,
                involved_uid=uid, component="compute-domain-kubelet-plugin")
        try:
            self.state.unwind_failed_prepare(uid)
        except Exception:  # noqa: BLE001 - the unwind is best effort
            logger.exception("gang-abort unwind failed for %s", uid)

    def unprepare_resource_claims(self, claim_refs: list) -> dict:
        """uid -> error, "" on success."""
        out = {}
        for ref in claim_refs:
            uid = _ref_field(ref, "uid")
            try:
                self.state.unprepare(uid)
                out[uid] = ""
            except Exception as e:  # noqa: BLE001 - the callback's boundary
                logger.exception("unprepare failed for %s", uid)
                out[uid] = str(e)
        return out

    # -- ResourceSlice publication -----------------------------------------

    def generate_resource_slices(self) -> list[dict]:
        return [{
            "apiVersion": "resource.k8s.io/v1",
            "kind": "ResourceSlice",
            "metadata": {
                "name": f"{self.node_name}-{COMPUTE_DOMAIN_DRIVER_NAME}"},
            "spec": {
                "driver": COMPUTE_DOMAIN_DRIVER_NAME,
                "nodeName": self.node_name,
                "pool": {"name": self.node_name, "resourceSliceCount": 1,
                         "generation": 1},
                "devices": self.state.allocatable_devices(),
            },
        }]

    def publish_resources(self) -> dict:
        return publish_resource_slices(self.kube,
                                       self.generate_resource_slices())
