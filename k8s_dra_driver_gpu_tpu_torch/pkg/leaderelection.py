"""Lease-based leader election for the controller's replicas (the JAX
package's ``pkg/leaderelection.py``; upstream
cmd/compute-domain-controller/main.go:277-377: a coordination.k8s.io/v1
Lease with ReleaseOnCancel, 30 s lease, 10 s renew, 2 s retry).

Over any client with ``KubeClient``'s surface (the port's ``KubeClient``,
``FakeKubeClient`` or a ``RetryingKubeClient`` around either):

- a ``RetryingKubeClient`` is rebuilt with a deadline bounded by the
  renew period (``_lease_client``);
- expiry is judged from when this process last saw the lease record
  change, never from the remote ``renewTime`` against the local clock,
  so clock skew cannot hand a live leader's lease to a peer;
- a lease another holder owns steps the leader down at once; renew
  errors are tolerated while the lease is still valid on the server and
  step it down after that;
- leading ends with the lease released (an empty holder), so a peer
  takes over within one retry period.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from datetime import datetime, timezone

from .kubeclient import ConflictError, NotFoundError

logger = logging.getLogger(__name__)

LEASE_DURATION_S = 30
RENEW_PERIOD_S = 10
RETRY_PERIOD_S = 2


def _now() -> str:
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


class LeaderElector:
    def __init__(
        self,
        kube,
        lease_name: str,
        namespace: str,
        identity: str,
        lease_duration: float = LEASE_DURATION_S,
        renew_period: float = RENEW_PERIOD_S,
        retry_period: float = RETRY_PERIOD_S,
    ):
        self.kube = self._lease_client(kube, renew_period)
        self.lease_name = lease_name
        self.namespace = namespace
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_period = renew_period
        self.retry_period = retry_period
        self.is_leader = False
        # Lease expiry is judged from when THIS process last observed the
        # lease record change (client-go semantics), never by comparing
        # the remote renewTime against the local wall clock -- clock skew
        # between replicas must not open a dual-leader window.
        self._observed_record: tuple[str, str] | None = None
        self._observed_at: float = 0.0

    @staticmethod
    def _lease_client(kube, renew_period: float):
        """Rebuild a RetryingKubeClient with a deadline BOUNDED by the
        renew period. Lease RPCs are latency-critical liveness signals:
        a renew parked inside a 30s retry budget while the server-side
        lease expires at 30s hands a peer the lease while this process
        still believes it leads (dual leader). One quick attempt +
        short retries per renew tick is the client-go shape; the renew
        LOOP is the retry mechanism. Non-wrapped clients pass through
        unchanged."""
        policy = getattr(kube, "policy", None)
        inner = getattr(kube, "kube", None)
        if policy is None or inner is None:
            return kube
        import dataclasses  # noqa: PLC0415

        from .retry import RetryingKubeClient  # noqa: PLC0415

        deadline = max(1.0, min(policy.deadline_s, renew_period * 0.8))
        return RetryingKubeClient(
            inner,
            policy=dataclasses.replace(
                policy, deadline_s=deadline,
                attempt_timeout_s=min(policy.attempt_timeout_s, deadline)),
            breaker=kube.breaker, metrics=kube.metrics)

    # -- lease CRUD -------------------------------------------------------------

    def _lease_obj(self) -> dict:
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": self.lease_name,
                         "namespace": self.namespace},
            "spec": {
                "holderIdentity": self.identity,
                "leaseDurationSeconds": int(self.lease_duration),
                "acquireTime": _now(),
                "renewTime": _now(),
            },
        }

    def try_acquire_or_renew(self) -> bool:
        """Never raises: any API failure reads as 'did not get the
        lease'. The renew loop distinguishes LOST (another holder owns
        it -- step down now) from ERROR (apiserver blip -- tolerated up
        to the lease duration, because our lease stays valid on the
        server for that long) via _renew_once."""
        return self._renew_once() == "ok"

    def _renew_once(self) -> str:
        """'ok' | 'lost' | 'error' -- the tri-state the renew loop's
        step-down policy needs. A transient apiserver error must NOT
        read the same as a peer seizing the lease: stepping down on the
        first blip turns every apiserver hiccup into a leadership churn,
        while ignoring a real loss splits the brain."""
        try:
            return "ok" if self._try_acquire_or_renew() else "lost"
        except Exception:  # noqa: BLE001 - lease RPC boundary
            logger.exception("lease operation failed")
            return "error"

    def _try_acquire_or_renew(self) -> bool:
        try:
            lease = self.kube.get("coordination.k8s.io", "v1", "leases",
                                  self.lease_name, namespace=self.namespace)
        except NotFoundError:
            try:
                self.kube.create("coordination.k8s.io", "v1", "leases",
                                 self._lease_obj(), namespace=self.namespace)
                return True
            except ConflictError:
                return False
        spec = lease.get("spec", {})
        holder = spec.get("holderIdentity", "")
        record = (holder, spec.get("renewTime", ""))
        now = time.monotonic()
        if record != self._observed_record:
            # Fresh activity: restart the local expiry clock.
            self._observed_record = record
            self._observed_at = now
        expired = now - self._observed_at > self.lease_duration
        # An empty holder means the previous leader released on cancel.
        if holder and holder != self.identity and not expired:
            return False
        # Mutate a deep copy, never the fetched object; setdefault also
        # re-attaches the spec of a lease that had none.
        lease = copy.deepcopy(lease)
        spec = lease.setdefault("spec", {})
        spec["holderIdentity"] = self.identity
        spec["renewTime"] = _now()
        if holder != self.identity:
            spec["acquireTime"] = _now()
        try:
            self.kube.update("coordination.k8s.io", "v1", "leases",
                             self.lease_name, lease,
                             namespace=self.namespace)
            return True
        except (ConflictError, NotFoundError):
            return False

    def release(self) -> None:
        """ReleaseOnCancel: zero the holder so a peer takes over fast.
        Genuinely best-effort -- the error-budget step-down path calls
        this precisely when the apiserver is unreachable, and a raise
        here would turn a clean step-down into a crash (the lease then
        simply expires server-side)."""
        try:
            lease = self.kube.get("coordination.k8s.io", "v1", "leases",
                                  self.lease_name, namespace=self.namespace)
            if lease.get("spec", {}).get("holderIdentity") != self.identity:
                return
            lease = copy.deepcopy(lease)
            lease["spec"]["holderIdentity"] = ""
            self.kube.update("coordination.k8s.io", "v1", "leases",
                             self.lease_name, lease,
                             namespace=self.namespace)
        except (ConflictError, NotFoundError):
            pass
        except Exception:  # noqa: BLE001 - lease RPC boundary
            logger.exception("lease release failed (will expire "
                             "server-side)")

    # -- loop ---------------------------------------------------------------------

    def run(self, lead_fn, stop: threading.Event,
            on_stopped_leading=None) -> None:
        """Block until stop; call lead_fn() (blocking) while leading.

        Renew-failure policy (the zombie-holder fix): a DEFINITIVE loss
        (another identity holds a live lease) steps down immediately; a
        transient renew ERROR (apiserver blip) is tolerated while our
        server-side lease is still within its duration -- the lease
        protects us from challengers for exactly that long -- and only
        REPEATED errors past that budget force a clean step-down. Either
        way ``on_stopped_leading`` fires EXACTLY ONCE per leadership
        term (never on a normal external stop before leading ends it),
        ``stop`` is set, and the lease is released (best effort)."""
        while not stop.is_set():
            if self.try_acquire_or_renew():
                self.is_leader = True
                logger.info("%s acquired lease %s", self.identity,
                            self.lease_name)
                renew_stop = threading.Event()
                fired = threading.Lock()
                fired_once = [False]

                def stopped_leading(reason: str) -> None:
                    """Idempotent step-down: exactly one caller -- the
                    renew loop or the run() finally -- gets to fire the
                    callback and flip the flags."""
                    with fired:
                        if fired_once[0]:
                            return
                        fired_once[0] = True
                    logger.warning("stepping down from lease %s: %s",
                                   self.lease_name, reason)
                    self.is_leader = False
                    if on_stopped_leading is not None:
                        try:
                            on_stopped_leading()
                        except Exception:  # noqa: BLE001 - consumer hook
                            logger.exception("on_stopped_leading failed")
                    stop.set()

                def renew_loop():
                    # The error budget is anchored at the LAST
                    # SUCCESSFUL renew: that is when the server-side
                    # lease clock restarted, so it bounds how long we
                    # may claim leadership through an outage -- wall
                    # time spent BLOCKED inside a failing renew call
                    # counts against it (anchoring at the first failed
                    # *return* would not).
                    last_ok = time.monotonic()
                    while not renew_stop.wait(self.renew_period):
                        result = self._renew_once()
                        now = time.monotonic()
                        if result == "ok":
                            last_ok = now
                            continue
                        if result == "lost":
                            stopped_leading("lease lost to another holder")
                            return
                        # Transient error: our lease stays valid
                        # server-side for lease_duration from the last
                        # successful renew -- keep leading inside that
                        # window (minus one renew period of margin)
                        # instead of churning on one blip.
                        budget = max(
                            self.lease_duration - self.renew_period, 0.0)
                        if now - last_ok >= budget:
                            stopped_leading(
                                f"renew failing for {now - last_ok:.1f}s"
                                " (lease may have expired server-side)")
                            return
                        logger.warning(
                            "lease %s renew error; retaining leadership "
                            "%.1fs more before stepping down",
                            self.lease_name,
                            budget - (now - last_ok))

                t = threading.Thread(target=renew_loop, daemon=True,
                                     name=f"lease-renew-{self.lease_name}")
                t.start()
                try:
                    lead_fn()
                finally:
                    renew_stop.set()
                    t.join(timeout=2)
                    # Normal exit path (external stop): no step-down
                    # callback fired yet and none is due -- leading
                    # ended because lead_fn returned, not because the
                    # lease was lost. Mark the term closed so a renew
                    # race can't fire the callback after release.
                    with fired:
                        fired_once[0] = True
                    self.release()
                    self.is_leader = False
                return
            stop.wait(self.retry_period)
