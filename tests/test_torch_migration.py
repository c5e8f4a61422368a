"""The port's cooperative live migration (``pkg/migration.py``,
``MigrationMetrics``, the ``migration`` policy of ``pkg/statemachine.py``,
the shared drain and deallocate stages of ``pkg/recovery.py`` and the
scheduler's attach point) against the JAX package's, on the CPU, and the
workload's side of the contract (``train/cooperative.py``).

- **Scenarios**: every case of ``tests/test_migration.py``, each run once
  on the JAX side (its ``FakeKubeClient``, ``DraScheduler``,
  ``MigrationController``) and once on the port's, from that file's
  helpers. After every pass (and every direct call of the shared stages)
  each side records its state: each claim's allocation, reservations and
  annotations (the intent's ``ack-by`` clock aside), the pods, the move
  records read back from the migration root (their clocks aside), the
  reservations, the pass counts with each fallback's reason, and the
  ``MigrationMetrics`` samples (the latency histograms by their count).
  The two sides' records must be equal step by step, and the case's own
  assertions hold on each.
- **The workload contract**: the tiny trainer, in process, with a port
  scheduler and migration controller over a ``FakeKubeClient``: the
  controller signals after step 3, the trainer saves and acks, the claim
  switches to the other node, and a second run restores the checkpoint
  and trains on; every loss equals the uninterrupted run's, bitwise. No
  gang, no process group.
"""

import subprocess
import sys
import time

import pytest
import torch
from prometheus_client import generate_latest
from prometheus_client.parser import text_string_to_metric_families

from k8s_dra_driver_gpu_tpu.pkg import faults as jax_faults
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.pkg import metrics as jax_metrics
from k8s_dra_driver_gpu_tpu.pkg import migration as jax_migration
from k8s_dra_driver_gpu_tpu.pkg import recovery as jax_recovery
from k8s_dra_driver_gpu_tpu.pkg import scheduler as jax_sched
from k8s_dra_driver_gpu_tpu.pkg import sliceutil as jax_slices
from k8s_dra_driver_gpu_tpu.pkg.analysis import statemachine as jax_sm
from k8s_dra_driver_gpu_tpu_torch.models import llama as pt_llama
from k8s_dra_driver_gpu_tpu_torch.pkg import exposition
from k8s_dra_driver_gpu_tpu_torch.pkg import faults as pt_faults
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import metrics as pt_metrics
from k8s_dra_driver_gpu_tpu_torch.pkg import migration as pt_migration
from k8s_dra_driver_gpu_tpu_torch.pkg import recovery as pt_recovery
from k8s_dra_driver_gpu_tpu_torch.pkg import scheduler as pt_sched
from k8s_dra_driver_gpu_tpu_torch.pkg import sliceutil as pt_slices
from k8s_dra_driver_gpu_tpu_torch.pkg import statemachine as pt_sm
from k8s_dra_driver_gpu_tpu_torch.train import cooperative
from tests.test_migration import (DRIVER, RES, add_node, annotations_of,
                                  apply_class, make_bound_pod,
                                  make_capable_claim, node_slices)

SIDES = ("jax", "pt")
M = {
    "jax": dict(kube=jax_kube, sched=jax_sched, mig=jax_migration,
                rec=jax_recovery, metrics=jax_metrics, faults=jax_faults,
                slices=jax_slices, latest=generate_latest),
    "pt": dict(kube=pt_kube, sched=pt_sched, mig=pt_migration,
               rec=pt_recovery, metrics=pt_metrics, faults=pt_faults,
               slices=pt_slices, latest=exposition.generate_latest),
}
INTENT = jax_migration.MIGRATION_INTENT_ANNOTATION
ACK = jax_migration.MIGRATION_ACK_ANNOTATION
HINT = "resource.tpu.dra/defrag-target"
# A record's wall clocks.
CLOCKS = ("plannedAt", "signaledAt", "ackBy", "ackedAt", "switchedAt")
# The controller of the JAX file's ``cluster`` fixture.
CTRL = dict(ack_s=60.0, deadline_s=60.0, cooldown_s=0.0)


@pytest.fixture(autouse=True)
def clean_faults():
    for side in SIDES:
        M[side]["faults"].reset()
    yield
    for side in SIDES:
        M[side]["faults"].reset()


def test_constants_equal_the_references():
    for name in ("EVACUATE_ANNOTATION", "MIGRATION_INTENT_ANNOTATION",
                 "MIGRATION_ACK_ANNOTATION", "ACK_FAILED", "MIGRATION_ACK_S",
                 "MIGRATION_DEADLINE_S", "MIGRATION_MAX_CONCURRENT",
                 "MIGRATION_COOLDOWN_S", "PAUSE_ENV"):
        assert getattr(pt_migration, name) == getattr(jax_migration, name)
    for name in ("MIGRATION_DEST_RESERVED", "MIGRATION_INTENT_SIGNALED",
                 "MIGRATION_WORKLOAD_ACKED", "MIGRATION_SWITCHING"):
        assert getattr(pt_sm, name) == getattr(jax_sm, name)
    assert pt_sm.MIGRATION_POLICY.allowed == jax_sm.MIGRATION_POLICY.allowed


@pytest.mark.parametrize("node", [
    {}, {"metadata": {"annotations": {"resource.tpu.dra/evacuate": "true"}}},
    {"metadata": {"annotations": {"resource.tpu.dra/evacuate": "false"}}},
    {"metadata": {"annotations": {"resource.tpu.dra/evacuate": "0"}}},
    {"metadata": {"annotations": {"resource.tpu.dra/evacuate": ""}}}])
def test_node_evacuating_alike(node):
    assert pt_migration.node_evacuating(node) == \
        jax_migration.node_evacuating(node)


def test_intent_value_alike():
    for args in (("n1", ["chip-0"], 17.4), ("n2", ["a", "b"], 1e9 + 0.6),
                 ("", [], 0.0)):
        assert pt_migration.intent_value(*args) == \
            jax_migration.intent_value(*args)


# -- both sides ---------------------------------------------------------------

def value(metric) -> float:
    if hasattr(metric, "_value"):
        return metric._value.get()
    return metric.value if hasattr(metric, "value") else \
        metric._own().value


def fallbacks_by_reason(side, metrics) -> dict:
    return {labels["reason"]: v for name, labels, v in (
        (s[0], dict(s[1]), s[2]) for s in samples(side, metrics.registry))
        if name == "tpu_dra_migration_fallbacks_total"}


def samples(side, registry):
    text = M[side]["latest"](registry).decode()
    out = []
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            if fam.type == "histogram" and not s.name.endswith("_count"):
                continue
            out.append((s.name, tuple(sorted(s.labels.items())), s.value))
    return sorted(out)


class Side:
    """One side's cluster, as the JAX file's ``cluster`` fixture builds
    it (``cluster=False``: nodes and class only, the case builds the
    rest)."""

    def __init__(self, side, tmp_path, cluster=True, ctrl_kw=CTRL,
                 metrics=True):
        self.side, self.m = side, M[side]
        self.root = str(tmp_path / f"migration-{side}")
        self.ctrl_kw = dict(ctrl_kw)
        self.kube = self.m["kube"].FakeKubeClient()
        apply_class(self.kube)
        for node in ("node-a", "node-b"):
            add_node(self.kube, node)
        self.sched = self.m["sched"].DraScheduler(self.kube)
        self.metrics = self.m["metrics"].MigrationMetrics() if metrics \
            else None
        self.mig = None
        self.trace = []
        if cluster:
            self.publish("node-a")
            make_capable_claim(self.kube, "w")
            self.settle()
            assert self.nodes("w") == ["node-a"]
            make_bound_pod(self.kube, "w-pod", "w", "node-a")
            self.publish("node-b")
            self.attach()

    def publish(self, node):
        self.m["slices"].publish_resource_slices(self.kube,
                                                 node_slices(node))

    def attach(self, **kw):
        self.mig = self.m["mig"].MigrationController(
            self.kube, self.root, metrics=self.metrics,
            **dict(self.ctrl_kw, **kw))
        self.sched.attach_migration(self.mig)
        return self.mig

    def nodes(self, name):
        return sorted(self.m["rec"].allocation_nodes(self.kube.get(
            *RES, "resourceclaims", name, namespace="default")))

    def pods(self):
        return sorted(p["metadata"]["name"]
                      for p in self.kube.list("", "v1", "pods"))

    def evacuate(self, node, on=True):
        self.kube.patch("", "v1", "nodes", node, {"metadata": {
            "annotations": {"resource.tpu.dra/evacuate":
                            "true" if on else None}}})

    def ack(self, name, ack_value):
        self.kube.patch(*RES, "resourceclaims", name, {"metadata": {
            "annotations": {ACK: ack_value}}}, namespace="default")

    def state(self):
        claims = {}
        for c in self.kube.list(*RES, "resourceclaims"):
            md, st = c["metadata"], c.get("status", {})
            ann = {}
            for k, v in (md.get("annotations") or {}).items():
                if k == "resource.tpu.dra/traceparent":
                    continue
                if k == INTENT:
                    target, _, ack_by = v.partition(";ack-by=")
                    v = (target, bool(ack_by))
                ann[k] = v
            alloc = st.get("allocation")
            claims[md["name"]] = (
                md.get("uid"), ann, st.get("reservedFor"),
                None if not alloc else sorted(
                    (r["pool"], r["device"])
                    for r in alloc["devices"]["results"]))
        out = {"claims": claims, "pods": self.pods()}
        if self.mig is not None:
            records = {}
            for uid, rec in self.mig._checkpoint.get().claims.items():
                live = {k: v for k, v in (rec.devices[0].live or {}).items()
                        if k not in CLOCKS}
                records[uid] = (rec.namespace, rec.name, rec.state, live)
            out.update(records=records,
                       reservations=sorted(self.mig.reservations().items()),
                       active=self.mig.active_moves(), busy=self.mig.busy(),
                       last_sync=self.mig.last_sync)
        if self.metrics is not None:
            out["metrics"] = samples(self.side, self.metrics.registry)
        return out

    def snap(self, label):
        self.trace.append((label, self.state()))

    def settle(self, passes=6, label="pass"):
        for i in range(passes):
            self.sched.sync_once()
            self.snap(f"{label} {i}")


def run_both(scenario, tmp_path, **kw):
    sides = {}
    for name in SIDES:
        s = Side(name, tmp_path / name, **kw)
        scenario(s)
        sides[name] = s
    jt, pt = sides["jax"].trace, sides["pt"].trace
    assert [label for label, _ in pt] == [label for label, _ in jt]
    for (label, got), (_, want) in zip(pt, jt):
        for key in want:
            assert got[key] == want[key], (label, key)
    return sides["pt"]


# TestSharedDrainClear --------------------------------------------------------

def _seeded(s, reserve_pod="w-0"):
    """The JAX file's ``TestSharedDrainClear.seed``: a claim reserved
    for one pod, bound via the reservation, via the claim ref, and an
    unbound consumer."""
    s.kube.create(*RES, "resourceclaims", {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": "w", "namespace": "default", "uid": "uid-w"},
        "spec": {},
        "status": {
            "allocation": {"devices": {"results": [{
                "request": "tpu", "driver": DRIVER, "pool": "node-a",
                "device": "chip-0"}]}},
            "reservedFor": [{"resource": "pods", "name": reserve_pod}]},
    }, namespace="default")
    make_bound_pod(s.kube, "w-0", "other-claim", "node-a")
    make_bound_pod(s.kube, "w-1", "w", "node-a")
    s.kube.create("", "v1", "pods", {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "w-2", "namespace": "default"},
        "spec": {"containers": [{"name": "c"}], "resourceClaims": [
            {"name": "tpu", "resourceClaimName": "w"}]}},
        namespace="default")
    claim = s.kube.get(*RES, "resourceclaims", "w", namespace="default")
    return claim, s.kube.list("", "v1", "pods")


def _claim_w(s):
    return s.kube.get(*RES, "resourceclaims", "w", namespace="default")


def test_drain_evicts_bound_consumers_and_drops_reservation(tmp_path):
    def sc(s):
        claim, pods = _seeded(s)
        s.m["rec"].drain_claim(s.kube, claim, pods)
        s.snap("drained")
        assert s.pods() == ["w-2"]
        assert not _claim_w(s).get("status", {}).get("reservedFor")
        assert _claim_w(s)["status"]["allocation"]
        assert s.m["rec"].clear_allocation(s.kube, claim) is True
        s.snap("cleared")
        assert not _claim_w(s).get("status", {}).get("allocation")
    run_both(sc, tmp_path, cluster=False, metrics=False)


def test_claim_deleted_mid_drain_is_swallowed(tmp_path):
    def sc(s):
        claim, pods = _seeded(s)
        s.kube.delete("", "v1", "pods", "w-1", namespace="default")
        s.kube.delete(*RES, "resourceclaims", "w", namespace="default")
        s.m["rec"].drain_claim(s.kube, claim, pods)
        s.snap("drained")
        assert s.pods() == ["w-2"]
        assert s.m["rec"].clear_allocation(s.kube, claim) is False
    run_both(sc, tmp_path, cluster=False, metrics=False)


class _FlakyPatchKube:
    """The JAX file's wrapper, raising the side's ``ConflictError`` on the
    next ``fail`` patches."""

    def __init__(self, inner, error, fail=1):
        self._inner, self._error, self.fail = inner, error, fail

    def patch(self, *a, **kw):
        if self.fail > 0:
            self.fail -= 1
            raise self._error("injected patch conflict")
        return self._inner.patch(*a, **kw)

    def __getattr__(self, item):
        return getattr(self._inner, item)


def test_partial_patch_failure_leaves_retryable_state(tmp_path):
    def sc(s):
        claim, pods = _seeded(s)
        flaky = _FlakyPatchKube(s.kube, s.m["kube"].ConflictError, fail=2)
        s.m["rec"].drain_claim(flaky, claim, pods)
        s.snap("drain refused")
        assert s.pods() == ["w-2"]
        refreshed = _claim_w(s)
        assert refreshed["status"]["reservedFor"]
        assert s.m["rec"].clear_allocation(flaky, claim) is False
        assert _claim_w(s)["status"]["allocation"]
        s.m["rec"].drain_claim(flaky, refreshed,
                               s.kube.list("", "v1", "pods"))
        assert s.m["rec"].clear_allocation(flaky, claim) is True
        s.snap("retried")
        refreshed = _claim_w(s)
        assert not refreshed.get("status", {}).get("reservedFor")
        assert not refreshed.get("status", {}).get("allocation")
    run_both(sc, tmp_path, cluster=False, metrics=False)


def test_idempotent_reentry_after_crash(tmp_path):
    def sc(s):
        claim, pods = _seeded(s)
        s.m["rec"].drain_claim(s.kube, claim, pods)
        assert s.m["rec"].clear_allocation(s.kube, claim) is True
        before = _claim_w(s)
        s.snap("first")
        s.m["rec"].drain_claim(s.kube, claim, pods)
        assert s.m["rec"].clear_allocation(s.kube, claim) is True
        s.snap("again")
        assert s.pods() == ["w-2"]
        assert _claim_w(s).get("status") == before.get("status")
    run_both(sc, tmp_path, cluster=False, metrics=False)


def test_deadline_expiry_mid_stage_drains_cold(tmp_path):
    def sc(s):
        s.publish("node-a")
        make_capable_claim(s.kube, "w")
        s.settle()
        make_bound_pod(s.kube, "w-pod", "w", "node-a")
        s.publish("node-b")
        s.attach(ack_s=60.0, deadline_s=0.05, cooldown_s=3600.0)
        s.evacuate("node-a")
        s.settle(2, "plan and signal")
        assert s.mig.active_moves()
        assert INTENT in annotations_of(s.kube, "w")
        assert "w-pod" in s.pods()
        time.sleep(0.06)
        s.settle()
        assert s.mig.active_moves() == {}
        assert s.mig.reservations() == {}
        anns = annotations_of(s.kube, "w")
        assert INTENT not in anns and HINT not in anns
        assert "w-pod" not in s.pods()
        assert s.nodes("w")
    run_both(sc, tmp_path, cluster=False, metrics=False)


# TestMigrationController -----------------------------------------------------

def test_happy_path_checkpoint_then_switch(tmp_path):
    def sc(s):
        s.evacuate("node-a")
        s.settle(2, "reserve and signal")
        anns = annotations_of(s.kube, "w")
        assert anns[INTENT].startswith("node-b|")
        assert ";ack-by=" in anns[INTENT]
        uid = _claim_w(s)["metadata"]["uid"]
        assert set(s.mig.reservations().values()) == {uid}
        s.ack("w", "step-7")
        s.settle()
        assert s.nodes("w") == ["node-b"]
        assert s.mig.active_moves() == {} and s.mig.reservations() == {}
        anns = annotations_of(s.kube, "w")
        assert INTENT not in anns and ACK not in anns and HINT not in anns
        assert "w-pod" not in s.pods()
        assert value(s.metrics.coop_moves) == 1
    run_both(sc, tmp_path)


def test_ack_timeout_falls_back_without_touching_allocation(tmp_path):
    def sc(s):
        s.publish("node-a")
        make_capable_claim(s.kube, "w")
        s.settle()
        make_bound_pod(s.kube, "w-pod", "w", "node-a")
        s.publish("node-b")
        s.attach(ack_s=0.02, deadline_s=60.0, cooldown_s=3600.0)
        s.evacuate("node-a")
        s.settle(2, "reserve and signal")
        assert INTENT in annotations_of(s.kube, "w")
        time.sleep(0.03)
        s.settle()
        assert s.mig.active_moves() == {} and s.mig.reservations() == {}
        assert INTENT not in annotations_of(s.kube, "w")
        assert s.nodes("w") == ["node-a"]
        assert "w-pod" in s.pods()
        assert fallbacks_by_reason(s.side, s.metrics) == {"ack-timeout": 1}
        s.settle(label="cooled")
        assert s.mig.active_moves() == {}
        assert value(s.metrics.plans) == 1
    run_both(sc, tmp_path, cluster=False)


def test_checkpoint_failed_ack_falls_back(tmp_path):
    def sc(s):
        s.evacuate("node-a")
        s.settle(2, "reserve and signal")
        s.evacuate("node-a", on=False)
        s.ack("w", jax_migration.ACK_FAILED)
        s.settle(1, "failed ack")
        assert s.mig.active_moves() == {} and s.mig.reservations() == {}
        assert fallbacks_by_reason(s.side, s.metrics) == {
            "checkpoint-failed": 1}
        assert s.nodes("w") == ["node-a"]
        anns = annotations_of(s.kube, "w")
        assert INTENT not in anns and ACK not in anns
    run_both(sc, tmp_path)


def test_destination_lost_falls_back(tmp_path):
    def sc(s):
        s.evacuate("node-a")
        s.settle(2, "reserve and signal")
        assert s.mig.reservations()
        s.kube.delete(*RES, "resourceslices", f"node-b-{DRIVER}")
        s.settle(2, "lost")
        assert s.mig.active_moves() == {} and s.mig.reservations() == {}
        assert fallbacks_by_reason(s.side, s.metrics) == {
            "destination-lost": 1}
        assert s.nodes("w") == ["node-a"]
    run_both(sc, tmp_path)


def test_racing_claim_delete_cancels(tmp_path):
    def sc(s):
        s.evacuate("node-a")
        s.settle(2, "reserve and signal")
        assert s.mig.active_moves()
        s.kube.delete("", "v1", "pods", "w-pod", namespace="default")
        s.kube.delete(*RES, "resourceclaims", "w", namespace="default")
        s.settle(1, "deleted")
        assert s.mig.active_moves() == {} and s.mig.reservations() == {}
        assert fallbacks_by_reason(s.side, s.metrics) == {}
        assert value(s.metrics.coop_moves) == 0
    run_both(sc, tmp_path)


def test_crash_resume_rebuilds_reservations_and_completes(tmp_path):
    def sc(s):
        s.evacuate("node-a")
        s.settle(2, "reserve and signal")
        s.ack("w", "step-3")
        s.settle(1, "acked")
        before = dict(s.mig.reservations())
        assert before
        s.m["faults"].arm("migration.switch", mode="crash", count=1)
        with pytest.raises(s.m["faults"].InjectedCrash):
            s.sched.sync_once()
        s.snap("crashed")
        s.metrics = s.m["metrics"].MigrationMetrics()
        reborn = s.attach()
        assert dict(reborn.reservations()) == before
        s.snap("reborn")
        s.settle()
        assert s.nodes("w") == ["node-b"]
        assert reborn.active_moves() == {} and reborn.reservations() == {}
        assert value(s.metrics.coop_moves) == 1
    run_both(sc, tmp_path)


def test_gang_switches_behind_all_acked_barrier(tmp_path):
    def sc(s):
        s.publish("node-a")
        make_capable_claim(s.kube, "g0", count=2, gang="cd-1")
        make_capable_claim(s.kube, "g1", count=2, gang="cd-1")
        s.settle()
        assert s.nodes("g0") == s.nodes("g1") == ["node-a"]
        s.publish("node-b")
        s.attach(max_concurrent=2)
        s.evacuate("node-a")
        s.settle(2, "reserve and signal")
        assert len(s.mig.active_moves()) == 2
        assert len(s.mig.reservations()) == 4
        s.ack("g0", "step-5")
        s.settle(2, "one acked")
        assert s.nodes("g0") == s.nodes("g1") == ["node-a"]
        assert "MigrationWorkloadAcked" in s.mig.active_moves().values()
        s.ack("g1", "step-5")
        s.settle(label="both acked")
        assert s.nodes("g0") == s.nodes("g1") == ["node-b"]
        assert s.mig.active_moves() == {} and s.mig.reservations() == {}
        assert value(s.metrics.coop_moves) == 2
    run_both(sc, tmp_path, cluster=False)


def test_gang_with_cold_only_member_is_refused(tmp_path):
    def sc(s):
        s.publish("node-a")
        make_capable_claim(s.kube, "g0", count=2, gang="cd-1")
        make_capable_claim(s.kube, "g1", count=2, gang="cd-1",
                           capable=False)
        s.settle()
        s.publish("node-b")
        s.attach()
        s.evacuate("node-a")
        s.settle(3, "evacuating")
        assert s.mig.active_moves() == {} and s.mig.reservations() == {}
        assert INTENT not in annotations_of(s.kube, "g0")
    run_both(sc, tmp_path, cluster=False, metrics=False)


def test_exposition_line_by_line():
    texts = {}
    for side in SIDES:
        metrics = M[side]["metrics"].MigrationMetrics()
        metrics.plans.inc(2)
        metrics.coop_moves.inc()
        metrics.fallbacks.labels("ack-timeout").inc()
        metrics.active_moves.set(1)
        for hist, seconds in ((metrics.ack_seconds, 0.3),
                              (metrics.switch_seconds, 0.07),
                              (metrics.move_seconds, 2.0)):
            hist.observe(seconds)
        texts[side] = [line for line in M[side]["latest"](
            metrics.registry).decode().splitlines()
            if "_created" not in line]
    assert texts["pt"] == texts["jax"]


# -- the workload's side of the contract --------------------------------------

TINY_STEPS, TINY_BATCH, TINY_SEQ = 6, 2, 16


def test_tiny_trainer_moves_warm_with_its_claim(tmp_path, monkeypatch):
    """The tiny trainer under a capable claim on ``node-a``: after step 3
    ``node-a`` is evacuated and the scheduler's passes reserve ``node-b``
    and signal; the trainer saves step 3, acks and stops; the next pass
    switches the claim to ``node-b``; a second run restores step 3 and
    trains on. The losses are the uninterrupted run's, bitwise."""
    def no_gang(*args, **kwargs):
        raise AssertionError("the cooperative trainer joined a gang")
    monkeypatch.setattr(torch.distributed, "init_process_group", no_gang)
    cfg = pt_llama.LlamaConfig.tiny()
    common = dict(device="cpu", seed=0, batch_size=TINY_BATCH,
                  seq_len=TINY_SEQ)
    want = cooperative.run(cfg, TINY_STEPS, str(tmp_path / "plain"),
                           **common)
    assert want["done"] == TINY_STEPS and want["restored_from"] is None

    s = Side("pt", tmp_path)
    watch = cooperative.ClaimWatch(s.kube, "default", "w", env={})
    ckpt = str(tmp_path / "ckpt")

    def on_step(step, loss):
        if step == 3:
            s.evacuate("node-a")
            s.settle(2, "reserve and signal")
    first = cooperative.run(cfg, TINY_STEPS, ckpt, watch=watch,
                            on_step=on_step, **common)
    assert first["acked"] == 3 and "done" not in first
    assert first["intent"].startswith("node-b|")
    assert annotations_of(s.kube, "w")[ACK] == "step-3"
    assert first["checkpoint_bytes"] > 0
    s.settle(3, "ack, switch, retire")
    assert s.nodes("w") == ["node-b"]
    assert s.mig.active_moves() == {}
    anns = annotations_of(s.kube, "w")
    assert INTENT not in anns and ACK not in anns
    second = cooperative.run(cfg, TINY_STEPS, ckpt, watch=watch, **common)
    assert second["restored_from"] == 3 and second["done"] == TINY_STEPS
    got = {**first["losses"], **second["losses"]}
    assert got == want["losses"]
    assert sorted(got) == list(range(1, TINY_STEPS + 1))


def test_trainer_acks_failed_when_its_save_fails(tmp_path, monkeypatch):
    """A save that raises acks ``failed`` (the controller falls back
    cold) and the error goes through."""
    s = Side("pt", tmp_path)
    s.evacuate("node-a")
    s.settle(2, "reserve and signal")
    watch = cooperative.ClaimWatch(s.kube, "default", "w", env={})

    def refuse(*args, **kwargs):
        raise OSError("disk full")
    monkeypatch.setattr(cooperative.TrainCheckpointer, "save", refuse)
    with pytest.raises(OSError, match="disk full"):
        cooperative.run(pt_llama.LlamaConfig.tiny(), 2,
                        str(tmp_path / "ckpt"), device="cpu",
                        batch_size=TINY_BATCH, seq_len=TINY_SEQ,
                        watch=watch)
    assert annotations_of(s.kube, "w")[ACK] == "failed"
    s.settle(1, "failed ack")
    assert fallbacks_by_reason("pt", s.metrics) == {"checkpoint-failed": 1}


def test_watch_reads_the_names_the_env_gives():
    kube = pt_kube.FakeKubeClient()
    make_capable_claim(kube, "w")
    watch = cooperative.ClaimWatch(kube, "default", "w", env={
        cooperative.INTENT_ENV: "example.com/intent",
        cooperative.ACK_ENV: "example.com/ack"})
    assert watch.intent() is None
    kube.patch(*RES, "resourceclaims", "w", {"metadata": {"annotations": {
        "example.com/intent": "n|d;ack-by=1", INTENT: "ignored"}}},
        namespace="default")
    assert watch.intent() == "n|d;ack-by=1"
    watch.ack("step-1")
    assert annotations_of(kube, "w")["example.com/ack"] == "step-1"


def test_watch_defaults_are_the_controllers_names():
    """Without the env the workload reads and writes the controller's
    annotations, and acks a failed save as the controller expects."""
    watch = cooperative.ClaimWatch(pt_kube.FakeKubeClient(), "default", "w",
                                   env={})
    assert (watch.intent_key, watch.ack_key, cooperative.ACK_FAILED) == (
        pt_migration.MIGRATION_INTENT_ANNOTATION,
        pt_migration.MIGRATION_ACK_ANNOTATION, pt_migration.ACK_FAILED)


def test_trainer_needs_nothing_of_the_controller():
    """The workload's module imports no controller: the names reach it
    through the CDI env."""
    code = ("import sys\n"
            "import k8s_dra_driver_gpu_tpu_torch.train.cooperative\n"
            "print(sorted(m for m in sys.modules if m.startswith("
            "'k8s_dra_driver_gpu_tpu_torch.pkg.')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    for controller in ("migration", "defrag", "recovery", "scheduler"):
        assert f"'k8s_dra_driver_gpu_tpu_torch.pkg.{controller}'" not in out
