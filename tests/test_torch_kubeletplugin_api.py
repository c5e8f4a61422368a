"""The port's kubelet-plugin helpers against the JAX plugin's: opaque
config decoding and validation (``GpuConfig`` against ``TpuConfig``),
``ResourceClaim.from_dict``, the two-phase state machine and the file
lock, on the same inputs made from seeds."""

import random
import threading

import pytest

from k8s_dra_driver_gpu_tpu.api import configs as jax_configs
from k8s_dra_driver_gpu_tpu.api import decode as jax_decode
from k8s_dra_driver_gpu_tpu.kubeletplugin import DRIVER_NAME as JAX_DRIVER
from k8s_dra_driver_gpu_tpu.kubeletplugin.claim import \
    ResourceClaim as JaxClaim
from k8s_dra_driver_gpu_tpu.pkg.analysis import statemachine as jax_sm
from k8s_dra_driver_gpu_tpu_torch.api import configs as pt_configs
from k8s_dra_driver_gpu_tpu_torch.api import decode as pt_decode
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import ResourceClaim
from k8s_dra_driver_gpu_tpu_torch.pkg import statemachine as pt_sm
from k8s_dra_driver_gpu_tpu_torch.pkg.flock import (Flock,
                                                    FlockReentrantError,
                                                    FlockTimeoutError)

SEEDS = range(12)


def _params(side: str, body: dict) -> dict:
    """``body`` as the opaque parameters of a whole-device config."""
    if side == "jax":
        return {"apiVersion": jax_decode.API_VERSION, "kind": "TpuConfig",
                **body}
    return {"apiVersion": pt_decode.API_VERSION, "kind": "GpuConfig", **body}


def _random_body(rng: random.Random) -> dict:
    """A valid whole-device config body: no sharing, time-slicing at some
    interval, or multi-tenancy with random limits."""
    pick = rng.randrange(3)
    if pick == 0:
        return {}
    if pick == 1:
        ts = {"interval": rng.choice(["Default", "Short", "Medium", "Long",
                                      ""])}
        return {"sharing": {"strategy": "TimeSlicing", "timeSlicing": ts}}
    mt = {}
    if rng.random() < 0.7:
        mt["maxClients"] = rng.randrange(1, 17)
    if rng.random() < 0.7:
        mt["hbmLimit"] = f"{rng.randrange(1, 80)}{rng.choice(['Gi', 'Mi', ''])}"
    if rng.random() < 0.5:
        mt["perDeviceHbmLimits"] = {
            f"gpu-{i}": f"{rng.randrange(1, 64)}Gi"
            for i in rng.sample(range(8), rng.randrange(1, 4))}
    return {"sharing": {"strategy": "MultiTenancy", "multiTenancy": mt}}


def _body(encoded: dict) -> dict:
    return {k: v for k, v in encoded.items() if k not in ("apiVersion",
                                                           "kind")}


@pytest.mark.parametrize("seed", SEEDS)
def test_decode_normalize_encode_equal_the_references(seed):
    body = _random_body(random.Random(seed))
    jax_cfg = jax_decode.strict_decode(_params("jax", body))
    pt_cfg = pt_decode.strict_decode(_params("pt", body))
    assert _body(pt_decode.encode_config(pt_cfg)) == \
        _body(jax_decode.encode_config(jax_cfg))
    for cfg in (jax_cfg, pt_cfg):
        cfg.normalize()
        cfg.validate()
    encoded = pt_decode.encode_config(pt_cfg)
    assert _body(encoded) == _body(jax_decode.encode_config(jax_cfg))
    assert encoded["kind"] == "GpuConfig"
    assert encoded["apiVersion"] == "resource.nvidia.com/v1beta1"
    # The round trip: decode(encode(x)) == x.
    assert pt_decode.strict_decode(encoded) == pt_cfg


BAD_BODIES = {
    "unknown field": {"foo": 1},
    "sharing not an object": {"sharing": "x"},
    "unknown sharing field": {"sharing": {"bogus": 1}},
    "unknown strategy": {"sharing": {"strategy": "Nope"}},
    "unknown interval": {"sharing": {"strategy": "TimeSlicing",
                                     "timeSlicing": {"interval": "Weekly"}}},
    "multi-tenancy missing": {"sharing": {"strategy": "MultiTenancy"}},
    "multi-tenancy with time-slicing": {
        "sharing": {"strategy": "MultiTenancy", "timeSlicing": {},
                    "multiTenancy": {}}},
    "time-slicing with multi-tenancy": {
        "sharing": {"strategy": "TimeSlicing", "multiTenancy": {}}},
    "zero clients": {"sharing": {"strategy": "MultiTenancy",
                                 "multiTenancy": {"maxClients": 0}}},
    "bad limit": {"sharing": {"strategy": "MultiTenancy",
                              "multiTenancy": {"hbmLimit": "8Gb"}}},
    "empty device key": {"sharing": {
        "strategy": "MultiTenancy",
        "multiTenancy": {"perDeviceHbmLimits": {"": "1Gi"}}}},
    "unknown time-slicing field": {"sharing": {
        "strategy": "TimeSlicing", "timeSlicing": {"period": 3}}},
}


def _error(fn):
    try:
        cfg = fn()
        cfg.normalize()
        cfg.validate()
    except (jax_decode.DecodeError, jax_configs.ValidationError,
            pt_decode.DecodeError, pt_configs.ValidationError) as err:
        return type(err).__name__, str(err).replace("TpuConfig", "GpuConfig")
    return None


@pytest.mark.parametrize("name", sorted(BAD_BODIES))
def test_bad_configs_fail_as_the_references(name):
    body = BAD_BODIES[name]
    want = _error(lambda: jax_decode.strict_decode(_params("jax", body)))
    assert want is not None
    assert _error(lambda: pt_decode.strict_decode(_params("pt", body))) \
        == want


@pytest.mark.parametrize("params", [
    [], {"kind": "GpuConfig"},
    {"apiVersion": "resource.nvidia.com/v1beta1", "kind": "Bogus"},
    {"apiVersion": "resource.nvidia.com/v1beta1"},
], ids=["not an object", "no apiVersion", "unknown kind", "no kind"])
def test_bad_envelopes_raise_decode_error(params):
    jax_params = params
    if isinstance(params, dict) and "apiVersion" in params:
        jax_params = dict(params, apiVersion=jax_decode.API_VERSION)
    with pytest.raises(jax_decode.DecodeError):
        jax_decode.strict_decode(jax_params)
    with pytest.raises(pt_decode.DecodeError):
        pt_decode.strict_decode(params)


def test_nonstrict_decode_ignores_unknown_fields_as_the_reference():
    body = {"future": 1, "sharing": {"strategy": "TimeSlicing",
                                     "later": True}}
    jax_cfg = jax_decode.nonstrict_decode(_params("jax", body))
    pt_cfg = pt_decode.nonstrict_decode(_params("pt", body))
    assert _body(pt_decode.encode_config(pt_cfg)) == \
        _body(jax_decode.encode_config(jax_cfg)) == \
        {"sharing": {"strategy": "TimeSlicing"}}


# -- ResourceClaim.from_dict ------------------------------------------------

OURS, OTHER = "<ours>", "other.example.com"


def _random_claim(rng: random.Random, driver: str) -> dict:
    """A ResourceClaim object whose results and configs name this
    driver, another, or none."""
    def drv():
        pick = rng.choice([OURS, OURS, OTHER, None])
        return {} if pick is None else {
            "driver": driver if pick == OURS else pick}

    results = [{"request": rng.choice(["gpu", "a", "b"]), "pool": "node",
                "device": f"dev-{rng.randrange(8)}", **drv()}
               for _ in range(rng.randrange(0, 5))]
    config = []
    for _ in range(rng.randrange(0, 4)):
        entry = {"opaque": {"parameters": {"n": rng.randrange(100)},
                            **drv()}}
        if rng.random() < 0.5:
            entry["requests"] = rng.sample(["gpu", "a", "b"],
                                           rng.randrange(1, 3))
        if rng.random() < 0.7:
            entry["source"] = rng.choice(["FromClass", "FromClaim"])
        config.append(entry)
    meta = {"uid": f"uid-{rng.randrange(10**6)}", "name": "c"}
    if rng.random() < 0.5:
        meta["namespace"] = "team"
    if rng.random() < 0.5:
        meta["annotations"] = {"k": "v"}
    return {"metadata": meta, "status": {"allocation": {"devices": {
        "results": results, "config": config}}}}


def _claim_fields(claim) -> tuple:
    return (claim.uid, claim.namespace, claim.name,
            [(r.request, r.pool, r.device) for r in claim.results],
            [(c.parameters, c.requests, c.source) for c in claim.configs],
            claim.annotations)


@pytest.mark.parametrize("seed", range(8))
def test_claim_from_dict_equals_the_references(seed):
    jax_claim = JaxClaim.from_dict(_random_claim(random.Random(seed),
                                                 JAX_DRIVER))
    claim = ResourceClaim.from_dict(_random_claim(random.Random(seed),
                                                  DRIVER_NAME))
    assert _claim_fields(claim) == _claim_fields(jax_claim)
    assert all(r.driver in (DRIVER_NAME, "") for r in claim.results)
    assert DRIVER_NAME == "gpu.nvidia.com"


# -- the state machine ------------------------------------------------------

STATES = [None, "PrepareStarted", "PrepareCompleted"]


@pytest.mark.parametrize("old", STATES)
@pytest.mark.parametrize("new", STATES)
def test_two_phase_policy_equals_the_references(old, new):
    assert pt_sm.TWO_PHASE_POLICY.is_legal(old, new) == \
        jax_sm.TWO_PHASE_POLICY.is_legal(old, new)
    if not pt_sm.TWO_PHASE_POLICY.is_legal(old, new):
        with pytest.raises(pt_sm.CheckpointTransitionError) as err:
            pt_sm.TWO_PHASE_POLICY.validate("c", old, new)
        with pytest.raises(jax_sm.CheckpointTransitionError) as want:
            jax_sm.TWO_PHASE_POLICY.validate("c", old, new)
        assert str(err.value) == str(want.value)


def test_out_of_scope_change_is_refused():
    with pytest.raises(pt_sm.CheckpointTransitionError, match="outside"):
        pt_sm.TWO_PHASE_POLICY.validate_states(
            {}, {"a": "PrepareStarted"}, scope={"b"})


# -- the file lock ----------------------------------------------------------

def test_flock_wait_ends_at_its_timeout(tmp_path):
    # Another thread holds the lock: the wait ends after its timeout.
    path = str(tmp_path / "x.lock")
    holder, held, done = Flock(path), threading.Event(), threading.Event()

    def hold():
        with holder.acquire(timeout=5.0):
            held.set()
            done.wait(timeout=5.0)

    thread = threading.Thread(target=hold, daemon=True)
    thread.start()
    try:
        assert held.wait(timeout=5.0)
        with pytest.raises(FlockTimeoutError):
            Flock(path).acquire(timeout=0.05)
    finally:
        done.set()
        thread.join(timeout=5.0)
    assert not thread.is_alive()
    with Flock(path).acquire(timeout=1.0) as lock:
        assert lock.held
    assert not lock.held


def test_flock_refuses_reentry(tmp_path):
    lock = Flock(str(tmp_path / "x.lock"))
    with lock.acquire(timeout=1.0):
        with pytest.raises(FlockReentrantError):
            lock.acquire(timeout=1.0)


# -- oversubscribe (MigDeviceConfig <-> SubSliceConfig) ----------------------

OVERSUBSCRIBE_BODIES = {
    "absent": {},
    "true": {"oversubscribe": True},
    "false": {"oversubscribe": False},
    "with a default timeslice": {"oversubscribe": True, "sharing": {
        "strategy": "TimeSlicing", "timeSlicing": {"interval": "Default"}}},
    "with a timeslice": {"oversubscribe": True, "sharing": {
        "strategy": "TimeSlicing", "timeSlicing": {"interval": "Long"}}},
    "with MPS": {"oversubscribe": True, "sharing": {
        "strategy": "MultiTenancy", "multiTenancy": {"hbmLimit": "1Gi"}}},
    "false with MPS": {"oversubscribe": False, "sharing": {
        "strategy": "MultiTenancy", "multiTenancy": {"hbmLimit": "1Gi"}}},
}


@pytest.mark.parametrize("name", list(OVERSUBSCRIBE_BODIES))
def test_oversubscribe_decodes_and_validates_as_the_reference(name):
    body = OVERSUBSCRIBE_BODIES[name]
    outcomes = []
    for side, decode, kind in (("jax", jax_decode, "SubSliceConfig"),
                               ("pt", pt_decode, "MigDeviceConfig")):
        cfg = decode.strict_decode({"apiVersion": decode.API_VERSION,
                                    "kind": kind, **body})
        cfg.normalize()
        try:
            cfg.validate()
        except ValueError as e:
            outcomes.append(("refused", "oversubscribe" in str(e)))
            continue
        outcomes.append(("ok", cfg.oversubscribe,
                         _body(decode.encode_config(cfg))))
    assert outcomes[1] == outcomes[0]
