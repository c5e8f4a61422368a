"""The port's claim checkpoint against the JAX plugin's: the same claims
give the same document and the same bytes on disk; each side's manager
reads the file the other wrote (v2, and as a v1 reader); corruption,
illegal transitions and a changed boot id are met alike."""

import json
import random

import pytest

from k8s_dra_driver_gpu_tpu.kubeletplugin import checkpoint as jax_ckpt
from k8s_dra_driver_gpu_tpu.pkg.analysis.statemachine import \
    TWO_PHASE_POLICY as JAX_POLICY
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import checkpoint as pt_ckpt

BOOT = "boot-0"
SIDES = {"jax": jax_ckpt, "pt": pt_ckpt}


def _manager(side: str, root: str, boot_id: str = BOOT):
    """A side's manager under its two-phase policy (the port's always
    holds to it; the reference's takes it as an option)."""
    if side == "jax":
        return jax_ckpt.CheckpointManager(root, boot_id=boot_id,
                                          transition_policy=JAX_POLICY)
    return pt_ckpt.CheckpointManager(root, boot_id=boot_id)


def _write_legally(module, manager, claim) -> None:
    """absent -> PrepareStarted (-> PrepareCompleted)."""
    started = module.CheckpointedClaim.from_dict(
        dict(claim.to_dict(), state="PrepareStarted"))
    manager.update_claim(claim.uid, started)
    manager.update_claim(claim.uid, claim)


def _device_name(side: str, index: int) -> str:
    return f"chip-{index}" if side == "jax" else f"gpu-{index}"


def _cdi_id(side: str, index: int) -> str:
    if side == "jax":
        return f"k8s.tpu.dra.dev/claim=chip-{index}"
    return f"nvidia.com/gpu=gpu-{index}"


def _random_claims(rng: random.Random, side: str) -> list:
    """Claim records of random uids, states, names and devices."""
    module = SIDES[side]
    claims = []
    for n in range(rng.randrange(1, 5)):
        state = rng.choice(["PrepareStarted", "PrepareCompleted"])
        devices = [module.CheckpointedDevice(
            canonical_name=_device_name(side, i), kind="chip",
            cdi_device_ids=([_cdi_id(side, i)]
                            if state == "PrepareCompleted" else []))
            for i in sorted(rng.sample(range(8), rng.randrange(0, 3)))]
        claims.append(module.CheckpointedClaim(
            uid=f"uid-{n}-{rng.randrange(10**6)}",
            namespace=rng.choice(["", "default", "team"]),
            name=rng.choice(["", f"claim-{n}"]), state=state,
            devices=devices))
    return claims


def _to_port_names(obj):
    """A JAX document with its device names and CDI ids in the port's."""
    text = json.dumps(obj).replace("k8s.tpu.dra.dev/claim=chip-",
                                   "nvidia.com/gpu=gpu-")
    return json.loads(text.replace('"chip-', '"gpu-'))


@pytest.mark.parametrize("seed", range(8))
def test_document_equals_the_references(seed):
    docs = {}
    for side, module in SIDES.items():
        cp = module.Checkpoint(node_boot_id=BOOT, claims={
            c.uid: c for c in _random_claims(random.Random(seed), side)})
        docs[side] = cp.to_dict()
    assert docs["pt"]["data"] == _to_port_names(docs["jax"]["data"])
    # Each checksum is over its own data: recomputed from the mapped
    # data, the reference's equal the port's.
    mapped = jax_ckpt.Checkpoint.from_dict({
        "version": "v2", "data": _to_port_names(docs["jax"]["data"])})
    assert mapped.to_dict() == docs["pt"]


@pytest.mark.parametrize("seed", range(6))
def test_file_bytes_equal_the_references(tmp_path, seed):
    # The same claims (under the same names) written by each manager:
    # the same bytes on disk.
    files = {}
    for side, module in SIDES.items():
        manager = _manager(side, str(tmp_path / side))
        for claim in _random_claims(random.Random(seed), "pt"):
            _write_legally(module, manager,
                           module.CheckpointedClaim.from_dict(
                               claim.to_dict()))
        with open(manager.path, "rb") as f:
            files[side] = f.read()
    assert files["pt"] == files["jax"]


@pytest.mark.parametrize("writer", ["jax", "pt"])
@pytest.mark.parametrize("seed", range(3))
def test_each_reads_the_others_file(tmp_path, writer, seed):
    module = SIDES[writer]
    manager = _manager(writer, str(tmp_path))
    claims = _random_claims(random.Random(seed), writer)
    for claim in claims:
        _write_legally(module, manager, claim)
    want = {c.uid: c.to_dict() for c in claims}
    for reader in SIDES:
        got = _manager(reader, str(tmp_path)).get()
        assert got.node_boot_id == BOOT
        assert {uid: c.to_dict() for uid, c in got.claims.items()} == want


@pytest.mark.parametrize("seed", range(3))
def test_v1_readers_accept_a_v2_file_and_a_v1_file(tmp_path, seed):
    cp = pt_ckpt.Checkpoint(node_boot_id=BOOT, claims={
        c.uid: c for c in _random_claims(random.Random(seed), "pt")})
    doc = json.loads(cp.to_json())
    as_v1 = dict(doc, version="v1")  # a v2 file read by a v1 binary
    v1_only = {"version": "v1", "data": cp._payload_v1(),
               "checksums": {"v1": doc["checksums"]["v1"]}}
    for module in SIDES.values():
        for d in (as_v1, v1_only):
            got = module.Checkpoint.from_dict(d)
            assert {uid: c.to_dict_v1() for uid, c in got.claims.items()} \
                == {uid: c.to_dict_v1() for uid, c in cp.claims.items()}


TAMPER = {
    "state": lambda d: d["data"]["claims"]["c1"].__setitem__("state",
                                                             "Tampered"),
    "device": lambda d: d["data"]["claims"]["c1"]["devices"][0].__setitem__(
        "canonicalName", "gpu-7"),
    "boot id": lambda d: d["data"].__setitem__("nodeBootID", "other"),
    "checksum": lambda d: d["checksums"].__setitem__("v2", 1),
}


@pytest.mark.parametrize("how", sorted(TAMPER))
def test_corruption_is_detected_as_by_the_reference(tmp_path, how):
    claim = pt_ckpt.CheckpointedClaim(
        uid="c1", state="PrepareCompleted",
        devices=[pt_ckpt.CheckpointedDevice(
            canonical_name="gpu-0", kind="chip",
            cdi_device_ids=["nvidia.com/gpu=gpu-0"])])
    doc = json.loads(pt_ckpt.Checkpoint(
        node_boot_id=BOOT, claims={"c1": claim}).to_json())
    TAMPER[how](doc)
    messages = []
    for module in SIDES.values():
        with pytest.raises(module.CheckpointCorruptError) as err:
            module.Checkpoint.from_dict(doc)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    # Through the manager: the file on disk is refused on read.
    (tmp_path / "checkpoint.json").write_text(json.dumps(doc))
    with pytest.raises(pt_ckpt.CheckpointCorruptError):
        pt_ckpt.CheckpointManager(str(tmp_path), boot_id=BOOT)


def test_illegal_transition_is_refused_and_not_written(tmp_path):
    manager = _manager("pt", str(tmp_path))
    done = pt_ckpt.CheckpointedClaim(uid="c1", state="PrepareCompleted")
    from k8s_dra_driver_gpu_tpu_torch.pkg.statemachine import \
        CheckpointTransitionError
    with pytest.raises(CheckpointTransitionError):
        manager.update_claim("c1", done)
    assert manager.get().claims == {}
    with open(manager.path) as f:
        assert json.load(f)["data"]["claims"] == {}


@pytest.mark.parametrize("writer", ["jax", "pt"])
def test_a_changed_boot_id_drops_the_claims(tmp_path, writer):
    module = SIDES[writer]
    manager = _manager(writer, str(tmp_path), boot_id="boot-1")
    manager.update_claim("c1", module.CheckpointedClaim(uid="c1"))
    for reader in SIDES:
        root = tmp_path / reader
        root.mkdir()
        (root / "checkpoint.json").write_bytes(
            (tmp_path / "checkpoint.json").read_bytes())
        again = _manager(reader, str(root), boot_id="boot-2")
        assert again.invalidated_on_boot
        assert again.get().claims == {}
        assert again.get().node_boot_id == "boot-2"
