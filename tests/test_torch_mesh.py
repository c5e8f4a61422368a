"""The port's device meshes against the reference's: the mesh planner
(``plan_for``, ``_factor``) case by case, and the mesh builders' names,
shapes and rank order in one 4-rank gloo gang (``tests/torch_gang.py``,
worker ``meshes``) against ``jax.sharding.Mesh`` over 4 CPU devices."""

import itertools

import jax
import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu.parallel import mesh as jax_mesh
from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pt_mesh
from tests import torch_gang

WORLD = 4


def _plan(module, n, tp, sp):
    try:
        plan = module.plan_for(n, tp=tp, sp=sp)
    except ValueError as err:
        return "raises", str(err)
    return plan.shape(), plan.axis_names(), plan.size


@pytest.mark.parametrize("n,tp,sp", itertools.product(
    range(1, 65), (None, 1, 2, 3, 4), (1, 2)))
def test_plan_for_matches_reference(n, tp, sp):
    assert _plan(pt_mesh, n, tp, sp) == _plan(jax_mesh, n, tp, sp)


@pytest.mark.parametrize("n,max_tp", [(n, m) for n in (1, 6, 8, 24, 48, 64)
                                      for m in (1, 2, 4)])
def test_factor_matches_reference(n, max_tp):
    got = pt_mesh._factor(n, max_tp)
    want = jax_mesh._factor(n, max_tp)
    assert (got.dp, got.fsdp, got.tp, got.sp) == (
        want.dp, want.fsdp, want.tp, want.sp)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    out = tmp_path_factory.mktemp("meshes")
    torch_gang.run_gang("meshes", WORLD, out)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _reference():
    devices = jax.devices()[:WORLD]
    return {
        "default": jax_mesh.build_mesh(devices=devices),
        "dp2_tp2": jax_mesh.build_mesh(jax_mesh.MeshPlan(dp=2, tp=2),
                                       devices=devices),
        "multislice2": jax_mesh.build_multislice_mesh(2, devices=devices),
        "pipeline2": jax_mesh.build_pipeline_mesh(2, devices=devices),
        "topology_2x2": jax_mesh.mesh_from_topology("2x2"),
        "topology_2x2_tp2": jax_mesh.mesh_from_topology("2x2", tp=2),
    }


@pytest.mark.parametrize("label", ["default", "dp2_tp2", "multislice2",
                                   "pipeline2", "topology_2x2",
                                   "topology_2x2_tp2"])
def test_mesh_names_shapes_and_order_match_reference(gang, label):
    want = _reference()[label]
    ids = np.vectorize(lambda d: d.id)(want.devices)
    for rank in gang:
        got = rank[label]
        assert got["names"] == tuple(want.axis_names)
        assert got["shape"] == want.devices.shape
        assert got["ranks"] == (ids - ids.min()).tolist()
        # The compute mesh keeps the dims larger than one, in order.
        keep = tuple(n for n, size in zip(got["names"], got["shape"])
                     if size > 1) or got["names"][:1]
        assert got["compute_names"] == keep


def test_plan_of_the_wrong_size_is_refused(gang):
    for rank in gang:
        assert rank["mismatch_error"] == (
            "mesh plan (3, 1, 1, 1) needs 3 devices, have 4")


@pytest.mark.parametrize("spec,want", [
    (("tp", "fsdp"), ["R", "S(1)", "S(0)"]),
    ((None, ("dp", "fsdp")), ["S(1)", "S(1)", "R"]),
    ((None, None), ["R", "R", "R"]),
])
def test_placements_of_a_spec(spec, want):
    class Mesh:
        mesh_dim_names = ("dp", "fsdp", "tp")

    assert [str(p) for p in pt_mesh.placements(spec, Mesh())] == want
