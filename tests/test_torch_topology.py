"""The port's ICI topology engine (``pkg/topology``) against the JAX
package's, over the JAX mock slices ``v5e-4``, ``v5e-16`` and ``v5p-32``
(each host's published chips, and the whole slice from every host's
chips), with free sets drawn from a seed with numpy: ``TorusGrid``, the
shapes and their placements, ``rank_placements``, ``order_candidates``,
``largest_free_shape``, ``fragmentation_score``, ``set_compactness`` and
``rank_adjacent_hosts`` give equal results. On devices without
coordinates (the port's published GPUs) there is no order
(``order_candidates`` gives None) and the scheduler keeps first-fit."""

import numpy as np
import pytest

from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
from k8s_dra_driver_gpu_tpu.pkg import topology as jax_topo
from k8s_dra_driver_gpu_tpu.pkg.topology import score as jax_score
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.pkg import topology as pt_topo
from k8s_dra_driver_gpu_tpu_torch.pkg.topology import grid as pt_grid
from k8s_dra_driver_gpu_tpu_torch.pkg.topology import score as pt_score

TOPOLOGIES = ("v5e-4", "v5e-16", "v5p-32")
SEEDS = range(4)


def _host_devices(root, topo: str, worker: int) -> list[dict]:
    st = jax_ds.DeviceState(jax_ds.Config.mock(
        str(root / f"{topo}-{worker}"), topo, worker_id=worker, gates=""))
    return [d.to_dra_device() for d in st.allocatable.values()]


@pytest.fixture(scope="module")
def slices(tmp_path_factory) -> dict:
    """topology -> [host devices of each worker]; the chips of worker w
    renamed ``w<w>-<name>`` in the whole-slice list."""
    root = tmp_path_factory.mktemp("topo")
    out = {}
    for topo in TOPOLOGIES:
        first = _host_devices(root, topo, 0)
        hosts = [first] + [_host_devices(root, topo, w) for w in range(
            1, first[0]["attributes"]["numHosts"]["int"])]
        out[topo] = hosts
    return out


def _whole(hosts: list[list[dict]]) -> list[dict]:
    return [dict(d, name=f"w{w}-{d['name']}")
            for w, devs in enumerate(hosts) for d in devs]


def _grids(devices):
    return (jax_topo.TorusGrid.from_devices(devices),
            pt_topo.TorusGrid.from_devices(devices))


def _fields(grid):
    return (grid.dims, grid.wrap, dict(grid.coords), grid.uncoordinated)


def _pools(slices, topo):
    hosts = slices[topo]
    return [("host0", hosts[0]), ("whole", _whole(hosts))]


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_grids_are_equal(slices, topo):
    for _, devices in _pools(slices, topo):
        jg, pg = _grids(devices)
        assert _fields(pg) == _fields(jg)
        assert pt_grid.parse_dims(devices[0]["attributes"]["topology"][
            "string"]) == jg.dims
        assert pt_topo.default_wrap(
            devices[0]["attributes"]["platform"]["string"], jg.dims) == \
            jax_topo.default_wrap(
                devices[0]["attributes"]["platform"]["string"], jg.dims)
    assert len(_whole(slices[topo])) == jg.dims[0] * jg.dims[1] * jg.dims[2]


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_shapes_and_placements_are_equal(slices, topo):
    jg, pg = _grids(_whole(slices[topo]))
    total = jg.dims[0] * jg.dims[1] * jg.dims[2]
    assert pt_topo.enumerate_shapes(pg) == jax_topo.enumerate_shapes(jg)
    for cap in range(1, total + 1):
        assert pt_topo.enumerate_shapes(pg, cap) == \
            jax_topo.enumerate_shapes(jg, cap)
        assert pt_topo.shapes_for_count(pg, cap) == \
            jax_topo.shapes_for_count(jg, cap)
    for shape in jax_topo.enumerate_shapes(jg):
        assert pt_topo.placements(pg, shape) == \
            jax_topo.placements(jg, shape)


def _free_names(rng, names, frac):
    keep = rng.random(len(names)) < frac
    return [n for n, k in zip(names, keep) if k]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_scoring_is_equal_over_random_free_sets(slices, topo, seed):
    rng = np.random.default_rng([seed, TOPOLOGIES.index(topo)])
    for _, devices in _pools(slices, topo):
        jg, pg = _grids(devices)
        names = [d["name"] for d in devices]
        for frac in (1.0, 0.75, 0.5, 0.3):
            free = _free_names(rng, names, frac)
            # Shuffled: the order of the caller's names must not matter
            # to the ranking, and the tail keeps it on both sides.
            free = [free[i] for i in rng.permutation(len(free))]
            cells = {jg.coords[n] for n in free}
            assert pt_topo.largest_free_shape(pg, cells) == \
                jax_topo.largest_free_shape(jg, cells)
            assert pt_topo.fragmentation_score(pg, cells) == \
                jax_topo.fragmentation_score(jg, cells)
            assert pt_topo.set_compactness(pg, cells) == \
                jax_topo.set_compactness(jg, cells)
            penalties = {n: int(rng.integers(0, 5)) for n in free
                         if rng.random() < 0.2} or None
            for want in sorted({1, 2, 3, 4, 8, len(free), len(free) + 1}):
                assert pt_topo.rank_placements(pg, free, want) == \
                    jax_topo.rank_placements(jg, free, want)
                assert pt_topo.order_candidates(pg, free, want) == \
                    jax_topo.order_candidates(jg, free, want)
                assert pt_topo.order_candidates(
                    pg, free, want, penalties=penalties) == \
                    jax_topo.order_candidates(jg, free, want,
                                              penalties=penalties)


@pytest.mark.parametrize("seed", SEEDS)
def test_adjacent_hosts_rank_alike(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(0, 9))
        workers = {f"h{i}": int(w) for i, w in enumerate(
            rng.integers(0, 12, size=n))}
        for gang in range(0, n + 2):
            assert pt_topo.rank_adjacent_hosts(workers, gang) == \
                jax_topo.rank_adjacent_hosts(workers, gang)


def test_headroom_penalties_are_equal():
    devices = [
        {"name": "a"},
        {"name": "b", "taints": [{"key": "x/power_cap_throttle"}]},
        {"name": "c", "attributes": {"telemetryPowerWatts": {"int": 95},
                                     "powerRatedWatts": {"int": 100}}},
        {"name": "d", "attributes": {"telemetryTempCelsius": {"int": 90}}},
        {"name": "e", "taints": [{"key": "thermal_drift"}],
         "attributes": {"telemetryTempCelsius": {"int": 50}}},
    ]
    for dev in devices:
        for limit in (None, 0.0, 60.0):
            assert pt_score.device_headroom_penalty(dev, limit) == \
                jax_score.device_headroom_penalty(dev, limit)
    assert pt_score.frag_from_largest(4, 8) == \
        jax_score.frag_from_largest(4, 8)


def test_uncoordinated_gpus_keep_first_fit(tmp_path):
    """The port's GPUs publish no iciX/iciY: every device is
    uncoordinated, no placement ranks, and the order is the caller's."""
    devices = pt_ds.DeviceState(pt_ds.Config.mock(
        str(tmp_path), "h100-8")).dra_devices()
    jg, pg = _grids(devices)
    names = [d["name"] for d in devices]
    assert _fields(pg) == _fields(jg)
    assert pg.coords == {} and list(pg.uncoordinated) == names
    for want in (1, 2, 4, 8):
        assert pt_topo.order_candidates(pg, names, want) is None
        assert jax_topo.order_candidates(jg, names, want) is None
