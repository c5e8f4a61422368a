"""The port's CEL evaluator (``pkg/cel.py``) against the JAX package's.

Every string literal of ``tests/test_cel.py`` and
``tests/test_cel_attribute_consistency.py`` (the grammar cases, the
refused ones and the rest), every selector ``tests/test_cel.py`` reads
from the chart and the demo specs, and the JAX chart's five DeviceClass
selectors are compiled on both sides and evaluated over the same
devices: the JAX mock's published chips, sub-slices and CD devices, the
port's whole GPUs, MIG devices and CD devices, and devices made from a
seed with numpy. Both sides give equal values, or the same error class
at compile or at evaluation.

The port's five DeviceClasses (``api/deviceclasses.py``) each select
exactly their kind over the port's published mock slices.
"""

import ast
import pathlib
import types

import numpy as np
import pytest

from k8s_dra_driver_gpu_tpu.pkg import cel as jax_cel
from k8s_dra_driver_gpu_tpu.pkg.chartrender import manifests, render_chart
from k8s_dra_driver_gpu_tpu_torch.api import deviceclasses as pt_classes
from k8s_dra_driver_gpu_tpu_torch.computedomain import (
    COMPUTE_DOMAIN_DRIVER_NAME as PT_CD)
from k8s_dra_driver_gpu_tpu_torch.computedomain.plugin.device_state import (
    CDDeviceState as PtCDDeviceState)
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME as PT_GPU
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.pkg import cel as pt_cel
from tests.test_cel import shipped_expressions

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHART = ROOT / "deployments" / "helm" / "tpu-dra-driver"


def _literals(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text())
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)]


def chart_selectors() -> list[str]:
    return [sel["cel"]["expression"]
            for doc in manifests(render_chart(str(CHART)))
            if doc.get("kind") == "DeviceClass"
            for sel in doc["spec"]["selectors"]]


EXPRESSIONS = sorted(set(
    _literals(ROOT / "tests" / "test_cel.py")
    + _literals(ROOT / "tests" / "test_cel_attribute_consistency.py")
    + shipped_expressions() + chart_selectors()))


def _random_devices(seed: int, n: int) -> list[tuple[dict, str]]:
    """Devices of random typed attributes and quantities: the names the
    expressions read (platform, iciX, ...) with values of every type."""
    rng = np.random.default_rng(seed)
    names = ["platform", "iciX", "iciY", "healthy", "ver", "profile",
             "passthrough", "type", "uuid", "productName", "x", "name"]
    values = [{"string": "v5e"}, {"string": "v5p"}, {"string": "channel"},
              {"string": "daemon"}, {"string": "2x1x1"}, {"string": "1c"},
              {"string": ""}, {"int": 0}, {"int": 3}, {"int": "3"},
              {"bool": True}, {"bool": False}, {"version": "10.0.0"},
              {"version": "2.0.0-beta"}, {"version": "9.1.0"}]
    quantities = ["1Gi", "16Gi", "100", "1500m", "85899345920", "2k"]
    drivers = ["tpu.dra.dev", "compute-domain.tpu.dra.dev", PT_GPU, PT_CD,
               "d", "other"]
    out = []
    for i in range(n):
        picked = rng.choice(len(names), size=rng.integers(0, 6),
                            replace=False)
        attrs = {names[j]: values[rng.integers(len(values))]
                 for j in picked}
        capacity = {"memory": {"value": quantities[rng.integers(
            len(quantities))]}} if rng.random() < 0.7 else {}
        out.append(({"name": f"dev-{i}", "attributes": attrs,
                     "capacity": capacity},
                    drivers[rng.integers(len(drivers))]))
    return out


@pytest.fixture(scope="module")
def devices(tmp_path_factory) -> list[tuple[dict, str]]:
    from k8s_dra_driver_gpu_tpu.computedomain.plugin.device_state import (
        CDDeviceState as JaxCDDeviceState)
    from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
    from k8s_dra_driver_gpu_tpu.pkg.kubeclient import FakeKubeClient

    base = tmp_path_factory.mktemp("cel")
    out = []
    for topo in ("v5e-4", "v5p-8"):
        st = jax_ds.DeviceState(jax_ds.Config.mock(
            root=str(base / topo), topology=topo))
        out += [(d.to_dra_device(), "tpu.dra.dev")
                for d in st.allocatable.values()]
    cd = JaxCDDeviceState(str(base / "cd"), FakeKubeClient(), "n0",
                          use_informer=False)
    out += [(d, "compute-domain.tpu.dra.dev")
            for d in cd.allocatable_devices()[:3]]
    out += [(d, PT_GPU) for d in port_gpu_devices(base)]
    out += [(d, PT_CD) for d in port_cd_devices()[:3]]
    return out + _random_devices(0, 40)


def port_gpu_devices(base) -> list[dict]:
    """The port's published whole GPUs and MIG devices (h100-4, MIG on)."""
    whole = pt_ds.DeviceState(pt_ds.Config.mock(
        str(base / "pt-gpu"), "h100-4"))
    mig = pt_ds.DeviceState(pt_ds.Config.mock(
        str(base / "pt-mig"), "h100-4", "DynamicSubSlice=true",
        mig_mode="enabled"))
    return whole.dra_devices() + [
        d for d in mig.dra_devices() if "-mig-" in d["name"]]


def port_cd_devices() -> list[dict]:
    return PtCDDeviceState.allocatable_devices(
        types.SimpleNamespace(clique_id="clique-0"))


def _compile(module, expr):
    try:
        return module.compile_expression(expr), None
    except Exception as err:  # noqa: BLE001 - the class is compared
        return None, type(err).__name__


def _run(fn):
    try:
        value = fn()
    except Exception as err:  # noqa: BLE001 - the class is compared
        return ("error", type(err).__name__)
    if isinstance(value, pt_cel.Quantity) or \
            isinstance(value, jax_cel.Quantity):
        return ("quantity", value.milli)
    if isinstance(value, (pt_cel.SemVer, jax_cel.SemVer)):
        return ("semver", str(value))
    return (type(value).__name__, value)


def _env(device: dict, driver: str) -> dict:
    return {"device": {
        "driver": driver,
        "attributes": {driver: dict(device.get("attributes", {}))},
        "capacity": {driver: dict(device.get("capacity", {}))},
    }}


def test_the_expressions_cover_the_sources():
    assert len(EXPRESSIONS) > 100
    assert all(e in EXPRESSIONS for e in chart_selectors())
    assert 'quantity("1Gi")' in " ".join(EXPRESSIONS)


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_same_answers(expr, devices):
    """Equal: the compile outcome, the value with no env, and for each
    device ``matches_device`` and the raw value."""
    (jp, jerr), (pp, perr) = _compile(jax_cel, expr), _compile(pt_cel, expr)
    assert perr == jerr
    if jp is None:
        return
    assert _run(lambda: pp.evaluate({})) == _run(lambda: jp.evaluate({}))
    for dev, driver in devices:
        assert pp.matches_device(dev, driver) == \
            jp.matches_device(dev, driver), (dev, driver)
        env = _env(dev, driver)
        assert _run(lambda: pp.evaluate(env)) == \
            _run(lambda: jp.evaluate(env)), (dev, driver)


@pytest.mark.parametrize("text", [
    "0", "1", "1.5", "100m", "1Gi", "1G", "1Ki", "2k", "-3", "+4Mi",
    "0.5Ti", "1e3", "Gi", "", "1.5.5", "7Ei", "3P"])
def test_quantities_parse_alike(text):
    assert _run(lambda: pt_cel.Quantity.parse(text)) == \
        _run(lambda: jax_cel.Quantity.parse(text))


def test_port_device_classes_select_exactly_their_kind(tmp_path):
    gpus = port_gpu_devices(tmp_path)
    whole = {d["name"] for d in gpus if "-mig-" not in d["name"]}
    migs = {d["name"] for d in gpus if "-mig-" in d["name"]}
    cds = port_cd_devices()
    assert whole and migs and len(cds) == 129
    published = [(d, PT_GPU) for d in gpus] + [(d, PT_CD) for d in cds]
    want = {
        pt_classes.GPU_CLASS: whole,
        pt_classes.MIG_CLASS: migs,
        pt_classes.VFIO_CLASS: set(),
        pt_classes.CHANNEL_CLASS: {d["name"] for d in cds
                                   if d["name"].startswith("channel-")},
        pt_classes.DAEMON_CLASS: {"daemon"},
    }
    classes = pt_classes.device_classes()
    assert [c["metadata"]["name"] for c in classes] == list(want)
    for cls in classes:
        (sel,) = cls["spec"]["selectors"]
        prog = pt_cel.compile_expression(sel["cel"]["expression"])
        got = {d["name"] for d, drv in published
               if prog.matches_device(d, drv)}
        assert got == want[cls["metadata"]["name"]], cls


def test_the_port_classes_are_the_charts_moved_to_the_port_drivers():
    jax = chart_selectors()
    moved = [e.replace("compute-domain.tpu.dra.dev", PT_CD)
             .replace("tpu.dra.dev", PT_GPU) for e in jax]
    assert moved == list(pt_classes.SELECTORS.values())
