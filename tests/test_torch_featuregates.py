"""The port's feature gates against the JAX package's: the same gate
names and defaults, and for every spec string the same answer where the
port reads it (the GPU plugin's gates and the ComputeDomain daemon's).
The port refuses every spec the JAX package refuses; a spec it accepts
and the JAX package refuses sets a gate the port does not read
(``unported()``), which the GPU plugin refuses at construction."""

import pytest

from k8s_dra_driver_gpu_tpu.pkg import featuregates as jax_fg
from k8s_dra_driver_gpu_tpu_torch.pkg import featuregates as pt_fg

SPECS = [
    "",
    " , ,",
    "TimeSlicingSettings=true",
    "TimeSlicingSettings=TRUE, MultiTenancySupport=True",
    "TimeSlicingSettings=false",
    # MultiTenancySupport needs TimeSlicingSettings.
    "MultiTenancySupport=true",
    "MultiTenancySupport=true,TimeSlicingSettings=false",
    # PassthroughSupport excludes DynamicSubSlice.
    "PassthroughSupport=true",
    "PassthroughSupport=true,DynamicSubSlice=true",
    "DynamicSubSlice=true",
    # TenantPartitioning needs DynamicSubSlice.
    "TenantPartitioning=true",
    "TenantPartitioning=true,DynamicSubSlice=true",
    "ChipHealthCheck=false,TopologyAwarePlacement=false,DeviceMetadata=true",
    "DomainDaemonsWithDNSNames=false,ComputeDomainCliques=false,"
    "CrashOnICIFabricErrors=false",
    # At their defaults the gates the port does not read are no refusal.
    "ChipHealthCheck=true,DeviceMetadata=false,DynamicSubSlice=false",
    # The later entry of a gate wins.
    "TimeSlicingSettings=true,TimeSlicingSettings=false",
    # Unknown gates and bad values.
    "MPSSupport=true",
    "DynamicMIG=true",
    "timeslicingsettings=true",
    "TimeSlicingSettings",
    "TimeSlicingSettings=yes",
    "TimeSlicingSettings=1",
    "TimeSlicingSettings=",
    "=true",
    " TimeSlicingSettings = true ",
]


def _outcome(module, spec):
    try:
        gates = module.FeatureGates.parse(spec)
    except module.FeatureGateError as err:
        return "refused", str(err)
    return "ok", {name: gates.is_enabled(name) for name in pt_fg.DEFAULTS}


def test_the_same_gates_with_the_same_defaults():
    assert pt_fg.DEFAULTS == {name: spec.default for name, spec
                              in jax_fg.KNOWN_FEATURES.items()}
    assert set(pt_fg.READ) == {jax_fg.TIME_SLICING_SETTINGS,
                               jax_fg.MULTI_TENANCY_SUPPORT,
                               jax_fg.DYNAMIC_SUB_SLICE,
                               jax_fg.TENANT_PARTITIONING,
                               jax_fg.COMPUTE_DOMAIN_CLIQUES,
                               jax_fg.DOMAIN_DAEMONS_WITH_DNS_NAMES,
                               jax_fg.TOPOLOGY_AWARE_PLACEMENT}
    assert jax_fg.KNOWN_FEATURES[pt_fg.MULTI_TENANCY_SUPPORT].requires == (
        pt_fg.TIME_SLICING_SETTINGS,)
    # Each dependency the port enforces is the JAX package's.
    for gate, needed in pt_fg.REQUIRES.items():
        assert jax_fg.KNOWN_FEATURES[gate].requires == (needed,)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_the_references(spec):
    got, want = _outcome(pt_fg, spec), _outcome(jax_fg, spec)
    if got[0] == "ok" and pt_fg.FeatureGates.parse(spec).unported():
        # Refused by the GPU plugin; where the JAX package takes it, it
        # reads it the same.
        assert want[0] == "refused" or want == got
        return
    assert got == want


@pytest.mark.parametrize("spec, unported", [
    ("", []),
    ("TimeSlicingSettings=true,MultiTenancySupport=true", []),
    ("ChipHealthCheck=true,TopologyAwarePlacement=true", []),
    ("ChipHealthCheck=false", ["ChipHealthCheck"]),
    ("DeviceMetadata=true,TimeSlicingSettings=true,DynamicSubSlice=true",
     ["DeviceMetadata"]),
    ("TenantPartitioning=true,DynamicSubSlice=true", []),
])
def test_unported_names_the_gates_set_away_from_their_default(spec,
                                                              unported):
    assert pt_fg.FeatureGates.parse(spec).unported() == unported


def test_an_unknown_gate_is_refused_by_is_enabled():
    with pytest.raises(pt_fg.FeatureGateError, match="MPSSupport"):
        pt_fg.FeatureGates().is_enabled("MPSSupport")


def test_tenant_partitioning_needs_dynamic_sub_slice_as_the_reference():
    for module in (pt_fg, jax_fg):
        with pytest.raises(module.FeatureGateError,
                           match="TenantPartitioning requires "
                                 "DynamicSubSlice"):
            module.FeatureGates.parse("TenantPartitioning=true")
        gates = module.FeatureGates.parse(
            "TenantPartitioning=true,DynamicSubSlice=true")
        assert gates.is_enabled("TenantPartitioning")
    # Read by the port: no refusal at construction.
    assert pt_fg.TENANT_PARTITIONING in pt_fg.READ
