"""Strict and non-strict decoders of opaque device configs (the JAX
package's ``api/decode.py``; the upstream driver's ``api.go:46-57``).

The strict decoder refuses unknown fields (user input: claim
parameters); the non-strict one ignores them (checkpoint data, which a
newer schema may have written).
"""

from __future__ import annotations

from dataclasses import fields as dc_fields
from typing import Any, Type

from .configs import (ComputeDomainChannelConfig, ComputeDomainDaemonConfig,
                      GpuConfig, MigDeviceConfig, MultiTenancyConfig,
                      Sharing, TimeSlicingConfig, VfioDeviceConfig)

API_VERSION = "resource.nvidia.com/v1beta1"


class DecodeError(ValueError):
    pass


_KINDS: dict[str, Type] = {c.KIND: c for c in (
    GpuConfig, MigDeviceConfig, VfioDeviceConfig, ComputeDomainChannelConfig,
    ComputeDomainDaemonConfig)}

# JSON field name -> dataclass attribute, per type.
_FIELD_MAPS: dict[Type, dict[str, str]] = {
    GpuConfig: {"sharing": "sharing"},
    MigDeviceConfig: {"sharing": "sharing", "oversubscribe": "oversubscribe"},
    VfioDeviceConfig: {"iommuMode": "iommu_mode"},
    Sharing: {
        "strategy": "strategy",
        "timeSlicing": "time_slicing",
        "multiTenancy": "multi_tenancy",
    },
    TimeSlicingConfig: {"interval": "interval"},
    MultiTenancyConfig: {
        "maxClients": "max_clients",
        "hbmLimit": "hbm_limit",
        "perDeviceHbmLimits": "per_device_hbm_limits",
    },
    ComputeDomainChannelConfig: {
        "domainID": "domain_id",
        "allocationMode": "allocation_mode",
    },
    ComputeDomainDaemonConfig: {"domainID": "domain_id"},
}

_NESTED: dict[tuple[Type, str], Type] = {
    (GpuConfig, "sharing"): Sharing,
    (MigDeviceConfig, "sharing"): Sharing,
    (Sharing, "time_slicing"): TimeSlicingConfig,
    (Sharing, "multi_tenancy"): MultiTenancyConfig,
}


def _decode_into(cls: Type, data: dict, strict: bool, path: str) -> Any:
    if not isinstance(data, dict):
        raise DecodeError(
            f"{path}: expected object, got {type(data).__name__}")
    fmap = _FIELD_MAPS[cls]
    kwargs: dict[str, Any] = {}
    for json_key, value in data.items():
        if json_key not in fmap:
            if strict:
                raise DecodeError(f"{path}: unknown field {json_key!r}")
            continue
        attr = fmap[json_key]
        nested = _NESTED.get((cls, attr))
        if nested is not None and value is not None:
            value = _decode_into(nested, value, strict, f"{path}.{json_key}")
        kwargs[attr] = value
    return cls(**kwargs)


def decode_config(parameters: dict, strict: bool = True) -> Any:
    """The typed config of an opaque ``parameters`` object (with
    apiVersion and kind). Does not normalize or validate: the caller does
    both."""
    if not isinstance(parameters, dict):
        raise DecodeError("opaque parameters must be an object")
    api_version = parameters.get("apiVersion", "")
    if api_version != API_VERSION:
        raise DecodeError(
            f"unsupported apiVersion {api_version!r} (want {API_VERSION})")
    kind = parameters.get("kind", "")
    cls = _KINDS.get(kind)
    if cls is None:
        raise DecodeError(f"unknown config kind {kind!r}")
    body = {k: v for k, v in parameters.items()
            if k not in ("apiVersion", "kind")}
    return _decode_into(cls, body, strict, kind)


def strict_decode(parameters: dict) -> Any:
    """User input: unknown fields are errors."""
    return decode_config(parameters, strict=True)


def nonstrict_decode(parameters: dict) -> Any:
    """Checkpoint data: unknown fields are ignored."""
    return decode_config(parameters, strict=False)


def encode_config(cfg: Any) -> dict:
    """A typed config as its opaque parameters (decode's inverse)."""
    cls = type(cfg)
    rev = {attr: json_key for json_key, attr in _FIELD_MAPS[cls].items()}
    out: dict[str, Any] = {"apiVersion": API_VERSION}
    if hasattr(cls, "KIND"):
        out["kind"] = cls.KIND
    for f in dc_fields(cfg):
        value = getattr(cfg, f.name)
        if value is None:
            continue
        if (cls, f.name) in _NESTED:
            value = encode_config(value)
            value.pop("apiVersion", None)
        out[rev[f.name]] = value
    return out
