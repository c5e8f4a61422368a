"""The tenant-profile store and profile-guided partition sizing (MISO;
the JAX package's ``pkg/partition/profiles.py``).

MISO (2207.11428) sizes MIG partitions by profiling each tenant's
demand and choosing the smallest partition that satisfies it:

- :class:`TenantProfileStore` records the observed memory and core
  demand of each tenant key (a DeviceClass name or the claim annotation
  ``resource.tpu.dra/tenant-profile``) over a sliding time window and
  answers percentile queries. It seeds from a static profile file and
  from :data:`DEFAULT_TENANT_DEMANDS`, so sizing works before any live
  observation.
- :class:`SizingPolicy` picks the smallest profile of a catalog whose
  per-tenant budget covers the demand percentile (memory first, then
  cores).

The store is pure state with a JSON file form: the node plugin (its
health poll's tenant-usage feed) and the autoscale controller each keep
one. Its keys, fields and the ``TPU_DRA_PROFILE_WINDOW_S`` knob are the
JAX package's; ``hbm_bytes`` names the card's memory.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass

from .. import positive_float_env
from .spec import PartitionDemand, PartitionProfile, PartitionSpecError


def _default_window_s() -> float:
    """The demand window (``TPU_DRA_PROFILE_WINDOW_S``, default 3600 s):
    percentile reads count only samples this recent, so a burst that has
    decayed stops inflating the sized profile once its samples age out.
    0 counts all history."""
    return positive_float_env("TPU_DRA_PROFILE_WINDOW_S",
                              default=3600.0, floor=0.0)


#: Claim annotation naming the tenant profile a claim belongs to.
TENANT_PROFILE_ANNOTATION = "resource.tpu.dra/tenant-profile"

#: Cold-start priors (memory bytes, cores) a tenant key answers with
#: before any observation; live samples supersede them. The JAX
#: package's values, kept so both packages size a cold tenant alike.
DEFAULT_TENANT_DEMANDS: dict[str, PartitionDemand] = {
    "serving-small": PartitionDemand(hbm_bytes=2 << 30, cores=1,
                                     tenant="serving-small"),
    "serving-medium": PartitionDemand(hbm_bytes=6 << 30, cores=1,
                                      tenant="serving-medium"),
    "serving-large": PartitionDemand(hbm_bytes=12 << 30, cores=1,
                                     tenant="serving-large"),
}

_MAX_SAMPLES = 4096  # per tenant key


def _percentile_index(n: int, percentile: float) -> int:
    return min(n - 1, max(0, int(percentile * n + 0.5) - 1))


class TenantProfileStore:
    """Observed demand samples per tenant key, with percentile reads.
    Thread-safe: the health poll writes while the planner reads."""

    def __init__(self, defaults: dict[str, PartitionDemand] | None = None,
                 window_s: float | None = None):
        self._lock = threading.Lock()
        # tenant key -> (ts, bytes) samples in arrival order, bounded by
        # count and aged by the window; and the core demand.
        self._hbm: dict[str, list[tuple[float, int]]] = {}
        self._cores: dict[str, int] = {}
        self.window_s = (_default_window_s() if window_s is None
                         else max(float(window_s), 0.0))
        defaults = (DEFAULT_TENANT_DEMANDS if defaults is None
                    else defaults)
        now = time.time()
        for key, demand in defaults.items():
            self._hbm[key] = [(now, demand.hbm_bytes)]
            self._cores[key] = demand.cores

    def observe(self, tenant: str, hbm_bytes: int, cores: int = 1,
                now: float | None = None) -> None:
        """Fold one declared or derived demand sample into the tenant's
        window. Eviction is by arrival (the count bound) and by age, not
        by size, so a tenant whose working set shrinks sees its
        percentiles come down. ``now`` is the tests' clock."""
        if not tenant or hbm_bytes < 0:
            return
        ts = time.time() if now is None else float(now)
        with self._lock:
            samples = self._hbm.setdefault(tenant, [])
            samples.append((ts, hbm_bytes))
            if len(samples) > _MAX_SAMPLES:
                samples.pop(0)
            self._cores[tenant] = max(self._cores.get(tenant, 1), cores)

    def _windowed(self, samples: list[tuple[float, int]],
                  now: float) -> list[int]:
        """The samples inside the window; the freshest alone when all
        aged out (a tenant that was observed keeps its last demand)."""
        if not samples:
            return []
        if self.window_s <= 0:
            return [v for _, v in samples]
        cutoff = now - self.window_s
        live = [v for ts, v in samples if ts >= cutoff]
        return live if live else [samples[-1][1]]

    def record(self, tenant: str, hbm_bytes: int, cores: int = 1) -> None:
        """A measured usage sample (the kubelet plugin's health poll,
        ``ChipHealthMonitor.sample_telemetry``); the same window as
        :meth:`observe`, whose name marks declared demand."""
        self.observe(tenant, hbm_bytes, cores=cores)

    def demand(self, tenant: str, percentile: float = 0.95,
               now: float | None = None) -> PartitionDemand | None:
        """The tenant's demand percentile over the window, or None for a
        key never observed (and without a default)."""
        ts = time.time() if now is None else float(now)
        with self._lock:
            windowed = self._windowed(self._hbm.get(tenant, []), ts)
            if not windowed:
                return None
            ordered = sorted(windowed)
            # count stays 1: pack_tenants reads it as the tenant's
            # multiplicity, not the sample size.
            return PartitionDemand(
                hbm_bytes=ordered[_percentile_index(len(ordered),
                                                    percentile)],
                cores=self._cores.get(tenant, 1), tenant=tenant)

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._hbm)

    def fresh_tenants(self, now: float | None = None) -> list[str]:
        """Tenant keys with a sample strictly inside the window (no
        last-sample fallback): the planner's retention signal."""
        ts = time.time() if now is None else float(now)
        with self._lock:
            if self.window_s <= 0:
                return sorted(k for k, s in self._hbm.items() if s)
            cutoff = ts - self.window_s
            return sorted(key for key, samples in self._hbm.items()
                          if samples and samples[-1][0] >= cutoff)

    # -- the static profile file ----------------------------------------------

    def load_file(self, path: str) -> int:
        """Merge ``{"tenants": {key: {"hbmBytes": N, "cores": M}}}``;
        the count of entries."""
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise PartitionSpecError(
                f"unreadable tenant profile file {path!r}: {e}") from e
        tenants = doc.get("tenants") or {}
        for key, entry in tenants.items():
            self.observe(key, int(entry.get("hbmBytes", 0)),
                         cores=int(entry.get("cores", 1)))
        return len(tenants)

    def to_dict(self) -> dict:
        with self._lock:
            return {"tenants": {
                key: {"hbmBytes": max(v for _, v in samples),
                      "cores": self._cores.get(key, 1),
                      "samples": len(samples)}
                for key, samples in self._hbm.items() if samples}}

    def percentiles(self, percentiles: tuple[float, ...] = (0.5, 0.95),
                    now: float | None = None) -> dict[str, dict]:
        """``{tenant: {"p50_hbm_bytes", "p95_hbm_bytes", "cores",
        "samples"}}`` over the window (``/debug/fleet``'s
        ``tenant_demand``: what the planner sees)."""
        ts = time.time() if now is None else float(now)
        out: dict[str, dict] = {}
        with self._lock:
            for key, samples in self._hbm.items():
                windowed = sorted(self._windowed(samples, ts))
                if not windowed:
                    continue
                entry: dict = {"samples": len(windowed),
                               "cores": self._cores.get(key, 1)}
                for pct in percentiles:
                    entry[f"p{int(pct * 100)}_hbm_bytes"] = windowed[
                        _percentile_index(len(windowed), pct)]
                out[key] = entry
        return out


@dataclass(frozen=True)
class SizedChoice:
    """One sizing decision: the profile and the budget it grants (a
    tenant's memory bytes and its per-core time share in thousandths)."""

    profile: PartitionProfile
    per_tenant_hbm: int
    per_tenant_core_milli: int


class SizingPolicy:
    """MISO's choose step: the smallest catalog profile whose per-tenant
    budget covers the demand percentile, ordered by memory budget, then
    by core share (so 1.8 GiB on a 16 GiB card picks eight 2 GiB slots,
    not four 4 GiB ones)."""

    def __init__(self, percentile: float = 0.95):
        self.percentile = percentile

    def pick(self, demand: PartitionDemand, catalog: list
             ) -> SizedChoice | None:
        """``catalog``: (profile, info) pairs, ``info`` with
        ``tenant_hbm_bytes``, ``tenant_core_milli`` and ``cores`` (the
        node's ``PartitionInfo`` from ``engine.catalog_for``, or the
        planner's ``CatalogEntry``). None when nothing covers the demand
        (the tenant needs a whole card).

        Cores are a physical span: a tenant demanding N needs a backing
        instance of at least N (SMs on a GPU), whatever the time share."""
        best: SizedChoice | None = None
        for profile, info in catalog:
            per_hbm = info.tenant_hbm_bytes
            per_core_milli = info.tenant_core_milli
            if per_hbm < demand.hbm_bytes:
                continue
            if info.cores < max(demand.cores, 1):
                continue
            if per_core_milli < 1:
                continue
            choice = SizedChoice(profile, per_hbm, per_core_milli)
            if best is None or (choice.per_tenant_hbm,
                                choice.per_tenant_core_milli) < (
                    best.per_tenant_hbm, best.per_tenant_core_milli):
                best = choice
        return best
