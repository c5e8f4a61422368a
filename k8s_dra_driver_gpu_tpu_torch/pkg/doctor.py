"""Incident bundles: every binary's ``/metrics`` and ``/debug/*`` in one
``.tar.gz`` (the JAX package's ``pkg/doctor.py``).

The doctor crawls each binary's introspection surface -- ``/metrics``,
``/debug/traces``, ``/debug/claims`` (with each claim's timeline),
``/debug/stacks``, ``/debug/telemetry``, ``/debug/fleet`` -- into one
timestamped bundle, with a report that merges every binary's flight
timeline into one ordered story a claim.

CLI::

    python -m k8s_dra_driver_gpu_tpu_torch.pkg.doctor \\
        scheduler=http://127.0.0.1:9090 \\
        plugin=http://127.0.0.1:9091 \\
        --out-dir /tmp --claim default/my-claim

Automatic bundles: the gang abort (``computedomain/plugin/driver.py``)
and the eviction deadline (``pkg/recovery.py``) call :func:`auto_bundle`.
With ``TPU_DRA_DOCTOR_DIR`` set, the binary writes its own in-process
surfaces (no HTTP: the rings live in this process) and those of the
peers in ``TPU_DRA_DOCTOR_ENDPOINTS`` (``name=url,name=url``). One
bundle every ``TPU_DRA_DOCTOR_MIN_INTERVAL_S`` (300 s) at most, so a
storm of failures cannot fill the disk; a doctor failure never fails the
operation that called it.

A bundle is written under a hidden temporary name in its directory and
renamed into place, so a ``*.tar.gz`` that exists is whole. Standard
library only.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import os
import tarfile
import threading
import time
import urllib.request

logger = logging.getLogger(__name__)

ENV_DOCTOR_DIR = "TPU_DRA_DOCTOR_DIR"
ENV_DOCTOR_ENDPOINTS = "TPU_DRA_DOCTOR_ENDPOINTS"
ENV_DOCTOR_MIN_INTERVAL = "TPU_DRA_DOCTOR_MIN_INTERVAL_S"

#: The surface crawled a target, in crawl order.
SURFACE_PATHS = (
    "metrics",
    "debug/traces",
    "debug/claims",
    "debug/stacks",
    "debug/telemetry",
    "debug/fleet",
)

#: Per-claim timelines fetched for at most this many claim keys (a large
#: ring makes a larger bundle, not a crawl that hangs).
MAX_CLAIM_FETCH = 200

_FETCH_TIMEOUT_S = 3.0


def _fetch(url: str) -> tuple[bytes, str]:
    """GET one URL; returns (body, error), exactly one non-empty."""
    try:
        with urllib.request.urlopen(url, timeout=_FETCH_TIMEOUT_S) as r:
            return r.read(), ""
    except Exception as e:  # noqa: BLE001 - the crawl must finish
        return b"", f"{type(e).__name__}: {e}"


def _member(tar: tarfile.TarFile, name: str, body: bytes,
            mtime: float) -> None:
    info = tarfile.TarInfo(name=name)
    info.size = len(body)
    info.mtime = int(mtime)
    tar.addfile(info, io.BytesIO(body))


def _suffix(path: str) -> str:
    return ".txt" if path in ("metrics", "debug/stacks") else ".json"


def crawl_target(name: str, base_url: str) -> dict:
    """Crawl one binary's surface; returns
    ``{path: {"body": bytes} | {"error": str}}``."""
    base = base_url.rstrip("/")
    out: dict[str, dict] = {}
    for path in SURFACE_PATHS:
        body, err = _fetch(f"{base}/{path}")
        out[path] = {"error": err} if err else {"body": body}
    claims_doc = out.get("debug/claims", {})
    keys: list[str] = []
    if "body" in claims_doc:
        try:
            keys = list(json.loads(claims_doc["body"]).get(
                "claims", []))[:MAX_CLAIM_FETCH]
        except (ValueError, AttributeError):
            keys = []
    for key in keys:
        body, err = _fetch(f"{base}/debug/claims/{key}")
        out[f"debug/claims/{key}"] = (
            {"error": err} if err else {"body": body})
    return out


def _correlate(crawls: dict[str, dict]) -> dict:
    """Merge every target's per-claim timelines into one ordered story a
    claim, each event tagged with its source; count spans a trace and
    sum the anomaly counters."""
    claims: dict[str, list[dict]] = {}
    traces: dict[str, int] = {}
    anomalies: dict[str, float] = {}
    for target, surface in crawls.items():
        for path, doc in surface.items():
            if "body" not in doc:
                continue
            if path.startswith("debug/claims/"):
                try:
                    payload = json.loads(doc["body"])
                except ValueError:
                    continue
                key = payload.get("key", path.rsplit("/", 1)[-1])
                for ev in payload.get("events", []):
                    claims.setdefault(key, []).append(
                        {**ev, "source": target})
            elif path == "debug/traces":
                try:
                    payload = json.loads(doc["body"])
                except ValueError:
                    continue
                for tid, spans in (payload.get("traces") or {}).items():
                    traces[tid] = traces.get(tid, 0) + len(spans)
            elif path == "metrics":
                for line in doc["body"].decode(
                        "utf-8", "replace").splitlines():
                    if line.startswith("tpu_dra_anomaly_total{"):
                        try:
                            label, val = line.rsplit(" ", 1)
                            anomalies[label] = (anomalies.get(label, 0)
                                                + float(val))
                        except ValueError:
                            pass
    for events in claims.values():
        events.sort(key=lambda ev: ev.get("ts", 0.0))
    return {
        "claims": claims,
        "trace_span_counts": traces,
        "anomaly_counters": anomalies,
    }


def bundle_path(out_dir: str, trigger: str,
                now: float | None = None) -> str:
    stamp = time.strftime("%Y%m%d-%H%M%S",
                          time.gmtime(now if now is not None
                                      else time.time()))
    return os.path.join(
        out_dir, f"tpu-dra-doctor-{stamp}-{trigger}.tar.gz")


def collect_bundle(targets: dict[str, str], out_dir: str = ".",
                   claim: str = "", trigger: str = "manual",
                   extra_members: dict[str, bytes] | None = None,
                   out_path: str | None = None) -> str:
    """Crawl ``targets`` (name -> base URL) and write the bundle; returns
    its path. ``claim`` focuses the report on one claim key (everything
    is still collected); ``extra_members`` adds in-process dumps;
    ``out_path`` pins the destination."""
    now = time.time()
    if out_path is None:
        out_path = bundle_path(out_dir, trigger, now)
    crawls = {name: crawl_target(name, url)
              for name, url in targets.items()}
    report = _correlate(crawls)
    if claim:
        report["focus_claim"] = claim
        report["focus_events"] = {k: v for k, v in report["claims"].items()
                                  if claim in k}
    manifest = {
        "created": now,
        "trigger": trigger,
        "targets": dict(targets),
        "surface_paths": list(SURFACE_PATHS),
        "errors": {
            f"{t}/{p}": doc["error"]
            for t, surface in crawls.items()
            for p, doc in surface.items() if doc.get("error")
        },
    }
    os.makedirs(out_dir, exist_ok=True)
    head, base = os.path.split(out_path)
    part = os.path.join(head, f".{base}.{os.getpid()}.part")
    try:
        with tarfile.open(part, "w:gz") as tar:
            for target, surface in crawls.items():
                for path, doc in surface.items():
                    if "body" not in doc:
                        continue
                    suffix = (".json" if path.startswith("debug/claims/")
                              else _suffix(path))
                    _member(tar, f"{target}/{path}{suffix}", doc["body"],
                            now)
            for name, body in (extra_members or {}).items():
                _member(tar, name, body, now)
            _member(tar, "report.json",
                    json.dumps(report, sort_keys=True, indent=1).encode(),
                    now)
            _member(tar, "manifest.json",
                    json.dumps(manifest, sort_keys=True,
                               indent=1).encode(), now)
        os.replace(part, out_path)
    finally:
        if os.path.exists(part):
            os.unlink(part)
    logger.warning("doctor bundle written: %s (%d target(s), %d "
                   "fetch error(s))", out_path, len(targets),
                   len(manifest["errors"]))
    return out_path


# -- automatic incident bundles -----------------------------------------------

_auto_lock = threading.Lock()
_auto_last = 0.0


def _local_surface() -> dict[str, bytes]:
    """This process's own surfaces, dumped without HTTP (the calling
    binary is one of the targets, and its listener may be off)."""
    from . import fleetstate, flightrecorder, tracing  # noqa: PLC0415
    from .debug import debug_stacks_endpoint  # noqa: PLC0415

    dumps = {
        "local/debug/traces.json": lambda: json.dumps(
            {"traces": tracing.exporter().traces()},
            sort_keys=True).encode(),
        "local/debug/claims.json": lambda: json.dumps(
            {"events": flightrecorder.default().events()},
            sort_keys=True).encode(),
        "local/debug/stacks.txt": lambda: debug_stacks_endpoint()[2],
        "local/debug/telemetry.json": lambda: json.dumps(
            fleetstate.default_ring().snapshot(), sort_keys=True).encode(),
        "local/debug/fleet.json": lambda: json.dumps(
            fleetstate.default_fleet().snapshot(), sort_keys=True).encode(),
    }
    out: dict[str, bytes] = {}
    for name, dump in dumps.items():
        try:
            out[name] = dump()
        except Exception:  # noqa: BLE001 - every dump is best-effort
            logger.debug("doctor: %s not dumped", name, exc_info=True)
    return out


def _parse_endpoints(raw: str) -> dict[str, str]:
    out = {}
    for item in filter(None, (t.strip() for t in raw.split(","))):
        name, _, url = item.partition("=")
        if name and url:
            out[name.strip()] = url.strip()
    return out


def auto_bundle(trigger: str, claim: str = "",
                env=os.environ) -> str | None:
    """Drop an incident bundle for a failure path (gang abort, eviction
    deadline); returns the bundle's eventual path. Nothing without
    ``TPU_DRA_DOCTOR_DIR``; rate-limited; never raises or blocks: the
    local rings are snapshotted at once (their evidence ages out), and
    the peers' crawl and the write run on a daemon thread
    ``doctor-bundle``, since in the incident the peers are the slow
    part."""
    global _auto_last
    out_dir = env.get(ENV_DOCTOR_DIR, "")
    if not out_dir:
        return None
    try:
        min_interval = float(env.get(ENV_DOCTOR_MIN_INTERVAL, "300"))
    except ValueError:
        min_interval = 300.0
    with _auto_lock:
        now = time.monotonic()
        if _auto_last and now - _auto_last < min_interval:
            return None
        _auto_last = now
    try:
        os.makedirs(out_dir, exist_ok=True)  # fail here, not on the thread
        targets = _parse_endpoints(env.get(ENV_DOCTOR_ENDPOINTS, ""))
        extra = _local_surface()
        out_path = bundle_path(out_dir, trigger)

        def write() -> None:
            try:
                collect_bundle(targets, out_dir=out_dir, claim=claim,
                               trigger=trigger, extra_members=extra,
                               out_path=out_path)
            except Exception:  # noqa: BLE001 - diagnostics
                logger.exception("auto doctor bundle failed "
                                 "(trigger=%s)", trigger)

        threading.Thread(target=write, name="doctor-bundle",
                         daemon=True).start()
        return out_path
    except Exception:  # noqa: BLE001 - diagnostics must never hurt
        logger.exception("auto doctor bundle failed (trigger=%s)",
                         trigger)
        return None


def reset_rate_limit() -> None:
    """Allow the next :func:`auto_bundle` at once (tests)."""
    global _auto_last
    with _auto_lock:
        _auto_last = 0.0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m k8s_dra_driver_gpu_tpu_torch.pkg.doctor",
        description="Collect a tpu-dra diagnostics bundle from the "
                    "binaries' metrics/debug endpoints.")
    p.add_argument("targets", nargs="+",
                   help="name=base-url pairs, e.g. "
                        "scheduler=http://127.0.0.1:9090")
    p.add_argument("--out-dir", default=".",
                   help="directory for the bundle (default: .)")
    p.add_argument("--claim", default="",
                   help="claim key (uid or ns/name) to focus the "
                        "correlated report on")
    args = p.parse_args(argv)
    targets = _parse_endpoints(",".join(args.targets))
    if not targets:
        p.error("no valid name=url targets")
    print(collect_bundle(targets, out_dir=args.out_dir, claim=args.claim))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
