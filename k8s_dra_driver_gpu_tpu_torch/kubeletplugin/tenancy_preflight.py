"""The tenancy preflight hook's command line in Python (the JAX package's
``kubeletplugin/tenancy_preflight.py``). The plugin's CDI specs run the
native hook, ``csrc/tenancy_preflight.cc``, built from the checkout
(``native_hook.py``): a container runtime runs a hook on the host, which
may have no Python. This module is the native hook's reference in the
tests, and a hook that runs where no compiler is.

As a ``createContainer`` hook it registers the container (the ``id`` of
the OCI state on stdin) with the request's tenancy agent; as a
``poststop`` hook (``--release``) it releases it.

Exit 0: admitted, or released. Exit 1: denied, an id that is missing or
holds a path (``/``, ``.``, ``..``), or an agent that cannot be reached:
admission fails closed. A release never fails: when the agent cannot be
reached it leaves a tombstone in ``released.d/`` for the agent to apply,
only while the agent's directory exists (a poststop racing the claim's
unprepare must not make the removed directory again).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .tenancy_agent import RELEASED_DIR, query


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="tenancy-preflight")
    p.add_argument("--dir", required=True, dest="tenancy_dir",
                   help="host path of the request's agent directory")
    p.add_argument("--hbm-bytes", type=int, default=0,
                   help="this tenant's memory budget in bytes")
    p.add_argument("--client-id", default="",
                   help="the client's identity (default: the OCI state's id)")
    p.add_argument("--release", action="store_true",
                   help="poststop: free this tenant's admission slot")
    args = p.parse_args(argv)

    client = args.client_id
    if not client:
        try:
            client = json.load(sys.stdin).get("id", "")
        except (ValueError, OSError):
            client = ""
    if not client:
        print("tenancy-preflight: no client identity", file=sys.stderr)
        return 0 if args.release else 1
    if "/" in client or client in (".", ".."):
        print("tenancy-preflight: invalid client id", file=sys.stderr)
        return 0 if args.release else 1

    request = (f"RELEASE {client}" if args.release
               else f"REGISTER {client} {args.hbm_bytes}")
    try:
        answer = query(args.tenancy_dir, request)
    except OSError as e:
        print(f"tenancy-preflight: agent unreachable: {e}", file=sys.stderr)
        if not args.release:
            return 1
        if os.path.isdir(args.tenancy_dir):
            try:
                rd = os.path.join(args.tenancy_dir, RELEASED_DIR)
                os.makedirs(rd, exist_ok=True)
                with open(os.path.join(rd, client), "w"):
                    pass
            except OSError:
                pass
        return 0
    if args.release or answer.startswith("OK"):
        return 0
    print(f"tenancy-preflight: {answer}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
