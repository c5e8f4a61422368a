"""The ComputeDomain resource's status values (the JAX package's
``api/computedomain.py``; upstream ``computedomain.go:38-143``).

A ComputeDomain's status aggregates its daemons' registrations; a
ComputeDomainClique, named ``<domain uid>.<clique id>``, holds the
registrations of one clique's daemons. Both live in the JAX package's
group (``computedomain.API_GROUP``), so either stack reads the other's.
The controller, the daemons and the plugin work on the resources as
dicts, so only the status values are kept here.
"""

from __future__ import annotations


class ComputeDomainStatusValue:
    READY = "Ready"
    NOT_READY = "NotReady"
