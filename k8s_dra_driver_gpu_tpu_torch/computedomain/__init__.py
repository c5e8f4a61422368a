"""The ComputeDomain stack (the JAX package's ``computedomain/``; the
upstream driver's ``cmd/compute-domain-*``). Only the daemon's process
supervisor is ported so far (``daemon.process``), which the kubelet
plugin's tenancy agents run under; the controller, the daemon and the
plugin are ROADMAP.md §1b item 9."""
