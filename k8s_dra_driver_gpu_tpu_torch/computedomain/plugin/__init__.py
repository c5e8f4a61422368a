"""The ComputeDomain kubelet plugin (the JAX package's
``computedomain/plugin/``): the claims (``device_state``) and the node
service with its gang-deadline retries (``driver``). Its entry point
waits for the gRPC transport (ROADMAP.md §1b item 8)."""
