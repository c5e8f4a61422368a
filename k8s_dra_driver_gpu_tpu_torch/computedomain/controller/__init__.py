"""The ComputeDomain controller (the JAX package's
``computedomain/controller/``): the reconciler (``controller``), the
objects it makes for a domain (``objects``) and the binary (``main``:
leader election, the retrying kube client and the metrics server)."""
