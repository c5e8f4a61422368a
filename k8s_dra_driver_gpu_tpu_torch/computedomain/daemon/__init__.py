"""The per-node ComputeDomain daemon (the JAX package's
``computedomain/daemon/``): so far its process supervisor
(``process``)."""
