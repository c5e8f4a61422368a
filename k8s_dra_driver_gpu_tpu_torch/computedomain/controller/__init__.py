"""The ComputeDomain controller (the JAX package's
``computedomain/controller/``): the reconciler (``controller``) and the
objects it makes for a domain (``objects``). Its entry point, with
leader election and the metrics server, is not ported (ROADMAP.md §1b,
left out of item 9)."""
