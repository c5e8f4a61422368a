"""The per-node ComputeDomain daemon (the JAX package's
``computedomain/daemon/``): its entry (``main``), the clique registrars
(``clique``), the rendezvous service it supervises (``rendezvous``), the
hosts-file rewrite (``dnsnames``) and the process supervisor
(``process``), which the kubelet plugin's tenancy agents run under too."""
