"""The validating admission webhook (the JAX package's ``webhook/``;
upstream cmd/webhook/): ``main`` serves the AdmissionReview endpoint,
``certbootstrap`` makes its TLS secret and trusts it in the
ValidatingWebhookConfiguration. Standard library and the ``openssl``
binary only."""
