"""Models of the port: the Llama serving subset, the host page ledger, the
block-paged serving engine and the JAX parameter bridge."""
