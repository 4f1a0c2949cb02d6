"""Models of the port: the Llama serving subset and train forward, the
train step, the host page ledger, the block-paged serving engine and the
JAX bridge."""
