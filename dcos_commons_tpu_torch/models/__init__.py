"""Models of the port: the Llama serving subset and train forward, the
train step, the host page ledger, the slot and block-paged serving
engines, the HTTP front door and the JAX bridge."""
