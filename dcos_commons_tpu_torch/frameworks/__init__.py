"""Task-side entry points of the port (``python -m
dcos_commons_tpu_torch.frameworks.worker``), the counterparts of
``frameworks/jax``."""
