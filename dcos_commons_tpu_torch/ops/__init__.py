"""Tensor ops of the port: quant, norms, rotary, attention, sampling,
the loss heads, and the flash-decode (slot cache and paged pool) and
flash-attention kernel wrappers."""
