"""Tensor ops of the port: quant, norms, rotary, attention, sampling,
the loss heads, and the paged flash-decode and flash-attention kernel
wrappers."""
