"""Tensor ops of the port: quant, norms, rotary, attention, sampling and
the paged flash-decode kernel wrapper."""
