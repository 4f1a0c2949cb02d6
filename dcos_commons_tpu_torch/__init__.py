"""PyTorch/CUDA port of the ``dcos_commons_tpu`` compute layer.

The JAX package stays the reference; this package grows beside it, one
slice at a time, and imports nothing of it (not even its jax-free
modules: what it needs, it copies). It imports ``torch``, ``numpy`` and
the standard library only.

Slice 1 is the block-paged serving path of the Llama decoder:

* ``ops``      quant, norms, rotary, attention, sampling, and the
               paged flash-decode wrapper around a hand-written CUDA
               kernel (``csrc/flash_decode_paged.cu``);
* ``kernels``  the nvcc build + ctypes loader for ``csrc/``;
* ``models``   the Llama serving subset, the host page ledger, the
               ``PagedServer`` engine and the JAX parameter bridge.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise
when CUDA is absent unless the caller passed ``device="cpu"``.
"""
