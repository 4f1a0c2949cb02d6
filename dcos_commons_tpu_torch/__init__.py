"""PyTorch/CUDA port of the ``dcos_commons_tpu`` compute layer.

The JAX package stays the reference; this package grows beside it, one
slice at a time, and imports nothing of it (not even its jax-free
modules: what it needs, it copies). It imports ``torch``, ``numpy`` and
the standard library only.

Slice 1 is the block-paged serving path of the Llama decoder, slice 2
its train step:

* ``ops``      quant, norms, rotary, attention, sampling, the loss
               heads, and the wrappers around hand-written CUDA
               kernels: paged flash-decode (``csrc/flash_decode_paged.cu``)
               and flash attention, forward and backward
               (``csrc/flash_attention_fwd.cu``,
               ``csrc/flash_attention_bwd.cu``);
* ``kernels``  the nvcc build + ctypes loader for ``csrc/``;
* ``models``   the Llama serving subset and train forward, the train
               step (AdamW, gradient accumulation), the host page
               ledger, the ``PagedServer`` engine and the JAX bridge
               (parameters, pools, optimizer state).

Entry points take an explicit ``device`` (default ``"cuda"``) and raise
when CUDA is absent unless the caller passed ``device="cpu"``.
"""
