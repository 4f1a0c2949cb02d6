"""PyTorch/CUDA port of the ``dcos_commons_tpu`` compute layer.

The JAX package stays the reference; this package grows beside it, one
slice at a time, and imports nothing of it (not even its jax-free
modules: what it needs, it copies). It imports ``torch``, ``numpy`` and
the standard library only.

Slice 1 is the block-paged serving path of the Llama decoder, slice 2
its train step, slice 3 slot serving behind the HTTP front door, slice 7
the worker that serves it and the decode windows as CUDA graphs:

* ``ops``      quant, norms, rotary, attention, sampling, the loss
               heads, and the wrappers around hand-written CUDA
               kernels: flash-decode over the slot cache and the paged
               pool (``csrc/flash_decode_slots.cu``,
               ``csrc/flash_decode_paged.cu``) and flash attention,
               forward and backward (``csrc/flash_attention_fwd.cu``,
               ``csrc/flash_attention_bwd.cu``);
* ``kernels``  the nvcc build + ctypes loader for ``csrc/``;
* ``models``   the Llama serving subset and train forward, the train
               step (AdamW, gradient accumulation), the host page
               ledger, the ``SlotServer`` and ``PagedServer`` engines,
               the HTTP front door ``ServingFrontend`` and the JAX
               bridge (parameters, caches, pools, optimizer state);
* ``parallel`` the engines' compile cache keys (``aot``), the
               scheduler's rank contract and the process group
               (``distributed``), the tensor-parallel process mesh
               (``mesh``) and the sharded checkpoints;
* ``frameworks.worker``  the task-side worker (``python -m
               dcos_commons_tpu_torch.frameworks.worker llama ...``);
* ``metrics``, ``tracing``, ``utils.stats``  the front door's registry,
               trace store and percentiles, copied from the JAX
               package's jax-free modules.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise
when CUDA is absent unless the caller passed ``device="cpu"``.
"""
