"""Process-level plumbing of the port: the engines' compile cache
(``aot``), the scheduler's rank contract (``distributed``), the process
mesh and its collectives (``mesh``), sequence-parallel attention
(``ring_attention``, ``ulysses``), mixture-of-experts routing local and
over ep (``moe``), and the pipeline schedule (``pipeline``)."""
