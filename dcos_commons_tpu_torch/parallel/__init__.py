"""Process-level plumbing of the port: the engines' compile cache
(``aot``), the scheduler's rank contract (``distributed``), the process
mesh and its collectives (``mesh``), and sequence-parallel attention
(``ring_attention``, ``ulysses``)."""
