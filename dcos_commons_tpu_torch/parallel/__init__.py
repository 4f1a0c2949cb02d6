"""Process-level plumbing of the port: the engines' compile cache
(``aot``) and the scheduler's rank contract (``distributed``)."""
