"""The scheduler half the port needs: the serving back-pressure signal
the fleet router reads (``elastic.backpressure``)."""
