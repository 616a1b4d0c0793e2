"""The benchmark's own code: traffic, weights, the closed loop, the judge,
the trace reading and the yardstick (peaks and the frozen kernel-work
counts), with what every architecture shares. What belongs to one
architecture lies in ``bench/archs/<arch>/`` (``arch.py``), what belongs to
one counted kernel in ``bench/counted/<op>.py``. It imports nothing of the
JAX package; of the port it imports only the system under test."""
