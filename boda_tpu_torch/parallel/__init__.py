"""Host transports (the port's copy of the framed stream of
boda_tpu/parallel/transport.py)."""
