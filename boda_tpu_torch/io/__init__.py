"""Data-stream blocks and image helpers (the port's copies of parts of
boda_tpu/io/)."""
