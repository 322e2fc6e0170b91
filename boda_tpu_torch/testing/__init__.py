"""Numerical comparison and digest streams: the port's copy of
boda_tpu/testing/comp.py."""
