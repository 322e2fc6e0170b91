"""The model zoo: the port's copy of boda_tpu/models/zoo.py."""
