"""boda_tpu_torch: the port of boda_tpu from JAX on a TPU to PyTorch and
CUDA on an NVIDIA H100 (Hopper, sm_90a).

It reuses boda_tpu's platform-free layers as they are (the IR, importer,
zoo, lowering, CLI modes and comparison tools) and adds a torch executor
(`engine=torch`, engine/torch_fwd.py) whose templates subclass the JAX
ones. The TPU's Pallas kernels on that path are hand-written CUDA C++
(csrc/), built with nvcc at first use. This package never imports jax.
"""
