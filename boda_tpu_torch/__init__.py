"""boda_tpu_torch: the port of boda_tpu from JAX on a TPU to PyTorch and
CUDA on an NVIDIA H100 (Hopper, sm_90a).

The package stands alone: it imports torch, never jax, and nothing of
boda_tpu. The platform-free layers it needs (named dims, lexp, config and
modes, the graph IR and caffe importer, the model zoo, the op variants
and lowering, the backend contract, wisdom and the comparison tools) are
its own copies, each at the JAX package's relative path, with what the
port's paths never reach left out (each module's docstring says what).
Its executor is `engine=torch` (engine/torch_fwd.py); the templates'
kernels (ops/cuda) are hand-written CUDA C++ (csrc/), built with nvcc at
first use. `python -m boda_tpu_torch help` lists its modes.
"""
