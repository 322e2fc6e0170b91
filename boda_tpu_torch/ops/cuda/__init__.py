"""Hand-written CUDA kernels (csrc/), their wrappers and plain twins, and the templates built on them."""
