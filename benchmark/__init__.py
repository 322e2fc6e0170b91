"""The benchmark of boda_tpu_torch, the PyTorch and CUDA port: one cell of
BENCHMARK.json per run (`python3 -m benchmark.run`); see README.md."""
