"""python -m boda_tpu_torch <mode> [--key=value ...]: the boda_tpu CLI
with the torch engine registered (select it with --conv_fwd='(engine=torch)')."""

from boda_tpu.cli import main

from .engine import torch_fwd  # noqa: F401  (registers engine=torch)

raise SystemExit(main())
