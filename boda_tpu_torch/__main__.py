"""python -m boda_tpu_torch <mode> [--key=value ...]: the port's CLI
(cli.py); `python -m boda_tpu_torch help` lists its modes."""

from .cli import main

raise SystemExit(main())
