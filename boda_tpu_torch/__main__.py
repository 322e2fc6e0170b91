"""python -m boda_tpu_torch <mode> [--key=value ...]: the boda_tpu CLI with
the port registered: engine=torch (select it with --conv_fwd='(engine=torch)'),
be=torch, and the per-op modes torch_rtc_test, torch_ops_prof,
torch_cnn_op_info and torch_cnn_prof."""

from boda_tpu.cli import main

from . import modes  # noqa: F401  (registers the port)

raise SystemExit(main())
