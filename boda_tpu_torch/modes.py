"""Registers the port's modes and backends: importing this module adds
engine=torch, be=torch (and the JAX package's be=interp, the numpy
reference backend the per-op modes accept beside it), and the per-op modes
torch_rtc_test, torch_ops_prof, torch_cnn_op_info and torch_cnn_prof.

The per-op modes carry a torch_ prefix because mode registration is
process-global: a port class registered as `ops_prof` would replace the
JAX package's `ops_prof` for everything later in the process.
"""

from boda_tpu.backend import interp  # noqa: F401  (be=interp)

from .backend import modes as _backend_modes  # noqa: F401  (torch_rtc_test)
from .engine import torch_fwd  # noqa: F401  (engine=torch)
from .tune import opinfo, prof  # noqa: F401  (torch_ops_prof, torch_cnn_*)
